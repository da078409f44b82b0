// Hand-written Hopper (sm_90a) kernel for the phi-step of the sGS methods:
// one symmetric red-black sweep (colours B, A, B) of the scaled space-time
// Neumann Laplacian
//
//   (d2 A^T A) phi = rhs,   phi(cell) <- (rhs + d2 sum_a w_a (phi[-1] +
//   phi[+1])) * inv_diag    on the cells of one colour,
//
// with w_a = (n_a - 1)^2 per array axis (t first) and the missing
// neighbour at each edge counted as zero, in ONE launch.
//
// It replaces both Pallas sweeps of dotsocp_tpu/ops/pallas_kernels.py,
// make_sgs_sweep_pallas (whole field in VMEM, the three colours looped in
// VMEM) and make_sgs_sweep_pallas_tiled (row tiles with a 3-row halo, the
// dependence depth of the three half-sweeps): the split between them is
// the TPU's VMEM budget, which has no counterpart here. It follows the
// operation order of the plain version (dotsocp_tpu_torch/ops/sgs.py,
// after dotsocp_tpu/ops/sgs.py), so the two agree to a few ulp; FMA
// contraction is left on.
//
// Bound: HBM bytes. The least one sweep moves is phi read, rhs read and
// out written once each: 3 x 4 x nt x S bytes (205 MB at 513^2 x 65, 0.061
// ms at 3.35 TB/s; 850 MB at 129^3 x 33, 0.254 ms). The earlier design ran
// three half-sweep launches over HBM, three times that.
//
// Layout (f32, contiguous): phi, rhs and out are the field (nt, *space),
// the last axis fastest; one, two or three space axes (DIM), each with its
// own size. Internally the space axes are (z, y, x); a DIM < 3 field has
// z (and in 1D y) of size 1, untiled and without halo.
//
// Design: each block owns a tile of the space axes (1D: a run of x; 2D: a
// (y, x) tile; 3D: a (z, y, x) tile; sizes in Tile<DIM>) and streams along
// t through a ring of planes in shared memory: in wavefront step j it
// updates colour B on plane j, then colour A on plane j-1, then B again on
// plane j-2, with a __syncthreads() between the stages. One buffer per
// plane, updated in place: a stage writes one colour and reads only the
// other. A tile carries a halo of 3 cells on each tiled axis (the
// dependence depth), and each stage computes a region one cell narrower on
// every side than the last: B over the tile plus 2, A over the tile plus 1,
// B over the tile. Halo cells are recomputed by each of the tiles that
// hold them; their reads come mostly from L2, since neighbouring tiles
// stream in step. A plane leaves the ring once its second B is done and is
// written to out in the next step; the field phi is never written, and no
// block reads what another writes, so out is always a fresh buffer.
//
// Copies: while a step computes, the next plane's phi tile and rhs tile
// are in flight with cp.async (4-byte copies: a tile row starts at any
// cell; copies to shared memory need no registers) into ring slots the
// step does not touch; the step ends with cp.async.wait_all and a
// __syncthreads(). Cells outside the grid, and the planes t = -1 and
// t = nt, are zero in the ring and never updated, which is the rule
// "missing neighbour counts as zero". The ring holds phi planes j-3 .. j+2
// (a stage reads the planes beside its own) and rhs planes j-2 .. j+1, in
// dynamic shared memory: 8 and 4 slots, powers of two that divide 8.
//
// Threads: the bound on the card is shared-memory instructions (every
// update reads seven to nine words), so a thread owns fixed pairs of cells
// (x, x+1) of a box row, one of each colour, for the whole launch: it
// copies the box in row order, and in each stage it updates the one cell
// of each pair that has the stage's colour. Rows are stored even cells
// first, then odd ones, so a warp's cells of one colour are consecutive
// words. Everything about a pair that does not change with t (its cells'
// words, x neighbours, distance from the tile, edges) is computed once;
// the step loop is unrolled by 8, so every ring slot and the parity of
// every plane a step touches are compile-time, and each shared-memory
// access is one register plus an immediate.
//
// Chunks of t: a block streams all nt planes, one after another, so a
// grid with fewer tiles than the card holds blocks at once (129^2 x 33: 24
// tiles) would leave it idle. There t is cut into chunks of at least 4
// planes too (launch), each block recomputing 3 planes on either side of
// its chunk as it does its halo cells, so that more blocks stream fewer
// planes each; the output is the same to the bit.
//
// Tiles (interior cells; timed on an H100 at 513^2 x 65 and 129^3 x 33):
// 2D 18 x 58, 384 threads, at most 80 registers so that two blocks share
// an SM and every block of 513^2 is resident at once; 3D 6 x 6 x 26, 768
// threads, one block an SM (221 KB of shared memory): its halo on three
// axes loads 4.9 times the tile's cells, which bounds it; 1D 250 cells.
//
// Arithmetic per cell as in the three-launch kernel it replaces: the
// neighbour sum t first, then the space axes, each as w * (lo + hi); the
// inverse diagonal (1/diag)/d2 from the per-axis degree (1 at an edge, 2
// inside), computed once per block for each of the 2^(DIM+1) edge
// patterns, in the same order of additions.
//
// Plane offsets into the field are 64-bit, offsets within a plane 32-bit
// (the wrapper refuses a plane of 2^31 cells). The entry point launches on
// the given stream, synchronises nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// tile of the space axes (interior cells), halo per axis, threads a block,
// the pairs of cells each thread owns (K = pairs / threads), and the blocks
// an SM must hold at once (registers are capped to fit them)
template <int DIM>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int Z = 1, Y = 1, X = 250, HZ = 0, HY = 0, HX = 3;
  static constexpr int kThreads = 128, K = 1, kMinBlocks = 1;
};
template <>
struct Tile<2> {
  static constexpr int Z = 1, Y = 18, X = 58, HZ = 0, HY = 3, HX = 3;
  static constexpr int kThreads = 384, K = 2, kMinBlocks = 2;
};
template <>
struct Tile<3> {
  static constexpr int Z = 6, Y = 6, X = 26, HZ = 3, HY = 3, HX = 3;
  static constexpr int kThreads = 768, K = 3, kMinBlocks = 1;
};

// the rings: phi planes j-3 .. j+2 and rhs planes j-2 .. j+1, in slots
// whose counts divide 8, the steps one turn of the loop unrolls
constexpr int kPhiSlots = 8;
constexpr int kRhsSlots = 4;
constexpr int kOut = 99;  // "never": the distance of a cell outside the grid

// The box: the tile and its halo. A plane of it is stored row by row (a
// row runs along x), each row as its even-x cells then its odd-x cells, so
// that the lanes of a warp, each updating one cell of its own pair (x, x+1)
// and all of one colour, read consecutive words.
template <int DIM>
struct Box {
  using T = Tile<DIM>;
  static constexpr int BZ = T::Z + 2 * T::HZ;
  static constexpr int BY = T::Y + 2 * T::HY;
  static constexpr int BX = T::X + 2 * T::HX;
  static constexpr int H = BX / 2;           // pairs a row
  static constexpr int P = BZ * BY * BX;     // floats of one plane's box
  static constexpr int PAIRS = BZ * BY * H;
  // floats of dynamic shared memory: the two rings and the diagonal table
  static constexpr int kSmemFloats = (kPhiSlots + kRhsSlots) * P + 16;
  static_assert(BX % 2 == 0, "a row holds whole pairs");
  static_assert(PAIRS == T::K * T::kThreads, "every pair has one thread");
  static_assert(P < (1 << 16), "a word fits the low 16 bits of cword");
  // the word of cell (row, x = 2m + par) in a plane
  __device__ static int word(int row, int par, int m) {
    return row * BX + par * H + m;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// waits for every copy the thread started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What a thread knows of one of its pairs (cells x = 2m and 2m+1 of a row
// of the box), computed once. Within a group of eight steps the parity of
// every plane a stage updates is known at compile time, so the stage knows
// whether it updates the pair's cell whose x has the parity of its row's
// start ("flip" 0) or the other one (flip 1); for each flip the pair holds
// that cell's word in a plane, the words of its x neighbours, its distance
// from the tile (the largest over the tiled axes, 0 inside; kOut outside
// the grid: the stage that grows the tile by e cells updates it if dist <=
// e) and its space edges (bits 1.. of the diagonal table's index). And for
// each cell b of the pair: its in-plane offset in the field is offset + b,
// and write[b] whether it goes to out.
struct Pair {
  int cell[2], left[2], right[2], dist[2], edges[2];
  int word;
  int offset;
  bool write[2];
};

// distance of box coordinate l from the tile's [h, h + n) on one axis
__device__ __forceinline__ int dist(int l, int h, int n) {
  return l < h ? h - l : (l >= h + n ? l - h - n + 1 : 0);
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// One stage: on the plane in phi slot CUR (neighbours in slots LO and HI,
// rhs in slot RS), each pair's cell of flip F within the tile grown by E
// gets (rhs + d2 nbr) * inv_diag, the neighbour sum t first, then the
// space axes, each as w * (lo + hi). The slots are compile-time, so every
// shared-memory access is one register plus an immediate.
template <int DIM, int LO, int CUR, int HI, int RS, int F, int E>
__device__ __forceinline__ void stage(float* ring, const float* rring,
                                      const float* inv_tab,
                                      const Pair (&pr)[Tile<DIM>::K],
                                      int t_edge, float d2, float wt,
                                      float wz, float wy, float wx) {
  using B = Box<DIM>;
  const float* lo_p = ring + LO * B::P;
  float* cur = ring + CUR * B::P;
  const float* hi_p = ring + HI * B::P;
  const float* rhs_s = rring + RS * B::P;
#pragma unroll
  for (int k = 0; k < Tile<DIM>::K; ++k) {
    if (pr[k].dist[F] > E) continue;
    const int c = pr[k].cell[F];
    float nbr = wt * (lo_p[c] + hi_p[c]);
    if (DIM == 3)
      nbr = nbr + wz * (cur[c - B::BY * B::BX] + cur[c + B::BY * B::BX]);
    if (DIM >= 2) nbr = nbr + wy * (cur[c - B::BX] + cur[c + B::BX]);
    nbr = nbr + wx * (cur[pr[k].left[F]] + cur[pr[k].right[F]]);
    cur[c] = (rhs_s[c] + d2 * nbr) * inv_tab[t_edge | pr[k].edges[F]];
  }
}

template <int DIM>
__global__ void __launch_bounds__(Tile<DIM>::kThreads, Tile<DIM>::kMinBlocks)
    rb_sweep_kernel(const float* __restrict__ phi,
                    const float* __restrict__ rhs, float* __restrict__ out,
                    int nt, int nz, int ny, int nx, float d2, int chunks) {
  using B = Box<DIM>;
  using T = Tile<DIM>;
  extern __shared__ float smem[];
  float* ring = smem;                                      // kPhiSlots x P
  float* rring = smem + kPhiSlots * B::P;                  // kRhsSlots x P
  float* inv_tab = smem + (kPhiSlots + kRhsSlots) * B::P;  // 16

  // this block's tile: balanced cuts of each axis, at most T::* cells;
  // and its chunk of t, [t_lo, t_hi) (blockIdx.z = z tile * chunks + chunk)
  const int tiles_z = gridDim.z / chunks;
  const int bz = blockIdx.z / chunks, chunk = blockIdx.z % chunks;
  const int x_lo = (int)((int64_t)blockIdx.x * nx / gridDim.x);
  const int x_hi = (int)((int64_t)(blockIdx.x + 1) * nx / gridDim.x);
  const int y_lo = (int)((int64_t)blockIdx.y * ny / gridDim.y);
  const int y_hi = (int)((int64_t)(blockIdx.y + 1) * ny / gridDim.y);
  const int z_lo = (int)((int64_t)bz * nz / tiles_z);
  const int z_hi = (int)((int64_t)(bz + 1) * nz / tiles_z);
  const int t_lo = (int)((int64_t)chunk * nt / chunks);
  const int t_hi = (int)((int64_t)(chunk + 1) * nt / chunks);
  const int64_t S = (int64_t)nz * ny * nx;
  // a chunk carries a halo of 3 planes as a tile does of cells: the first
  // stage updates planes [h1_lo, h1_hi), the second [h2_lo, h2_hi), the
  // third [t_lo, t_hi); the loads cover [h1_lo - 1, h1_hi]
  const int h1_lo = t_lo > 2 ? t_lo - 2 : 0, h2_lo = t_lo > 1 ? t_lo - 1 : 0;
  const int h1_hi = t_hi + 2 < nt ? t_hi + 2 : nt;
  const int h2_hi = t_hi + 1 < nt ? t_hi + 1 : nt;

  // weights per axis, and 1/diag for each pattern of edges (bit 0: t,
  // then the space axes in order), summed as the plain version sums
  const float wt = (float)(nt - 1) * (float)(nt - 1);
  const float wz = (float)(nz - 1) * (float)(nz - 1);
  const float wy = (float)(ny - 1) * (float)(ny - 1);
  const float wx = (float)(nx - 1) * (float)(nx - 1);
  for (int b = threadIdx.x; b < (2 << DIM); b += blockDim.x) {
    float diag = wt * ((b & 1) ? 1.f : 2.f);
    int bit = 2;
    if (DIM == 3) {
      diag = diag + wz * ((b & bit) ? 1.f : 2.f);
      bit <<= 1;
    }
    if (DIM >= 2) {
      diag = diag + wy * ((b & bit) ? 1.f : 2.f);
      bit <<= 1;
    }
    diag = diag + wx * ((b & bit) ? 1.f : 2.f);
    inv_tab[b] = (1.f / diag) / d2;
  }

  // the cells the thread copies in: box cells threadIdx.x + i * blockDim.x
  // in row order (a warp copies consecutive cells): the cell's word in a
  // plane, bit 16 set where it lies in the grid, bit 17 where a stage reads
  // its rhs (the tile + 2); and its in-plane offset in the field
  int cword[2 * T::K], coff[2 * T::K];
#pragma unroll
  for (int i = 0; i < 2 * T::K; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    const int row = c / B::BX, lx = c % B::BX;
    const int lz = row / B::BY, ly = row % B::BY;
    const int gz = z_lo - T::HZ + lz, gy = y_lo - T::HY + ly;
    const int gx = x_lo - T::HX + lx;
    const int d = dist(lz, T::HZ, T::Z) > dist(ly, T::HY, T::Y)
                      ? dist(lz, T::HZ, T::Z) : dist(ly, T::HY, T::Y);
    const int dd = d > dist(lx, T::HX, T::X) ? d : dist(lx, T::HX, T::X);
    const bool in = gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 &&
                    gx < nx;
    cword[i] = B::word(row, lx & 1, lx >> 1) | (in ? 1 << 16 : 0) |
               (in && dd <= 2 ? 1 << 17 : 0);
    coff[i] = (gz * ny + gy) * nx + gx;
  }

  // the thread's pairs: pair q = threadIdx.x + k * blockDim.x
  Pair pr[T::K];
#pragma unroll
  for (int k = 0; k < T::K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int row = q / B::H, m = q % B::H;
    const int lz = row / B::BY, ly = row % B::BY;
    const int gz = z_lo - T::HZ + lz, gy = y_lo - T::HY + ly;
    const int gx0 = x_lo - T::HX + 2 * m;
    // distance of the row from the tile, over z and y
    const int dz = dist(lz, T::HZ, T::Z), dy = dist(ly, T::HY, T::Y);
    const bool row_in = gz >= 0 && gz < nz && gy >= 0 && gy < ny;
    const int row_edges = (DIM == 3 && (gz == 0 || gz == nz - 1) ? 2 : 0) |
                          (DIM >= 2 && (gy == 0 || gy == ny - 1) ? (DIM == 3 ? 4 : 2) : 0);
    const bool row_out = gz >= z_lo && gz < z_hi && gy >= y_lo && gy < y_hi;
    const int parity = (gz + gy + gx0) & 1;
    pr[k].word = B::word(row, 0, m);
    pr[k].offset = (gz * ny + gy) * nx + gx0;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int b = f ^ parity;  // the cell of the pair this flip updates
      const int lx = 2 * m + b, gx = gx0 + b;
      const int dx = dist(lx, T::HX, T::X);
      const bool in = row_in && gx >= 0 && gx < nx;
      pr[k].cell[f] = B::word(row, b, m);
      // x - 1 and x + 1: the pair's other cell, and one of a neighbour pair
      pr[k].left[f] = b ? B::word(row, 0, m) : B::word(row, 1, m - 1);
      pr[k].right[f] = b ? B::word(row, 0, m + 1) : B::word(row, 1, m);
      pr[k].dist[f] = in ? (dx > dy ? (dx > dz ? dx : dz) : (dy > dz ? dy : dz)) : kOut;
      pr[k].edges[f] = row_edges | ((gx == 0 || gx == nx - 1) ? (1 << DIM) : 0);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int gx = gx0 + b;
      pr[k].write[b] = row_out && gx >= x_lo && gx < x_hi;
    }
  }

  // starts the copies of phi plane p (zeros where p >= nt or outside the
  // grid) into the phi slot dst and, if with_rhs, of rhs plane prhs into
  // the rhs slot rdst, only where a stage reads it (the tile + 2)
  auto load = [&](float* dst, int p, float* rdst, int prhs, bool with_rhs) {
    const float* src = phi + (int64_t)p * S;
    const float* rsrc = rhs + (int64_t)prhs * S;
#pragma unroll
    for (int i = 0; i < 2 * T::K; ++i) {
      const int w = cword[i] & 0xffff;
      if (p < nt && (cword[i] & (1 << 16)))
        cp_async4(dst + w, src + coff[i]);
      else
        dst[w] = 0.f;
      if (with_rhs && (cword[i] & (1 << 17)))
        cp_async4(rdst + w, rsrc + coff[i]);
    }
  };

  // prologue: planes h1_lo - 1 (zero for plane -1), h1_lo and h1_lo + 1
  // of phi and h1_lo of rhs in
  auto phi_slot = [&](int p) { return ring + (p & (kPhiSlots - 1)) * B::P; };
  if (h1_lo == 0)
    for (int i = threadIdx.x; i < B::P; i += blockDim.x)
      phi_slot(-1)[i] = 0.f;
  else
    load(phi_slot(h1_lo - 1), h1_lo - 1, rring, 0, false);
  load(phi_slot(h1_lo), h1_lo, rring + (h1_lo & (kRhsSlots - 1)) * B::P,
       h1_lo, true);
  load(phi_slot(h1_lo + 1), h1_lo + 1, rring, 0, false);
  cp_async_wait_all();
  __syncthreads();

  // step j: stage 1 (colour B on plane j) with plane j-3, final since the
  // last step, written to out; stage 2 (A on plane j-1); stage 3 (B on
  // plane j-2, which is then final). U = j mod 8 fixes every slot and the
  // parity of every plane the step touches.
  auto step = [&](auto u, int j) {
    constexpr int U = decltype(u)::value;
    constexpr int F1 = (1 + U) & 1;  // B on plane j; A on j-1, B on j-2 too
    if (j < h1_lo) return;  // the block's first steps (the loop starts at
                            // a multiple of 8)
    // in flight during this step: phi plane j+2 (zeros for plane nt) and
    // rhs plane j+1, into the slots of planes j-6 and j-3, which no stage
    // of this step reads. No stage reads a phi plane past h1_hi.
    if (j + 2 <= h1_hi)
      load(ring + ((U + 2) & 7) * B::P, j + 2, rring + ((U + 1) & 3) * B::P,
           j + 1, j + 1 < h1_hi);
    if (j < h1_hi)
      stage<DIM, (U + 7) & 7, U & 7, (U + 1) & 7, U & 3, F1, 2>(
          ring, rring, inv_tab, pr, (j == 0 || j == nt - 1) ? 1 : 0, d2, wt,
          wz, wy, wx);
    if (j - 3 >= t_lo && j - 3 < t_hi) {
      const float* src = ring + ((U + 5) & 7) * B::P;
      float* dst = out + (int64_t)(j - 3) * S;
#pragma unroll
      for (int k = 0; k < T::K; ++k) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (pr[k].write[b])
            dst[pr[k].offset + b] = src[pr[k].word + b * B::H];
      }
    }
    __syncthreads();
    if (j - 1 >= h2_lo && j - 1 < h2_hi)
      stage<DIM, (U + 6) & 7, (U + 7) & 7, U & 7, (U + 3) & 3, F1, 1>(
          ring, rring, inv_tab, pr, (j == 1 || j == nt) ? 1 : 0, d2, wt, wz,
          wy, wx);
    __syncthreads();
    if (j - 2 >= t_lo && j - 2 < t_hi)
      stage<DIM, (U + 5) & 7, (U + 6) & 7, (U + 7) & 7, (U + 2) & 3, F1, 0>(
          ring, rring, inv_tab, pr, (j == 2 || j == nt + 1) ? 1 : 0, d2, wt,
          wz, wy, wx);
    cp_async_wait_all();
    __syncthreads();
  };

  // the last step writes plane t_hi - 1
  const int j_end = t_hi + 2;
  for (int j = h1_lo & ~7; j <= j_end; j += 8) {
    step(Int<0>(), j);
    if (j + 1 > j_end) break;
    step(Int<1>(), j + 1);
    if (j + 2 > j_end) break;
    step(Int<2>(), j + 2);
    if (j + 3 > j_end) break;
    step(Int<3>(), j + 3);
    if (j + 4 > j_end) break;
    step(Int<4>(), j + 4);
    if (j + 5 > j_end) break;
    step(Int<5>(), j + 5);
    if (j + 6 > j_end) break;
    step(Int<6>(), j + 6);
    if (j + 7 > j_end) break;
    step(Int<7>(), j + 7);
  }
}

// the attributes a block needs (above 48 KB its dynamic shared memory
// needs one, and the largest carveout lets several blocks share an SM),
// set once for each device
template <int DIM>
cudaError_t configure() {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(rb_sweep_kernel<DIM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(float) * Box<DIM>::kSmemFloats));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rb_sweep_kernel<DIM>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// blocks of the kernel for `dim` that one SM holds at once
template <int DIM>
int blocks_per_sm() {
  int n = -1;
  if (configure<DIM>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rb_sweep_kernel<DIM>, Tile<DIM>::kThreads,
          sizeof(float) * Box<DIM>::kSmemFloats) != cudaSuccess)
    return -1;
  return n;
}

// blocks the card holds at once (every SM full), once for each device
template <int DIM>
int resident_blocks() {
  static int slots[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (slots[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return -1;
    slots[dev] = sms * blocks_per_sm<DIM>();
  }
  return slots[dev];
}

// A tile streams all nt planes, one after another. Where the tiles are too
// few to fill the card, t is cut into chunks of at least kMinChunk planes
// too, each recomputing a halo of 3 planes on either side, so that more
// blocks stream fewer planes each.
constexpr int kMinChunk = 4;

template <int DIM>
int launch(const float* phi, const float* rhs, float* out, int nt, int nz,
           int ny, int nx, float d2, cudaStream_t st) {
  using T = Tile<DIM>;
  const cudaError_t err = configure<DIM>();
  if (err != cudaSuccess) return (int)err;
  const int slots = resident_blocks<DIM>();
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const int gx = (nx + T::X - 1) / T::X, gy = (ny + T::Y - 1) / T::Y;
  const int gz = (nz + T::Z - 1) / T::Z;
  const int64_t tiles = (int64_t)gx * gy * gz;
  int chunks = 1;
  if (tiles < slots) chunks = (int)(slots / tiles);
  if (chunks > nt / kMinChunk) chunks = nt / kMinChunk;
  if (chunks < 1) chunks = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)(gz * chunks));
  rb_sweep_kernel<DIM><<<grid, T::kThreads,
                         sizeof(float) * Box<DIM>::kSmemFloats, st>>>(
      phi, rhs, out, nt, nz, ny, nx, d2, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One symmetric sweep (B, A, B) from phi into out. out must share storage
// with neither phi nor rhs. n0..n2 are the sizes of the space axes in
// order (1 for those a d < 3 field lacks).
int dotsocp_rb_sweep(const float* phi, const float* rhs, float* out, int dim,
                     int nt, int n0, int n1, int n2, float d2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1:
      return launch<1>(phi, rhs, out, nt, 1, 1, n0, d2, st);
    case 2:
      return launch<2>(phi, rhs, out, nt, 1, n0, n1, d2, st);
    case 3:
      return launch<3>(phi, rhs, out, nt, n0, n1, n2, d2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the kernel for `dim` space axes one SM holds at once (-1 on
// an error), for the register and shared memory report.
int dotsocp_rb_sweep_blocks_per_sm(int dim) {
  switch (dim) {
    case 1:
      return blocks_per_sm<1>();
    case 2:
      return blocks_per_sm<2>();
    case 3:
      return blocks_per_sm<3>();
    default:
      return -1;
  }
}

// The shared memory one block of the kernel for `dim` space axes takes, in
// bytes (for the register and shared memory report).
int dotsocp_rb_sweep_smem_bytes(int dim) {
  switch (dim) {
    case 1:
      return (int)(sizeof(float) * Box<1>::kSmemFloats);
    case 2:
      return (int)(sizeof(float) * Box<2>::kSmemFloats);
    case 3:
      return (int)(sizeof(float) * Box<3>::kSmemFloats);
    default:
      return -1;
  }
}

}  // extern "C"
