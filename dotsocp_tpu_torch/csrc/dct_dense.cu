// Hand-written Hopper (sm_90a) kernels of the matrix route of the DCT
// Poisson solve (dotsocp_tpu_torch/ops/poisson.py: dense_passes), the
// route of a 2D grid (t, y, x) whose space axes are all shorter than
// FAST_DCT_MIN. The solve
//
//   phi = C_t^T C_y^T C_x^T [ (C_t C_y C_x rhs) * inv_kernel * scale ]
//
// (C_a the orthonormal DCT-II matrix of axis a, each applied along its
// axis) runs as three launches, back to back on one stream:
//
// 1. slab_kernel, the forward slab pass: each (instance, t) slab X
//    (ny x nx) becomes C_y X C_x^T.
// 2. t_spectral_kernel, in place: each space column v (T points) becomes
//    C_t^T ((C_t v) * inv_kernel[:, s] * scale).
// 3. slab_kernel again, the inverse slab pass: C_y^T Y C_x.
//
// These replace no Pallas kernel: the JAX package leaves the product to
// XLA, one dense matmul per axis (dotsocp_tpu/ops/poisson.py:_apply_axis),
// which the port ran as six cuBLAS / CUTLASS GEMMs (with split-K reduces)
// and two elementwise kernels a solve.
//
// Bounds of a solve on the H100 (3.35 TB/s; FP32 FFMA 67 TFLOP/s, 2 FLOPs
// an FFMA): bytes, the rhs and the kernel read and phi written once
// (12 T ny nx); FLOPs, 2 ny nx (ny + nx) a slab for each slab pass and
// 4 T^2 a column for the t pass, 4 T ny nx (ny + nx + T) in all:
//
//   33^3:        0.43 MB and 14 MFLOP:  0.13 us of bytes, 0.21 us of
//                FLOPs: each pass is bound by its launch and its few
//                dependent steps (~2-3 us).
//   129^2 x 33:  6.6 MB, 0.64 GFLOP:    2.0 us of bytes, 9.5 us of FLOPs.
//   129^3:       26 MB, 3.3 GFLOP:      7.7 us of bytes, 50 us of FLOPs.
//
// So the passes are compute-bound past ~65^3 and latency-bound below.
// Design:
// - Every product is a block-level product of two operands held in shared
//   memory: a thread owns TM x TN outputs in registers (8 x 4, 4 x 4 or
//   4 x 1) and sums over the contracted axis in order, one fmaf a term
//   (full float32: no tensor core, no TF32), its rows read as float4
//   broadcasts. The tile shape follows the block's size: large blocks take
//   large tiles for their FFMA-to-load ratio, small ones 4 x 1 so that
//   enough threads share the short sums. Every tile shape sums each output
//   in the same order, so the shape changes no bit of the answer.
// - A slab pass gives a block a run of M output rows of one slab: it
//   stages the slab, the M columns of A^T it needs and (where there is
//   room) B, forms Z = A[i0:i0+M] X into shared memory (transposed), and
//   writes Z B. Slabs are cut into as many row runs as make one block an
//   SM over all slabs (so 33 or 65 slabs still spread over the card; a
//   second block on some SMs would double the pass), each run re-reading
//   its slab and B from L2.
// - The intermediate between the passes has its rows padded to a
//   multiple of 4 floats (zeros), so that it is staged 16 bytes a copy
//   (cp.async) as the matrices are; only the rhs, whose rows are not
//   aligned, is staged a float a copy.
// - The t pass gives a block NC columns of one instance: it stages C_t^T
//   (and C_t where there is room), forms the spectrum, scales it by the
//   kernel, and writes the columns back in place (the block reads all of
//   its columns before it writes any, and no other block touches them).
// - Each pass is launched to start while the kernel before it ends
//   (programmatic dependent launch): it stages its matrices, then waits
//   for that kernel's grid (griddepcontrol.wait) before it reads the
//   field. This hides a launch and the matrices' latency a pass, which is
//   most of a pass below 65^3.
//
// The entry points launch on the given stream, synchronise nothing, and
// return cudaGetLastError() (or cudaErrorInvalidValue for arguments or
// shapes they do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;
// shared memory a block may take and still leave room for a second block
// on the SM (228 KB, 1 KB of it reserved a block)
constexpr size_t kTwoBlocks = 113 * 1024;

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// device memory to shared memory, asynchronously (cp.async): one float, or
// four aligned to 16 bytes; copy_commit closes a group, copy_wait<N> waits
// until at most N of this thread's groups are in flight
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// programmatic dependent launch: each pass is launched to start while the
// kernel before it ends; it stages its matrices, waits for that kernel's
// grid to finish (wait_before), and then lets the pass after it start
// (let_after)
__device__ __forceinline__ void wait_before() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_after() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// dst[r * ldd + c] = src[r * lds + c0 + c] for c < cols, 0 for
// cols <= c < ldd, 16 bytes a copy: src, lds, c0, cols and ldd aligned to
// 4 floats
__device__ __forceinline__ void stage16(float* dst, int ldd, const float* src,
                                        int64_t lds, int c0, int rows,
                                        int cols) {
  const int q = ldd / 4, n = rows * q;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / q, c = 4 * (e - r * q);
    if (c < cols)
      copy16(dst + r * ldd + c, src + r * lds + c0 + c);
    else
      *reinterpret_cast<float4*>(dst + r * ldd + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the same one float a copy, for rows that are not aligned
__device__ __forceinline__ void stage4(float* dst, int ldd, const float* src,
                                       int64_t lds, int rows, int cols) {
  const int n = rows * cols;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    copy4(dst + r * ldd + c, src + r * lds + c);
  }
  const int pad = ldd - cols;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x) {
    const int r = e / pad;
    dst[r * ldd + cols + (e - r * pad)] = 0.f;
  }
}

// acc[i][j] = sum_k a[k * lda + m0 + i] * b[k * ldb + n0 + j] for i < TM,
// j < TN, k from 0 to K - 1 in order, one fmaf a term; a and b in shared
// memory, 16-byte aligned, lda and m0 multiples of 4 (and ldb and n0 where
// TN = 4). A warp's threads share their rows (a broadcast) and read
// neighbouring columns of b.
template <int TM, int TN>
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* b, int ldb, int K,
                                             int m0, int n0,
                                             float (&acc)[TM][TN]) {
  static_assert(TM % 4 == 0 && (TN == 1 || TN == 4), "tile shape");
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const float* pa = a + m0;
  const float* pb = b + n0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float ar[TM], br[TN];
#pragma unroll
    for (int u = 0; u < TM / 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(pa + k * lda + 4 * u);
      ar[4 * u] = v.x;
      ar[4 * u + 1] = v.y;
      ar[4 * u + 2] = v.z;
      ar[4 * u + 3] = v.w;
    }
    if constexpr (TN == 4) {
      const float4 v = *reinterpret_cast<const float4*>(pb + k * ldb);
      br[0] = v.x;
      br[1] = v.y;
      br[2] = v.z;
      br[3] = v.w;
    } else {
      br[0] = pb[k * ldb];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// y[slab] = A x[slab] B over slabs (ny x nx; rows ldx floats apart in x,
// ldy in y) with at = A^T (ny x nyp) and b = B (nx x nxp), both row-major
// and padded with zeros to a multiple of 4 columns; block blockIdx.x =
// slab * R + r writes rows r M .. r M + M - 1 of its slab, columns up to
// ldy (B's zero columns past nx give zeros). Shared memory (floats):
// ny * nxp (the slab), nx * nxp (B; with sep false B takes the slab's
// place once the first product is done), ny * M (A^T's columns), nx * M
// (Z^T).
template <int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
    slab_kernel(const float* __restrict__ x, int ldx, float* __restrict__ y,
                int ldy, const float* __restrict__ at,
                const float* __restrict__ b, int ny, int nx, int M, int R,
                int sep) {
  extern __shared__ float4 smem[];
  const int nxp = pad4(nx), nyp = pad4(ny);
  float* const xs = reinterpret_cast<float*>(smem);
  float* const bs = sep ? xs + ny * nxp : xs;
  float* const as = sep ? bs + nx * nxp : xs + (ny > nx ? ny : nx) * nxp;
  float* const zt = as + ny * M;
  const int64_t slab = blockIdx.x / R;
  const int i0 = (int)(blockIdx.x - slab * R) * M;
  stage16(as, M, at, nyp, i0, ny, nyp - i0 < M ? nyp - i0 : M);
  if (sep) stage16(bs, nxp, b, nxp, 0, nx, nxp);
  wait_before();
  let_after();
  const float* const xl = x + slab * ny * ldx;
  if (ldx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    stage16(xs, nxp, xl, ldx, 0, ny, nxp);
  else
    stage4(xs, nxp, xl, ldx, ny, nx);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  const int nt = nxp / TN;
  const int tiles = (M / TM) * nt;
  float acc[TM][TN];
  // Z = A[i0 : i0 + M] X, stored as zt[k][i] for k < nx
  for (int q = threadIdx.x; q < tiles; q += blockDim.x) {
    const int m0 = (q / nt) * TM, n0 = (q % nt) * TN;
    tile_product<TM, TN>(as, M, xs, nxp, ny, m0, n0, acc);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (n0 + j < nx)
#pragma unroll
        for (int u = 0; u < TM / 4; ++u)
          *reinterpret_cast<float4*>(zt + (n0 + j) * M + m0 + 4 * u) =
              make_float4(acc[4 * u][j], acc[4 * u + 1][j],
                          acc[4 * u + 2][j], acc[4 * u + 3][j]);
  }
  if (!sep) {
    __syncthreads();
    stage16(bs, nxp, b, nxp, 0, nx, nxp);
    copy_commit();
  }
  copy_wait<0>();
  __syncthreads();
  // y rows i0 .. i0 + M - 1 = Z B
  float* const ys = y + slab * ny * ldy;
  for (int q = threadIdx.x; q < tiles; q += blockDim.x) {
    const int m0 = (q / nt) * TM, n0 = (q % nt) * TN;
    tile_product<TM, TN>(zt, M, bs, nxp, nx, m0, n0, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = i0 + m0 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (row < ny && n0 + j < ldy) ys[row * ldy + n0 + j] = acc[i][j];
    }
  }
}

// In place on v (L, T, S), S a multiple of 4: each column v[l, :, s]
// becomes C_t^T ((C_t v[l, :, s]) * (g[:, s] * scale)), with ctt = C_t^T
// and ct = C_t (T x pad4(T), row-major, padded with zeros) and g (T, S).
// Block blockIdx.x = l * C + c owns columns c NC .. c NC + NC - 1. Shared
// memory (floats), tp = T rounded up to a multiple of TM: T * tp (C_t^T),
// T * tp (C_t; with sep false C_t takes C_t^T's place once the first
// product is done), T * NC (the columns), T * NC (their scaled spectrum).
template <int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
    t_spectral_kernel(float* v, const float* __restrict__ ctt,
                      const float* __restrict__ ct,
                      const float* __restrict__ g, float scale, int T,
                      int64_t S, int NC, int C, int sep) {
  extern __shared__ float4 smem[];
  const int tp = (T + TM - 1) / TM * TM, t4 = pad4(T);
  float* const ms = reinterpret_cast<float*>(smem);
  float* const ms2 = sep ? ms + T * tp : ms;
  float* const xs = ms2 + T * tp;
  float* const ws = xs + T * NC;
  const int64_t l = blockIdx.x / C;
  const int64_t s0 = (blockIdx.x - l * C) * (int64_t)NC;
  const int nc = (int)(S - s0 < NC ? S - s0 : NC);
  float* const vl = v + l * T * S + s0;
  stage16(ms, tp, ctt, t4, 0, T, t4);
  if (sep) stage16(ms2, tp, ct, t4, 0, T, t4);
  wait_before();
  let_after();
  stage16(xs, NC, vl, S, 0, T, nc);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  const int nt = NC / TN;
  const int tiles = (tp / TM) * nt;
  float acc[TM][TN];
  // W[k][j] = (sum_t C_t[k][t] x[t][j]) * (g[k][j] * scale), k < T
  for (int q = threadIdx.x; q < tiles; q += blockDim.x) {
    const int m0 = (q / nt) * TM, n0 = (q % nt) * TN;
    tile_product<TM, TN>(ms, tp, xs, NC, T, m0, n0, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k = m0 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (k < T)
          ws[k * NC + n0 + j] =
              n0 + j < nc
                  ? __fmul_rn(acc[i][j],
                              __fmul_rn(g[k * S + s0 + n0 + j], scale))
                  : 0.f;
    }
  }
  if (!sep) {
    __syncthreads();
    stage16(ms2, tp, ct, t4, 0, T, t4);
    copy_commit();
  }
  copy_wait<0>();
  __syncthreads();
  // v[t][j] = sum_k C_t[k][t] W[k][j]
  for (int q = threadIdx.x; q < tiles; q += blockDim.x) {
    const int m0 = (q / nt) * TM, n0 = (q % nt) * TN;
    tile_product<TM, TN>(ms2, tp, ws, NC, T, m0, n0, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = m0 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (t < T && n0 + j < nc) vl[t * S + n0 + j] = acc[i][j];
    }
  }
}

struct Card {
  int sms = 0;
  int optin = 0;  // bytes of shared memory a block may opt in to
};

cudaError_t card(Card& c) {
  static Card known;
  if (known.sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&known.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&known.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) {
      known.sms = 0;
      return e;
    }
  }
  c = known;
  return cudaSuccess;
}

// above 48 KB a block's shared memory is an opt-in, set once a kernel for
// the largest asked
cudaError_t opt_in(const void* kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) opted = bytes;
  return e;
}

int threads_for(int tiles) {
  const int t = (tiles + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
}

// bytes of a slab block's shared memory, B in a region of its own (sep) or
// in the slab's
size_t slab_smem(int ny, int nx, int M, bool sep) {
  const size_t rows = sep ? ny + nx : (ny > nx ? ny : nx);
  return sizeof(float) * (rows * pad4(nx) + (size_t)(ny + nx) * M);
}

// bytes of a t block's shared memory, C_t in a region of its own (sep) or
// in C_t^T's, the matrices' rows padded to a multiple of TM
size_t t_smem(int T, int NC, int TM, bool sep) {
  const size_t tp = (T + TM - 1) / TM * TM;
  return sizeof(float) * ((sep ? 2 : 1) * T * tp + 2 * (size_t)T * NC);
}

// the second operand in a region of its own, staged while the first
// product runs, where that still leaves room for two blocks an SM, or
// where there is no second block an SM to make room for
bool separate(size_t sep, size_t shared, int64_t blocks, const Card& c) {
  return sep <= (size_t)c.optin &&
         (sep <= kTwoBlocks || shared > kTwoBlocks || blocks <= c.sms);
}

// a kernel's tile shape: TM x TN outputs a thread
struct Tile {
  int TM, TN;
};

// a launch that may start while the kernel before it on the stream ends
// (programmatic stream serialization; the kernel waits for it), opting in
// to the kernel's shared memory first (`opted`, the kernel's record)
template <class... Params, class... Args>
cudaError_t launch_early(void (*kernel)(Params...), size_t& opted, dim3 grid,
                         int threads, size_t smem, cudaStream_t st,
                         Args... args) {
  const cudaError_t e = opt_in((const void*)kernel, smem, opted);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int TM, int TN>
struct SlabKernel {
  template <class... Args>
  static cudaError_t launch(dim3 g, int th, size_t sm, cudaStream_t st,
                            Args... a) {
    static size_t opted = 48 * 1024;
    return launch_early(slab_kernel<TM, TN>, opted, g, th, sm, st, a...);
  }
};

template <int TM, int TN>
struct TKernel {
  template <class... Args>
  static cudaError_t launch(dim3 g, int th, size_t sm, cudaStream_t st,
                            Args... a) {
    static size_t opted = 48 * 1024;
    return launch_early(t_spectral_kernel<TM, TN>, opted, g, th, sm, st,
                        a...);
  }
};

// K<TM, TN>'s kernel for the tile shape t: 8 x 4, 4 x 4 or 4 x 1
template <template <int, int> class K, class... Args>
cudaError_t launch_tile(Tile t, dim3 grid, int threads, size_t smem,
                        cudaStream_t st, Args... args) {
  const cudaError_t e =
      t.TM == 8   ? K<8, 4>::launch(grid, threads, smem, st, args...)
      : t.TN == 4 ? K<4, 4>::launch(grid, threads, smem, st, args...)
                  : K<4, 1>::launch(grid, threads, smem, st, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the slab pass with runs of M rows (a multiple of t.TM)
cudaError_t launch_slab(const float* x, int ldx, float* y, int ldy,
                        const float* at, const float* b, int64_t slabs,
                        int ny, int nx, int M, Tile t, const Card& c,
                        cudaStream_t st) {
  const size_t shared = slab_smem(ny, nx, M, false);
  if (M < t.TM || M % t.TM != 0 || shared > (size_t)c.optin)
    return cudaErrorInvalidValue;
  const int R = (ny + M - 1) / M;
  const bool sep =
      separate(slab_smem(ny, nx, M, true), shared, slabs * R, c);
  const size_t smem = slab_smem(ny, nx, M, sep);
  return launch_tile<SlabKernel>(
      t, dim3((unsigned)(slabs * R)),
      threads_for((M / t.TM) * (pad4(nx) / t.TN)), smem, st, x, ldx, y, ldy,
      at, b, ny, nx, M, R, (int)sep);
}

// the t pass with NC columns a block (a multiple of 4)
cudaError_t launch_t(float* v, const float* ctt, const float* ct,
                     const float* g, int64_t L, int T, int64_t S, float scale,
                     int NC, Tile t, const Card& c, cudaStream_t st) {
  const size_t shared = t_smem(T, NC, t.TM, false);
  if (NC < 4 || NC % 4 != 0 || S % 4 != 0 || shared > (size_t)c.optin)
    return cudaErrorInvalidValue;
  const int64_t C = (S + NC - 1) / NC;
  const bool sep = separate(t_smem(T, NC, t.TM, true), shared, L * C, c);
  const size_t smem = t_smem(T, NC, t.TM, sep);
  return launch_tile<TKernel>(
      t, dim3((unsigned)(L * C)),
      threads_for((T + t.TM - 1) / t.TM * (NC / t.TN)), smem, st, v, ctt, ct,
      g, scale, T, S, NC, (int)C, (int)sep);
}

// a pass's launch shape: its tile shape and its block's rows (slab) or
// columns (t)
struct Plan {
  Tile tile;
  int width;
};

// The launch shapes below were chosen from a sweep of tile shapes, rows
// and columns a block at the cells' level shapes on the H100 (PERF.md
// §6, row 15).
//
// The slab pass: as many row runs a slab as make one block an SM over all
// slabs (a second wave, or a second block on some SMs, doubles the time);
// the first tile shape, of 8 x 4, 4 x 4 and 4 x 1, that gives a block at
// least kFewTiles tiles (warps enough to hide shared memory's latency),
// else 4 x 1; M rows a run, a multiple of the tile's, that fit.
constexpr int kFewTiles = 128;

Plan slab_plan(int64_t slabs, int ny, int nx, const Card& c) {
  const int64_t runs = c.sms / slabs > 1 ? c.sms / slabs : 1;
  const int rows = (int)((ny + runs - 1) / runs);
  const Tile shapes[] = {{8, 4}, {4, 4}, {4, 1}};
  Tile t = shapes[2];
  for (const Tile& s : shapes) {
    const int M = (rows + s.TM - 1) / s.TM * s.TM;
    if ((M / s.TM) * (pad4(nx) / s.TN) >= kFewTiles) {
      t = s;
      break;
    }
  }
  int M = (rows + t.TM - 1) / t.TM * t.TM;
  while (M > t.TM && slab_smem(ny, nx, M, false) > (size_t)c.optin)
    M -= t.TM;
  return {t, M};
}

// The t pass: 4 x 1 tiles up to T = 40, else 4 x 4; the widest tile of
// columns, of 64, 32, 16 and 8, that keeps to kMostTiles tiles a block
// (a second round of tiles costs more than the blocks it saves) and fits.
constexpr int kMostTiles = 320;

Plan t_plan(int T, const Card& c) {
  const Tile t = T <= 40 ? Tile{4, 1} : Tile{4, 4};
  int NC = 64;
  while (NC > 8 && ((T + t.TM - 1) / t.TM * (NC / t.TN) > kMostTiles ||
                    t_smem(T, NC, t.TM, false) > (size_t)c.optin))
    NC /= 2;
  return {t, NC};
}

}  // namespace

extern "C" {

// y (slabs, ny, nx) = A x B slab by slab, rows ldx floats apart in x and
// ldy in y (nx or pad4(nx); ldy past nx gets zeros); at = A^T (ny, nyp),
// b = B (nx, nxp), float32, row-major, padded with zeros to nyp = pad4(ny)
// and nxp = pad4(nx) columns; x and y must not overlap.
int dotsocp_dct_slab(const void* x, int ldx, void* y, int ldy, const void* at,
                     const void* b, int64_t slabs, int ny, int nx,
                     void* stream) {
  if (slabs < 1 || ny < 1 || nx < 1 || (ldx != nx && ldx != pad4(nx)) ||
      (ldy != nx && ldy != pad4(nx)))
    return (int)cudaErrorInvalidValue;
  Card c;
  const cudaError_t e = card(c);
  if (e != cudaSuccess) return (int)e;
  const Plan p = slab_plan(slabs, ny, nx, c);
  return (int)launch_slab(
      static_cast<const float*>(x), ldx, static_cast<float*>(y), ldy,
      static_cast<const float*>(at), static_cast<const float*>(b), slabs, ny,
      nx, p.width, p.tile, c, static_cast<cudaStream_t>(stream));
}

// v (L, T, S) in place, S a multiple of 4: each column's t-axis DCT, times
// g (T, S) * scale, and the inverse DCT; ctt = C_t^T and ct = C_t (T, tp),
// float32, row-major, padded with zeros to tp = pad4(T) columns.
int dotsocp_dct_t_spectral(void* v, const void* ctt, const void* ct,
                           const void* g, int64_t L, int T, int64_t S,
                           float scale, void* stream) {
  if (L < 1 || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  Card c;
  const cudaError_t e = card(c);
  if (e != cudaSuccess) return (int)e;
  const Plan p = t_plan(T, c);
  return (int)launch_t(static_cast<float*>(v),
                       static_cast<const float*>(ctt),
                       static_cast<const float*>(ct),
                       static_cast<const float*>(g), L, T, S, scale, p.width,
                       p.tile, c, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
