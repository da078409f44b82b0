// Hand-written Hopper (sm_90a) kernel for the phi-step of the sGS methods:
// one red-black half-sweep of the scaled space-time Neumann Laplacian
//
//   (d2 A^T A) phi = rhs,   phi(cell) <- (rhs + d2 sum_a w_a (phi[-1] +
//   phi[+1])) * inv_diag    on the cells of one colour,
//
// with w_a = (n_a - 1)^2 per array axis (t first) and the missing
// neighbour at each edge counted as zero. A symmetric sweep is three
// launches: colours B, A, B.
//
// It replaces both Pallas sweeps of dotsocp_tpu/ops/pallas_kernels.py,
// make_sgs_sweep_pallas (whole field in VMEM) and make_sgs_sweep_pallas_tiled
// (row tiles with a 3-row halo): the split between them is the TPU's VMEM
// budget, which has no counterpart here. It follows the operation order of
// the plain version (dotsocp_tpu_torch/ops/sgs.py, after dotsocp_tpu/ops/
// sgs.py), so the two agree to a few ulp; FMA contraction is left on.
//
// Layout (f32, contiguous): phi, rhs and out are the field (nt, *space),
// viewed as (nt, S) with S = prod(space) and the last axis fastest; one,
// two or three space axes (DIM), each with its own size n_a. In 3D this is
// the counterpart of the whole-field Pallas kernel (the tiled one is 2D
// only).
//
// inv_diag is computed in the kernel from the per-axis degree (1 at an
// edge, 2 inside), as the tiled Pallas kernel does, instead of read: the
// sweep is bound by HBM bandwidth, and the array would add a 68 MB read per
// half-sweep at 513^2 x 65.
//
// In place: a cell of the active colour reads only cells of the other
// colour, which the same launch never writes, and never reads its own
// value. So `src` may equal `dst`. The first half-sweep of a sweep writes a
// fresh output (the active cells updated, the others copied) and leaves
// its input intact; the wrapper (ops/sgs_sweep.py) then runs the next two
// in place on that output. Bytes per half-sweep: phi read, rhs read, out
// written (~205 MB at 513^2 x 65), one streaming pass.
//
// Design: one thread per (t, s), s fastest, grid (ceil(S / 256), nt), so
// every load and store of a warp is coalesced; neighbours along the last
// axis share the warp's cache lines, the others come through L2. Offsets
// are 64-bit. Tiling through shared memory with a 3-row halo, and fusing
// the three half-sweeps into one launch, are left for later work.
//
// The entry point launches on the given stream, synchronises nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// DIM = number of space axes (1, 2 or 3); the field has DIM + 1 axes. The
// sizes of the axes a DIM < 3 launch lacks are 1 and never read.
template <int DIM>
__global__ void rb_half_kernel(const float* src, const float* __restrict__ rhs,
                               float* dst, int nt, int S, int n0, int n1,
                               int n2, float d2, int color, int copy_other) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (s >= S) return;
  const int n[3] = {n0, n1, n2};
  // coordinates and strides of the space axes (last axis fastest)
  int c[DIM], k[DIM];
  int rest = s;
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {
    c[a] = rest % n[a];
    rest /= n[a];
  }
  k[DIM - 1] = 1;
#pragma unroll
  for (int a = DIM - 2; a >= 0; --a) k[a] = k[a + 1] * n[a + 1];

  int parity = t;
#pragma unroll
  for (int a = 0; a < DIM; ++a) parity += c[a];
  const int64_t cell = (int64_t)t * S + s;
  // colour 0 = A (even coordinate sum, the origin's class), 1 = B
  if ((parity & 1) != color) {
    if (copy_other) dst[cell] = src[cell];
    return;
  }

  // neighbour sum, t first, then the space axes: out + w * (lo + hi)
  const float wt = (float)(nt - 1) * (float)(nt - 1);
  float lo = t > 0 ? src[cell - S] : 0.f;
  float hi = t < nt - 1 ? src[cell + S] : 0.f;
  float nbr = wt * (lo + hi);
  float diag = wt * ((t == 0 || t == nt - 1) ? 1.f : 2.f);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float w = (float)(n[a] - 1) * (float)(n[a] - 1);
    lo = c[a] > 0 ? src[cell - k[a]] : 0.f;
    hi = c[a] < n[a] - 1 ? src[cell + k[a]] : 0.f;
    nbr = nbr + w * (lo + hi);
    diag = diag + w * ((c[a] == 0 || c[a] == n[a] - 1) ? 1.f : 2.f);
  }
  const float inv_diag = (1.f / diag) / d2;
  dst[cell] = (rhs[cell] + d2 * nbr) * inv_diag;
}

}  // namespace

extern "C" {

// One half-sweep of colour `color` (0 = A, 1 = B) from src into dst; with
// copy_other the cells of the other colour are copied from src, else dst
// keeps them. src == dst is allowed (see above); rhs must not alias dst.
// n0..n2 are the sizes of the space axes (1 for those a d < 3 field lacks).
int dotsocp_rb_half_sweep(const float* src, const float* rhs, float* dst,
                          int dim, int nt, int S, int n0, int n1, int n2,
                          float d2, int color, int copy_other, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)nt);
  switch (dim) {
    case 1:
      rb_half_kernel<1><<<grid, kThreads, 0, st>>>(
          src, rhs, dst, nt, S, n0, n1, n2, d2, color, copy_other);
      break;
    case 2:
      rb_half_kernel<2><<<grid, kThreads, 0, st>>>(
          src, rhs, dst, nt, S, n0, n1, n2, d2, color, copy_other);
      break;
    case 3:
      rb_half_kernel<3><<<grid, kThreads, 0, st>>>(
          src, rhs, dst, nt, S, n0, n1, n2, d2, color, copy_other);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
