// Hand-written Hopper (sm_90a) kernel for the flat lane shift with zero
// fill:
//
//   forward   y[r, i] = x[plane, r, i - k]   (0 where i < k)
//   backward  y[r, i] = x[plane, r, i + k]   (0 where i + k >= S)
//
// on an (R, S) field (plane 0) or one plane of a (C, R, S) cone array, for
// any stride k >= 0: a spatial shift by one cell along axis a of the flat
// layout is this shift by k_a = stride_a.
//
// It replaces make_pallas_shift of dotsocp_tpu/ops/pallas_kernels.py, which
// assembles each output tile from two neighbouring input tiles and so
// refuses k > TS (the tile width); that excludes the z stride of a 3D grid.
// Here every thread reads its source element directly, so any k works. Its
// plain version is OpsFlat._sfwd / _sbwd (pad and slice,
// dotsocp_tpu_torch/ops/engine.py); the kernel only copies, so the two are
// bit-equal. As in the JAX package, no solver path calls it: the step
// kernels read their shifted operands at offsets themselves.
//
// Bound by HBM bandwidth: R S floats read, R S written. Design: one thread
// per (r, i), i fastest, grid (ceil(S / 256), R); a warp's loads are one
// contiguous run shifted by k, so at most one transaction more than its
// stores. Offsets are 64-bit.
//
// The entry point launches on the given stream, synchronises nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void shift_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int S, int k,
                             int forward) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (i >= S) return;
  const int64_t row = (int64_t)r * S;
  // the source index, out of [0, S) where the zero fill lands
  const int64_t j = forward ? (int64_t)i - k : (int64_t)i + k;
  y[row + i] = (j >= 0 && j < S) ? x[row + j] : 0.f;
}

}  // namespace

extern "C" {

// y (R, S) from plane `plane` of x, a (C, R, S) array (C >= plane + 1; a
// plain (R, S) field is plane 0). x and y must not overlap.
int dotsocp_flat_shift(const float* x, float* y, int R, int S, int plane,
                       int k, int forward, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || S < 1 || plane < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)R);
  shift_kernel<<<grid, kThreads, 0, st>>>(x + (int64_t)plane * R * S, y, S, k,
                                          forward);
  return (int)cudaGetLastError();
}

}  // extern "C"
