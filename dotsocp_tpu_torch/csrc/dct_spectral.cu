// Hand-written Hopper (sm_90a) kernels of the FFT route of the DCT Poisson
// solve (dotsocp_tpu_torch/ops/poisson.py).
//
// 1. spectral_kernel, the spectral step: on the half spectrum V of the
// reordered field (torch.fft.rfftn over the M = 1, 2 or 3 trailing axes on
// the route, held as (n1, n2, h3) with ones in front of fewer than three),
// in place,
//
//   Y  = V * T                          T = prod_a exp(-i pi k_a / (2 n_a))
//   F  = unpair(Y)    along axis 1, then axis 2: F(k) = (Y(k) + i Y(-k)) / 2,
//                     F(0) = Y(0) (nothing to do along an axis of 1)
//   F' = (g0 * scale * Re F) + i (g1 * scale * Im F)
//   Y' = pair(F')     along axis 2, then axis 1: Y'(k) = F'(k) - i F'(-k),
//                     Y'(0) = F'(0)
//   V' = Y' * conj(T)
//
// with -k = (n - k) mod n along the axis. Re F(k1, k2, k3) is the
// unnormalised DCT-II coefficient of modes (k1, k2, k3) and -Im F that of
// (k1, k2, n3 - k3) (Makhoul's algorithm in M dimensions), so (g0, g1) is
// the inverse kernel of those two modes, times 1 / (n1 n2 n3) for the
// unnormalised inverse FFT (0 where k3 = 0 has no mode n3). The solve's
// torch.fft.irfftn of V' then gives phi. Its plain version is
// poisson.spectral_multiply_plain, the same operations in the same order
// (every one rounded as written: __f*_rn).
//
// Layouts, all contiguous: V (R, n1, n2, h3) complex64, h3 = n3 / 2 + 1;
// g (Rg, n1, n2, h3, 2) float, Rg dividing R (the leading instance axes of
// V have no g of their own: row r reads g's row r mod Rg); T (n1, n2, h3)
// complex64.
//
// Bound by HBM bandwidth: V read and written once, g read once (T is small
// and stays in L2). Design: one thread per (r, k1, k2, k3) with
// k1 <= n1 / 2 and k2 <= n2 / 2, which also does the partners n1 - k1 and
// n2 - k2 (up to four points: unpairing couples them; k = 0 and k = n / 2
// are their own partners), k3 fastest; 64-bit offsets.
//
// 2. t_gather_kernel, the t axis's dense transform and the spatial
// reorder in one pass: on an (L, T, S) field, S the flattened space axes,
//
//   y[l, k, s] = sum_t A[k, t] x[l, t, src[s]]
//
// with A the t axis's DCT matrix (forward: src takes the grid's layout to
// the route's) or its transpose (inverse: src the way back). Its plain
// version is poisson.t_gather_plain, the matrix product along t and the
// gather. The sum runs over t in order, one fmaf a term. Design: a block
// of `tile` threads owns `tile` points s; it reads their T values once
// into shared memory, then makes the T outputs kRows at a time in
// registers, A read as broadcast float4 loads (t-major, rows padded with
// zeros to TP, a multiple of kRows). A sits in shared memory beside the
// values where both fit (T up to ~180 on the H100), else it is read
// through L1; where T tile floats do not fit, the tile narrows to 64 or 32, and
// past that (T > ~1800) the launch is refused. Work: T^2 fmaf a point
// (2.2 GFLOP at 513^2 x 65), x read and y written once.
//
// The entry points launch on the given stream, synchronise nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct C {
  float re, im;
};

__device__ __forceinline__ C cmul(C a, C b) {
  return {__fsub_rn(__fmul_rn(a.re, b.re), __fmul_rn(a.im, b.im)),
          __fadd_rn(__fmul_rn(a.re, b.im), __fmul_rn(a.im, b.re))};
}

__device__ __forceinline__ C cmul_conj(C a, C b) {  // a * conj(b)
  return {__fadd_rn(__fmul_rn(a.re, b.re), __fmul_rn(a.im, b.im)),
          __fsub_rn(__fmul_rn(a.im, b.re), __fmul_rn(a.re, b.im))};
}

// (a + i b) / 2
__device__ __forceinline__ C unpair(C a, C b) {
  return {__fmul_rn(__fsub_rn(a.re, b.im), 0.5f),
          __fmul_rn(__fadd_rn(a.im, b.re), 0.5f)};
}

// a - i b
__device__ __forceinline__ C pair(C a, C b) {
  return {__fadd_rn(a.re, b.im), __fsub_rn(a.im, b.re)};
}

__device__ __forceinline__ C load(const float2* p) {
  const float2 v = *p;
  return {v.x, v.y};
}

__device__ __forceinline__ void store(float2* p, C v) {
  *p = make_float2(v.re, v.im);
}

// F' = (g0 s Re F) + i (g1 s Im F), g read as a pair
__device__ __forceinline__ C scale_pair(C f, const float2* g, float s) {
  const float2 gv = *g;
  return {__fmul_rn(__fmul_rn(gv.x, s), f.re),
          __fmul_rn(__fmul_rn(gv.y, s), f.im)};
}

// y[a][b] = unpair (fwd) or pair of the partners along axis 1 (a) or 2 (b)
__device__ __forceinline__ void mix(C y[2][2], bool axis1, bool fwd) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    C& u = axis1 ? y[0][j] : y[j][0];
    C& w = axis1 ? y[1][j] : y[j][1];
    const C a = fwd ? unpair(u, w) : pair(u, w);
    const C b = fwd ? unpair(w, u) : pair(w, u);
    u = a;
    w = b;
  }
}

// kThree: three route axes; else n1 = 1, known to the compiler
template <bool kThree>
__global__ void spectral_kernel(float2* __restrict__ V,
                                const float2* __restrict__ g,
                                const float2* __restrict__ T, int64_t total,
                                int n1_, int n2, int h3, int64_t g_rows,
                                float s) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n1 = kThree ? n1_ : 1;
  // i = ((r * (n1 / 2 + 1) + p1) * (n2 / 2 + 1) + p2) * h3 + k3
  const int c1 = n1 / 2 + 1, c2 = n2 / 2 + 1;
  int64_t rest = i / h3;
  const int k3 = (int)(i - rest * h3);
  const int p2 = (int)(rest % c2);
  rest /= c2;
  const int p1 = (int)(rest % c1);
  const int64_t r = rest / c1;
  const int q[2][2] = {{p1, p1 == 0 ? 0 : n1 - p1},
                       {p2, p2 == 0 ? 0 : n2 - p2}};
  const int64_t plane = (int64_t)n1 * n2 * h3;
  float2* const vr = V + r * plane;
  const float2* const gr = g + (r % g_rows) * plane;
  int64_t o[2][2];
  C t[2][2], y[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      o[a][b] = ((int64_t)q[0][a] * n2 + q[1][b]) * h3 + k3;
      t[a][b] = load(T + o[a][b]);
      y[a][b] = cmul(load(vr + o[a][b]), t[a][b]);
    }
  if (p1 != 0) mix(y, true, true);
  if (p2 != 0) mix(y, false, true);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      y[a][b] = scale_pair(y[a][b], gr + o[a][b], s);
  if (p2 != 0) mix(y, false, false);
  if (p1 != 0) mix(y, true, false);
  // a point that is its own partner is stored once
  const bool two1 = q[0][1] != p1, two2 = q[1][1] != p2;
  store(vr + o[0][0], cmul_conj(y[0][0], t[0][0]));
  if (two1) store(vr + o[1][0], cmul_conj(y[1][0], t[1][0]));
  if (two2) store(vr + o[0][1], cmul_conj(y[0][1], t[0][1]));
  if (two1 && two2) store(vr + o[1][1], cmul_conj(y[1][1], t[1][1]));
}

constexpr int kTile = 128;
constexpr int kRows = 16;

template <bool kSharedA>
__global__ void __launch_bounds__(kTile)
    t_gather_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ At,
                    const int* __restrict__ src, int T, int TP, int64_t S) {
  // [A (T x TP, t-major) where kSharedA] then the block's T x tile
  // values, column threadIdx.x a thread's own; TP % 16 == 0 keeps both
  // 16-byte aligned
  extern __shared__ float4 smem[];
  const int tile = blockDim.x;
  float* const sm = reinterpret_cast<float*>(smem);
  const float* A = At;
  float* xs = sm;
  if (kSharedA) {
    for (int i = threadIdx.x; i < T * TP; i += tile) sm[i] = At[i];
    A = sm;
    xs = sm + T * TP;
  }
  const int64_t l = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * tile + threadIdx.x;
  const bool live = s < S;
  const int64_t base = l * T * S;
  const int64_t from = live ? (int64_t)src[s] : 0;
  for (int t = 0; t < T; ++t)
    xs[t * tile + threadIdx.x] = live ? x[base + t * S + from] : 0.f;
  __syncthreads();
  for (int k0 = 0; k0 < T; k0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float xv = xs[t * tile + threadIdx.x];
      const float4* a = reinterpret_cast<const float4*>(A + t * TP + k0);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 av = a[q];
        acc[4 * q] = fmaf(av.x, xv, acc[4 * q]);
        acc[4 * q + 1] = fmaf(av.y, xv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(av.z, xv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(av.w, xv, acc[4 * q + 3]);
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (k0 + j < T) y[base + (int64_t)(k0 + j) * S + s] = acc[j];
    }
  }
}

// above 48 KB a block's shared memory is an opt-in, set once a variant for
// the largest asked
template <bool kSharedA>
cudaError_t launch_t_gather(const float* x, float* y, const float* At,
                            const int* src, int64_t L, int T, int TP,
                            int64_t S, int tile, size_t smem,
                            cudaStream_t st) {
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        t_gather_kernel<kSharedA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const dim3 grid((unsigned)((S + tile - 1) / tile), (unsigned)L);
  t_gather_kernel<kSharedA><<<grid, tile, smem, st>>>(x, y, At, src, T, TP,
                                                      S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// V (R, n1, n2, h3) complex64 in place; g (Rg, n1, n2, h3, 2); T (n1, n2,
// h3) complex64. One or two route axes: n1 = 1, or n1 = n2 = 1.
int dotsocp_dct_spectral(void* V, const void* g, const void* T, int64_t R,
                         int n1, int n2, int h3, int64_t g_rows, float scale,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || n1 < 1 || n2 < 1 || h3 < 1 || g_rows < 1 || R % g_rows != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = R * (n1 / 2 + 1) * (n2 / 2 + 1) * h3;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  float2* const v = static_cast<float2*>(V);
  const float2* const gp = static_cast<const float2*>(g);
  const float2* const tp = static_cast<const float2*>(T);
  if (n1 > 1)
    spectral_kernel<true><<<blocks, kThreads, 0, st>>>(v, gp, tp, total, n1,
                                                       n2, h3, g_rows, scale);
  else
    spectral_kernel<false><<<blocks, kThreads, 0, st>>>(v, gp, tp, total, n1,
                                                        n2, h3, g_rows, scale);
  return (int)cudaGetLastError();
}

// y (L, T, S) from x (L, T, S); At (T, TP) float, TP a multiple of 16 and
// >= T, At[t, k] = A[k, t]; src (S) int32 in [0, S). x and y must not
// overlap.
int dotsocp_dct_t_gather(const void* x, void* y, const void* At,
                         const void* src, int64_t L, int T, int TP,
                         int64_t S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || T < 1 || S < 1 || TP < T || TP % kRows != 0)
    return (int)cudaErrorInvalidValue;
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float* ap = static_cast<const float*>(At);
  const int* sp = static_cast<const int*>(src);
  const size_t shared_a = (size_t)T * (TP + kTile) * sizeof(float);
  if (shared_a <= (size_t)optin)
    return (int)launch_t_gather<true>(xp, yp, ap, sp, L, T, TP, S, kTile,
                                      shared_a, st);
  int tile = kTile;
  while (tile > 32 && (size_t)T * tile * sizeof(float) > (size_t)optin)
    tile /= 2;
  const size_t smem = (size_t)T * tile * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)launch_t_gather<false>(xp, yp, ap, sp, L, T, TP, S, tile,
                                     smem, st);
}

}  // extern "C"
