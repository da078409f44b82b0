// Hand-written Hopper (sm_90a) kernels for the x-carry segment of the
// inPALM / ALG2 step: the three post-DCT passes of every iteration.
//
//   x_step   x  = Pi_K(BF_d q - beta) + beta              (segment prologue)
//   qx_step  q' = (D grad phi + alpha + s_bf BF^T x) * diag^-1,
//            alpha' = alpha + tau (D grad phi - q')
//            weighted (WEIGHTED, the obstacle problems):
//            q' = (w (D grad phi + alpha) + s_bf BF^T x) * diag^-1,
//            alpha' = alpha + tau (D grad phi - w q'), diag = base + w w
//   cx_step  z = x - beta; beta' = beta + tau (z - BF_d q');
//            x' = Pi_K(BF_d q' - beta') + beta'           (FINAL: x' = z)
//
// They replace the Pallas kernels x_kernel, qx_kernel and make_cx_kernel of
// dotsocp_tpu/ops/pallas_kernels.py (make_fused_flat_step) and follow the
// operation order of those bodies, so each agrees with its plain PyTorch
// version (dotsocp_tpu_torch/ops/fused_step.py) to a few ulp; FMA
// contraction is left on, except in the weighted q-step (see qx_kernel).
//
// Layout (flat, f32, contiguous): phi (nt, S); q0, alpha0 (nt-1, S); face
// blocks bs, alpha_b (d, nt, S) with the ghost slot of each axis pinned to
// zero; cone arrays beta, x (C, nt-1, S) with C = 2 + 4d. A spatial shift by
// one cell along axis a is a flat shift by k_a = stride_a with zero fill.
//
// Design: one thread per (row, s) element, s fastest, so every load and
// store of a warp is one coalesced transaction per array plane. Each kernel
// is one streaming pass bounded by HBM bandwidth (bytes at 513^2 x 65:
// x_step 1.55 GB, qx_step 1.35 GB (weighted 1.56 GB), cx_step 2.90 GB).
// Offsets are 64-bit:
// C (nt-1) S passes 2^31 on the larger grids. Tiling through shared memory,
// TMA, and merging cx with the next qx are left for later work.
//
// Every entry point launches on the given stream, synchronises nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.707106781186547524400844362104849039f;

// Lorentz-cone projection of v (C entries, head first), branch-free as in
// dotsocp_tpu/ops/cone.py:proj_soc. Returns head and the tail factor coef.
template <int C>
__device__ __forceinline__ void project(const float (&v)[C], float& head,
                                        float& coef) {
  float nrm2 = v[1] * v[1];
#pragma unroll
  for (int c = 2; c < C; ++c) nrm2 = nrm2 + v[c] * v[c];
  const float nrm = sqrtf(nrm2);
  const float safe = nrm > 0.f ? nrm : 1.f;
  coef = fminf(fmaxf(0.5f * (1.f + v[0] / safe), 0.f), 1.f);
  head = fmaxf(v[0], coef * nrm);
}

// The C columns of BF_d q at cell (t, s), without any beta term:
// col 0 = sd - sbf q0; per axis a the faces (t_lo, x_lo), (t_lo, x_hi),
// (t_hi, x_lo), (t_hi, x_hi) times sbf/sqrt2; col C-1 = sd + sbf q0.
// x_lo is the forward shift bs[a][row][s - k_a], zero when s < k_a.
template <int DIM>
__device__ __forceinline__ void bfd_cols(
    float (&col)[2 + 4 * DIM], const float* __restrict__ q0,
    const float* __restrict__ bs, int nt, int S, const int (&k)[DIM], int t,
    int s, float sbf, float sd) {
  constexpr int C = 2 + 4 * DIM;
  const float sv = sbf * kInvSqrt2;
  const int64_t cell = (int64_t)t * S + s;
  const float q = q0[cell];
  col[0] = sd - sbf * q;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float* b = bs + (int64_t)a * nt * S;
    const int64_t lo = cell;      // face row t
    const int64_t hi = cell + S;  // face row t + 1
    const bool has = s >= k[a];
    const int c = 1 + 4 * a;
    col[c] = sv * (has ? b[lo - k[a]] : 0.f);
    col[c + 1] = sv * b[lo];
    col[c + 2] = sv * (has ? b[hi - k[a]] : 0.f);
    col[c + 3] = sv * b[hi];
  }
  col[C - 1] = sd + sbf * q;
}

// x = Pi_K(BF_d q - beta) + beta; one thread per cell (t < nt-1, s).
// Writes only x, which no thread reads.
template <int DIM>
__global__ void x_kernel(const float* __restrict__ q0,
                         const float* __restrict__ bs,
                         const float* __restrict__ beta, float* __restrict__ x,
                         int nt, int S, int k0, int k1, float sbf, float sd) {
  constexpr int C = 2 + 4 * DIM;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (s >= S) return;
  int ks[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) ks[a] = a == 0 ? k0 : k1;
  const int64_t plane = (int64_t)(nt - 1) * S;
  const int64_t cell = (int64_t)t * S + s;
  float col[C];
  bfd_cols<DIM>(col, q0, bs, nt, S, ks, t, s, sbf, sd);
  float bt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bt[c] = beta[c * plane + cell];
    col[c] = col[c] - bt[c];
  }
  float head, coef;
  project<C>(col, head, coef);
  x[cell] = head + bt[0];
#pragma unroll
  for (int c = 1; c < C; ++c) x[c * plane + cell] = coef * col[c] + bt[c];
}

// The weighted q-step's update of one element, in the operation order of
// the plain version (w (tmp + al) + q2) * dinv and al + tau (tmp - w q'),
// with dinv = 1 / (base + w w) formed here from w. Every product and sum is
// rounded on its own (__f*_rn, never contracted into an FMA): at a wall
// w = 1e6, w q' cancels tmp + al down to alpha's size, so one rounding
// more or less there moves alpha' by ulps of tmp, more than the 2e-6 the
// kernel is held to against its plain version.
__device__ __forceinline__ float weighted_update(float tmp, float al, float q2,
                                                 float w, float base,
                                                 float tau, float& al_out) {
  const float dinv = __fdiv_rn(1.f, __fadd_rn(base, __fmul_rn(w, w)));
  const float qn =
      __fmul_rn(__fadd_rn(__fmul_rn(w, tmp + al), q2), dinv);
  al_out = __fadd_rn(al, __fmul_rn(tau, __fsub_rn(tmp, __fmul_rn(w, qn))));
  return qn;
}

// q-step + alpha multiplier from the carried x; one thread per node
// (t <= nt-1, s). alpha0 / alpha_b are updated in place: each thread reads
// them only at its own position. x and phi are read at shifted positions
// and are never written here; q0n / bsn are fresh outputs. Unweighted,
// (diag_in, diag_bd) are the interior and boundary-slab values of diag^-1;
// WEIGHTED, they are those of base (the diagonal of (E/D)^2 F*B*BF), and
// w0 (cells) and wb (faces, ghost slots 1) are read once each, at the
// thread's own position. Ghost face slots come out exactly zero either way:
// tmp, q2 and alpha are zero there. WEIGHTED also forms the face term
// s_bf BF^T x exactly as the plain version does: the four columns summed
// left to right and s_bf / sqrt2 as the host rounds it (sv_host), so the
// weighted kernel and its plain version round alike everywhere.
template <int DIM, bool WEIGHTED>
__global__ void qx_kernel(const float* __restrict__ phi,
                          const float* __restrict__ x, float* __restrict__ a0,
                          float* __restrict__ ab, float* __restrict__ q0n,
                          float* __restrict__ bsn,
                          const float* __restrict__ w0,
                          const float* __restrict__ wb, int nt, int S, int k0,
                          int k1, int n0, int n1, float D, float sbf,
                          float tau, float ht, float hs0, float hs1,
                          float diag_in, float diag_bd, float sv_host) {
  constexpr int C = 2 + 4 * DIM;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (s >= S) return;
  const int last = nt - 1;
  const int64_t plane = (int64_t)last * S;
  const int64_t node = (int64_t)t * S + s;
  const float sv = WEIGHTED ? sv_host : sbf * kInvSqrt2;
  const float p = phi[node];
  if (t < last) {
    // node (t, s) and cell (t, s) share the flat offset
    const float tmp = D * ((phi[node + S] - p) / ht);
    const float q2 = sbf * (x[(C - 1) * plane + node] - x[node]);
    const float al = a0[node];
    if (WEIGHTED) {
      float al_out;
      q0n[node] = weighted_update(tmp, al, q2, w0[node], diag_in, tau, al_out);
      a0[node] = al_out;
    } else {
      const float qn = (tmp + al + q2) * diag_in;
      q0n[node] = qn;
      a0[node] = al + tau * (tmp - qn);
    }
  }
  const float diag_b = (t == 0 || t == last) ? diag_bd : diag_in;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const int k = a == 0 ? k0 : k1;
    const int n = a == 0 ? n0 : n1;
    const float hs = a == 0 ? hs0 : hs1;
    const float m = ((s / k) % n) != n - 1 ? 1.f : 0.f;  // ghost mask
    const bool in = s + k < S;                           // backward shift
    const float ps = in ? phi[node + k] : 0.f;
    const float tmp = D * (((ps - p) / hs) * m);
    const int c0 = 1 + 4 * a;
    // zero-padded time concatenation of the x_lo / x_hi column pairs
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
    if (t < last) {
      const int64_t cell = node;
      y0 = in ? x[c0 * plane + cell + k] : 0.f;
      y1 = x[(c0 + 1) * plane + cell];
    }
    if (t >= 1) {
      const int64_t cell = node - S;
      y2 = in ? x[(c0 + 2) * plane + cell + k] : 0.f;
      y3 = x[(c0 + 3) * plane + cell];
    }
    const float acc = WEIGHTED ? ((y0 + y1) + y2) + y3 : (y0 + y1) + (y2 + y3);
    const float q2 = (sv * acc) * m;
    const int64_t face = (int64_t)a * nt * S + node;
    const float al = ab[face];
    if (WEIGHTED) {
      float al_out;
      bsn[face] = weighted_update(tmp, al, q2, wb[face], diag_b, tau, al_out);
      ab[face] = al_out;
    } else {
      const float bn = (tmp + al + q2) * diag_b;
      bsn[face] = bn;
      ab[face] = al + tau * (tmp - bn);
    }
  }
}

// beta multiplier fused with the next z-step; one thread per cell
// (t < nt-1, s). beta and x are updated in place: each thread reads them
// only at its own position, before it writes. q0n / bsn (read at shifted
// positions) are never written here.
template <int DIM, bool FINAL>
__global__ void cx_kernel(const float* __restrict__ q0n,
                          const float* __restrict__ bsn,
                          float* __restrict__ beta, float* __restrict__ x,
                          int nt, int S, int k0, int k1, float sbf, float sd,
                          float tau) {
  constexpr int C = 2 + 4 * DIM;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (s >= S) return;
  int ks[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) ks[a] = a == 0 ? k0 : k1;
  const int64_t plane = (int64_t)(nt - 1) * S;
  const int64_t cell = (int64_t)t * S + s;
  float col[C];
  bfd_cols<DIM>(col, q0n, bsn, nt, S, ks, t, s, sbf, sd);
  float zs[C], br[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float b = beta[c * plane + cell];
    zs[c] = x[c * plane + cell] - b;  // the stale z of this iteration
    br[c] = b + tau * (zs[c] - col[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) beta[c * plane + cell] = br[c];
  if (FINAL) {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c * plane + cell] = zs[c];
    return;
  }
  float zc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) zc[c] = col[c] - br[c];
  float head, coef;
  project<C>(zc, head, coef);
  x[cell] = head + br[0];
#pragma unroll
  for (int c = 1; c < C; ++c) x[c * plane + cell] = coef * zc[c] + br[c];
}

inline dim3 grid_for(int S, int rows) {
  return dim3((unsigned)((S + kThreads - 1) / kThreads), (unsigned)rows);
}

template <bool WEIGHTED>
int launch_qx(const float* phi, const float* x, float* a0, float* ab,
              float* q0n, float* bsn, const float* w0, const float* wb,
              int dim, int nt, int S, int k0, int k1, int n0, int n1, float D,
              float sbf, float tau, float ht, float hs0, float hs1,
              float diag_in, float diag_bd, float sv_host, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(S, nt);
  if (dim == 1) {
    qx_kernel<1, WEIGHTED><<<grid, kThreads, 0, st>>>(
        phi, x, a0, ab, q0n, bsn, w0, wb, nt, S, k0, k1, n0, n1, D, sbf, tau,
        ht, hs0, hs1, diag_in, diag_bd, sv_host);
  } else if (dim == 2) {
    qx_kernel<2, WEIGHTED><<<grid, kThreads, 0, st>>>(
        phi, x, a0, ab, q0n, bsn, w0, wb, nt, S, k0, k1, n0, n1, D, sbf, tau,
        ht, hs0, hs1, diag_in, diag_bd, sv_host);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dotsocp_x_step(const float* q0, const float* bs, const float* beta,
                   float* x, int dim, int nt, int S, int k0, int k1, float sbf,
                   float sd, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(S, nt - 1);
  if (dim == 1) {
    x_kernel<1><<<grid, kThreads, 0, st>>>(q0, bs, beta, x, nt, S, k0, k1,
                                           sbf, sd);
  } else if (dim == 2) {
    x_kernel<2><<<grid, kThreads, 0, st>>>(q0, bs, beta, x, nt, S, k0, k1,
                                           sbf, sd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dotsocp_qx_step(const float* phi, const float* x, float* a0, float* ab,
                    float* q0n, float* bsn, int dim, int nt, int S, int k0,
                    int k1, int n0, int n1, float D, float sbf, float tau,
                    float ht, float hs0, float hs1, float dinv_in,
                    float dinv_bd, void* stream) {
  return launch_qx<false>(phi, x, a0, ab, q0n, bsn, nullptr, nullptr, dim, nt,
                          S, k0, k1, n0, n1, D, sbf, tau, ht, hs0, hs1,
                          dinv_in, dinv_bd, 0.f, stream);
}

// The weighted q-step: w0 (nt-1, S) and wb (d, nt, S) the flat weight,
// (base_in, base_bd) the values of the diagonal of (E/D)^2 F*B*BF, sv the
// host's s_bf / sqrt2.
int dotsocp_qx_step_w(const float* phi, const float* x, float* a0, float* ab,
                      float* q0n, float* bsn, const float* w0, const float* wb,
                      int dim, int nt, int S, int k0, int k1, int n0, int n1,
                      float D, float sbf, float tau, float ht, float hs0,
                      float hs1, float base_in, float base_bd, float sv,
                      void* stream) {
  return launch_qx<true>(phi, x, a0, ab, q0n, bsn, w0, wb, dim, nt, S, k0, k1,
                         n0, n1, D, sbf, tau, ht, hs0, hs1, base_in, base_bd,
                         sv, stream);
}

int dotsocp_cx_step(const float* q0n, const float* bsn, float* beta, float* x,
                    int dim, int nt, int S, int k0, int k1, float sbf,
                    float sd, float tau, int final_step, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(S, nt - 1);
  if (dim == 1 && !final_step) {
    cx_kernel<1, false><<<grid, kThreads, 0, st>>>(q0n, bsn, beta, x, nt, S,
                                                   k0, k1, sbf, sd, tau);
  } else if (dim == 1) {
    cx_kernel<1, true><<<grid, kThreads, 0, st>>>(q0n, bsn, beta, x, nt, S,
                                                  k0, k1, sbf, sd, tau);
  } else if (dim == 2 && !final_step) {
    cx_kernel<2, false><<<grid, kThreads, 0, st>>>(q0n, bsn, beta, x, nt, S,
                                                   k0, k1, sbf, sd, tau);
  } else if (dim == 2) {
    cx_kernel<2, true><<<grid, kThreads, 0, st>>>(q0n, bsn, beta, x, nt, S,
                                                  k0, k1, sbf, sd, tau);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
