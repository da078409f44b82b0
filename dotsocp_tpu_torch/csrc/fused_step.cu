// Hand-written Hopper (sm_90a) kernels for the post-DCT passes of the
// inPALM / ALG2 step: the x-carry segment's three, and the single step's
// three (the sGS-inPALM step after its sweep too), and the cone projection
// that closes every acc-ADMM step.
//
//   x_step   x  = Pi_K(BF_d q - beta) + beta              (segment prologue)
//   qx_step  q' = (D grad phi + alpha + s_bf BF^T x) * diag^-1,
//            alpha' = alpha + tau (D grad phi - q')
//            weighted (WEIGHTED, the obstacle problems):
//            q' = (w (D grad phi + alpha) + s_bf BF^T x) * diag^-1,
//            alpha' = alpha + tau (D grad phi - w q'), diag = base + w w
//   cx_step  z = x - beta; beta' = beta + tau (z - BF_d q');
//            x' = Pi_K(BF_d q' - beta') + beta'           (FINAL: x' = z)
//   z_step   z  = Pi_K(BF_d q - beta)                      (single step)
//   q_step   the q-step of qx_step with x = z + beta formed per element
//   beta_step  beta' = beta + tau (z - BF_d q')
//   cone_project_diff  z = Pi_K(z2 - beta) over a flat (C, M) view
//   phi_rhs  rhs = D A^T (w q - alpha) + c    (the phi-step's right-hand side)
//   kkt_sums the KKT battery's sums of squares and inner products, one pass
//            (kkt_kernel) and a one-block reduction (kkt_finish)
//
// They replace the Pallas kernels x_kernel, qx_kernel, make_cx_kernel,
// z_kernel, q_kernel and b_kernel of dotsocp_tpu/ops/pallas_kernels.py
// (make_fused_flat_step) and the kernel of cone_project_diff_pallas, and
// follow the operation order of those bodies, so each agrees with its plain
// PyTorch version (dotsocp_tpu_torch/ops/fused_step.py) to a few ulp; FMA
// contraction is left on, except in the weighted q-step (see qx_kernel) and
// the cone projection (see cone_kernel), which round as their plain
// versions do. phi_rhs (rhs_kernel) replaces no Pallas kernel: the JAX
// package leaves the expression to one XLA fusion, which PyTorch runs as
// ~20 small kernels (pads, differences, scalings) every iteration; it too
// rounds as its plain version does. Nor does kkt_sums, the battery every
// KKT check forms (see kkt_kernel).
//
// Layout (flat, f32, contiguous): phi (nt, S); q0, alpha0 (nt-1, S); face
// blocks bs, alpha_b (d, nt, S) with the ghost slot of each axis pinned to
// zero; cone arrays beta, x, z (C, nt-1, S) with C = 2 + 4d, d = 1, 2 or 3
// (C = 6, 10, 14). A spatial shift by one cell along axis a is a flat shift
// by k_a = stride_a with zero fill. Each kernel takes the stride, size and
// spacing of each of its DIM axes in an Axes<DIM> struct and reads axis a's
// own: a grid with a different size on each axis is what the checks run on.
//
// Design: one thread per (row, s) element, s fastest, so every load and
// store of a warp is one coalesced transaction per array plane. Each kernel
// is one streaming pass bounded by HBM bandwidth (bytes at 513^2 x 65:
// x_step 1.55 GB, qx_step 1.35 GB (weighted 1.56 GB), cx_step 2.90 GB,
// z_step 1.55 GB, q_step 2.03 GB (weighted 2.23 GB), beta_step 2.23 GB,
// cone_project_diff 2.02 GB, phi_rhs 0.545 GB (weighted 0.750 GB); at
// 129^3 x 33, d = 3: x_step 8.8 GB, cx_step 16.5 GB). Offsets are 64-bit:
// C (nt-1) S passes 2^31 on the larger grids. At C = 14 a cx thread keeps
// up to four C-arrays live (56 floats); the compiler's register report
// (``-Xptxas -v``) says whether any spill. Tiling through shared memory,
// TMA, and merging passes are left for later work.
//
// In place or fresh: the x-carry kernels update alpha (qx), beta and x (cx)
// in the buffers they were given; the single-step kernels (z, q, beta,
// cone) write only fresh outputs, so the caller's state survives the step
// (the acc-ADMM anchors hold the very tensors of the state). Either way a
// thread reads an array it writes only at its own position, before writing.
//
// Batched forms (the lockstep fleet of dotsocp_tpu_torch/parallel/batch.py,
// TPU kernels 7-10 under the JAX package's jax.vmap): x_step, qx_step,
// cx_step and cx_final take B instances in one launch over contiguous
// (B, ...) fields, blockIdx.z the instance (B <= 65535), each instance's
// arrays at its own base offset. sd = E / dScale is read per instance from
// a (B,) float32 array on the card (sd_at[b]: each instance rescales on its
// own); sbf, D, tau and the q-step diagonal are the level's, shared by the
// fleet. A (B,) byte mask ``active`` is read first: the blocks of an
// instance whose byte is 0 return at once, so a converged instance's slots
// are left untouched. The single-instance entries are the same templates
// with gridDim.z = 1 and no mask (instance 0, offset 0: the arithmetic is
// unchanged).
//
// Scalars from device memory (the ``*_dev`` entries, the device driver of
// dotsocp_tpu_torch/algorithms/device_driver.py): a captured CUDA graph
// replays a kernel with the arguments it was captured with, and the device
// driver's graphs outlive one problem. So every launch scalar that changes
// with the problem or the iterate is read from a float32 on the card
// (struct FromMemory): sd = E / dScale, and the E-derived sbf = E / D, the
// host's s_bf / sqrt2 (sv) and the q-step's two diagonal values. The values
// are the ones the by-value entries take, so the arithmetic is unchanged.
//
// Every entry point launches on the given stream, synchronises nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.707106781186547524400844362104849039f;

// Flat stride k, size n and spacing hs of each of the DIM space axes (last
// axis fastest), passed by value and sized by DIM, so a 1D or 2D kernel's
// parameters hold only the axes it has.
template <int DIM>
struct Axes {
  int k[DIM];
  int n[DIM];
  float hs[DIM];
};

// The three axes as the entry points receive them; a d < 3 call passes
// k 0, n 1, hs 1 for the axes it lacks, which axes_for drops.
struct AxesIn {
  int k[3];
  int n[3];
  float hs[3];
};

// The launch scalars a kernel reads from device memory instead of its
// by-value arguments; a null pointer keeps the argument. sd is a (B,) array
// (one value an instance), the others one float each.
struct FromMemory {
  const float* sd;
  const float* sbf;
  const float* sv;
  const float* d_in;
  const float* d_bd;
};

template <int DIM>
inline Axes<DIM> axes_for(const AxesIn& in) {
  Axes<DIM> ax;
  for (int a = 0; a < DIM; ++a) {
    ax.k[a] = in.k[a];
    ax.n[a] = in.n[a];
    ax.hs[a] = in.hs[a];
  }
  return ax;
}

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
    const float* __restrict__ bs, int nt, int S, const Axes<DIM>& ax, int t,
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
    const int k = ax.k[a];
    const bool has = s >= k;
    const int c = 1 + 4 * a;
    col[c] = sv * (has ? b[lo - k] : 0.f);
    col[c + 1] = sv * b[lo];
    col[c + 2] = sv * (has ? b[hi - k] : 0.f);
    col[c + 3] = sv * b[hi];
  }
  col[C - 1] = sd + sbf * q;
}

// x = Pi_K(BF_d q - beta) + beta (PLUS_BETA, the x_step), or the z-step's
// z = Pi_K(BF_d q - beta); one thread per cell (t < nt-1, s). Writes only
// x, which no thread reads.
template <int DIM, bool PLUS_BETA>
__global__ void x_kernel(const float* __restrict__ q0,
                         const float* __restrict__ bs,
                         const float* __restrict__ beta, float* __restrict__ x,
                         int nt, int S, const Axes<DIM> ax, float sbf,
                         float sd, const FromMemory mem,
                         const uint8_t* __restrict__ active) {
  constexpr int C = 2 + 4 * DIM;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (s >= S || (active != nullptr && !active[b])) return;
  const int64_t plane = (int64_t)(nt - 1) * S;
  const int64_t cell = (int64_t)t * S + s;
  q0 += b * plane;
  bs += b * (DIM * (int64_t)nt * S);
  beta += b * (C * plane);
  x += b * (C * plane);
  if (mem.sbf) sbf = *mem.sbf;
  float col[C];
  bfd_cols<DIM>(col, q0, bs, nt, S, ax, t, s, sbf, mem.sd ? mem.sd[b] : sd);
  float bt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bt[c] = beta[c * plane + cell];
    col[c] = col[c] - bt[c];
  }
  float head, coef;
  project<C>(col, head, coef);
  x[cell] = PLUS_BETA ? head + bt[0] : head;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    x[c * plane + cell] = PLUS_BETA ? coef * col[c] + bt[c] : coef * col[c];
  }
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

// The unweighted q-step's update of one element, rounded as its plain
// version rounds it: (tmp + al + q2) * dinv and al + tau (tmp - q'), every
// operation on its own (no FMA). The 3D kernels take it: there D grad phi
// is large against alpha (|D dphi / hs| ~ 30 at 129^3 x 33, ~4 at
// 513^2 x 65), and where alpha' cancels, an FMA-contracted update misses
// the plain one by more than the 2e-6 the kernel is held to.
__device__ __forceinline__ float exact_update(float tmp, float al, float q2,
                                              float dinv, float tau,
                                              float& al_out) {
  const float qn = __fmul_rn(__fadd_rn(__fadd_rn(tmp, al), q2), dinv);
  al_out = __fadd_rn(al, __fmul_rn(tau, __fsub_rn(tmp, qn)));
  return qn;
}

// The q-step's read of x = z + beta at flat offset i of the cone array:
// the carried x itself, or (SPLIT, the single step) z and beta read apart
// and summed per element. A shift only relocates, so this is bit-equal to
// shifting the sum, as the plain version does, and to shifting z and beta
// apart and summing, as the Pallas q_kernel does.
template <bool SPLIT>
__device__ __forceinline__ float xval(const float* __restrict__ x,
                                      const float* __restrict__ beta,
                                      int64_t i) {
  return SPLIT ? x[i] + beta[i] : x[i];
}

// q-step + alpha multiplier; one thread per node (t <= nt-1, s). x holds
// the carried x (qx_step), or z with beta beside it (SPLIT, q_step). alpha'
// goes to (a0n, abn): alpha's own buffers for qx_step (in place: each
// thread reads alpha only at its own position, before writing), fresh ones
// for q_step. x, beta and phi are read at shifted positions and are never
// written here; q0n / bsn are fresh outputs. Unweighted,
// (diag_in, diag_bd) are the interior and boundary-slab values of diag^-1;
// WEIGHTED, they are those of base (the diagonal of (E/D)^2 F*B*BF), and
// w0 (cells) and wb (faces, ghost slots 1) are read once each, at the
// thread's own position. Ghost face slots come out exactly zero either way:
// tmp, q2 and alpha are zero there. EXACT (WEIGHTED, or DIM = 3) forms the
// face term s_bf BF^T x exactly as the plain version does: the four
// columns summed left to right and s_bf / sqrt2 as the host rounds it
// (sv_host); with weighted_update or exact_update the kernel and its plain
// version then round alike everywhere. The 1D and 2D unweighted kernels
// keep the Pallas association and FMA contraction. Batched (blockIdx.z the
// instance, unweighted only), every array but the weight is the instance's.
template <int DIM, bool WEIGHTED, bool SPLIT>
__global__ void qx_kernel(const float* __restrict__ phi,
                          const float* __restrict__ x,
                          const float* __restrict__ beta, const float* a0,
                          const float* ab, float* a0n, float* abn,
                          float* __restrict__ q0n, float* __restrict__ bsn,
                          const float* __restrict__ w0,
                          const float* __restrict__ wb, int nt, int S,
                          const Axes<DIM> ax, float D, float sbf, float tau,
                          float ht, float diag_in, float diag_bd,
                          float sv_host, const FromMemory mem,
                          const uint8_t* __restrict__ active) {
  constexpr int C = 2 + 4 * DIM;
  constexpr bool EXACT = WEIGHTED || DIM == 3;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (s >= S || (active != nullptr && !active[b])) return;
  const int last = nt - 1;
  const int64_t plane = (int64_t)last * S;
  const int64_t node = (int64_t)t * S + s;
  {
    const int64_t nodes = (int64_t)nt * S;
    const int64_t faces = DIM * nodes;
    phi += b * nodes;
    x += b * (C * plane);
    if (SPLIT) beta += b * (C * plane);
    a0 += b * plane;
    a0n += b * plane;
    q0n += b * plane;
    ab += b * faces;
    abn += b * faces;
    bsn += b * faces;
  }
  if (mem.sbf) {
    sbf = *mem.sbf;
    sv_host = *mem.sv;
    diag_in = *mem.d_in;
    diag_bd = *mem.d_bd;
  }
  const float sv = EXACT ? sv_host : sbf * kInvSqrt2;
  const float p = phi[node];
  if (t < last) {
    // node (t, s) and cell (t, s) share the flat offset
    const float tmp = D * ((phi[node + S] - p) / ht);
    const float q2 = sbf * (xval<SPLIT>(x, beta, (C - 1) * plane + node) -
                            xval<SPLIT>(x, beta, node));
    const float al = a0[node];
    if (WEIGHTED) {
      float al_out;
      q0n[node] = weighted_update(tmp, al, q2, w0[node], diag_in, tau, al_out);
      a0n[node] = al_out;
    } else if (EXACT) {
      float al_out;
      q0n[node] = exact_update(tmp, al, q2, diag_in, tau, al_out);
      a0n[node] = al_out;
    } else {
      const float qn = (tmp + al + q2) * diag_in;
      q0n[node] = qn;
      a0n[node] = al + tau * (tmp - qn);
    }
  }
  const float diag_b = (t == 0 || t == last) ? diag_bd : diag_in;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const int k = ax.k[a];
    const int n = ax.n[a];
    const float hs = ax.hs[a];
    const float m = ((s / k) % n) != n - 1 ? 1.f : 0.f;  // ghost mask
    const bool in = s + k < S;                           // backward shift
    const float ps = in ? phi[node + k] : 0.f;
    const float tmp = D * (((ps - p) / hs) * m);
    const int c0 = 1 + 4 * a;
    // zero-padded time concatenation of the x_lo / x_hi column pairs
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
    if (t < last) {
      const int64_t cell = node;
      y0 = in ? xval<SPLIT>(x, beta, c0 * plane + cell + k) : 0.f;
      y1 = xval<SPLIT>(x, beta, (c0 + 1) * plane + cell);
    }
    if (t >= 1) {
      const int64_t cell = node - S;
      y2 = in ? xval<SPLIT>(x, beta, (c0 + 2) * plane + cell + k) : 0.f;
      y3 = xval<SPLIT>(x, beta, (c0 + 3) * plane + cell);
    }
    const float acc = EXACT ? ((y0 + y1) + y2) + y3 : (y0 + y1) + (y2 + y3);
    const float q2 = (sv * acc) * m;
    const int64_t face = (int64_t)a * nt * S + node;
    const float al = ab[face];
    if (WEIGHTED) {
      float al_out;
      bsn[face] = weighted_update(tmp, al, q2, wb[face], diag_b, tau, al_out);
      abn[face] = al_out;
    } else if (EXACT) {
      float al_out;
      bsn[face] = exact_update(tmp, al, q2, diag_b, tau, al_out);
      abn[face] = al_out;
    } else {
      const float bn = (tmp + al + q2) * diag_b;
      bsn[face] = bn;
      abn[face] = al + tau * (tmp - bn);
    }
  }
}

// What cx_kernel computes: the beta multiplier fused with the next z-step
// (kCx), the segment's last multiplier step (kCxFinal), or the single
// step's beta multiplier alone from a given z (kBeta).
constexpr int kCx = 0;
constexpr int kCxFinal = 1;
constexpr int kBeta = 2;

// The beta multiplier; one thread per cell (t < nt-1, s). kCx / kCxFinal
// read z as x - beta from the carried x and update beta and x in place
// (beta_out == beta, x_out == x: each thread reads them only at its own
// position, before it writes); kBeta reads z itself from x and writes
// beta' alone to the fresh beta_out. q0n / bsn (read at shifted positions)
// are never written here.
template <int DIM, int MODE>
__global__ void cx_kernel(const float* __restrict__ q0n,
                          const float* __restrict__ bsn, const float* beta,
                          const float* x, float* beta_out, float* x_out,
                          int nt, int S, const Axes<DIM> ax, float sbf,
                          float sd, const FromMemory mem, float tau,
                          const uint8_t* __restrict__ active) {
  constexpr int C = 2 + 4 * DIM;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (s >= S || (active != nullptr && !active[b])) return;
  const int64_t plane = (int64_t)(nt - 1) * S;
  const int64_t cell = (int64_t)t * S + s;
  {
    const int64_t cone = C * plane;
    q0n += b * plane;
    bsn += b * (DIM * (int64_t)nt * S);
    beta += b * cone;
    x += b * cone;
    beta_out += b * cone;
    if (MODE != kBeta) x_out += b * cone;
  }
  if (mem.sbf) sbf = *mem.sbf;
  float col[C];
  bfd_cols<DIM>(col, q0n, bsn, nt, S, ax, t, s, sbf, mem.sd ? mem.sd[b] : sd);
  float zs[C], br[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float b = beta[c * plane + cell];
    // the z of this iteration: given, or the stale z from the carried x
    zs[c] = MODE == kBeta ? x[c * plane + cell] : x[c * plane + cell] - b;
    br[c] = b + tau * (zs[c] - col[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) beta_out[c * plane + cell] = br[c];
  if (MODE == kBeta) return;
  if (MODE == kCxFinal) {
#pragma unroll
    for (int c = 0; c < C; ++c) x_out[c * plane + cell] = zs[c];
    return;
  }
  float zc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) zc[c] = col[c] - br[c];
  float head, coef;
  project<C>(zc, head, coef);
  x_out[cell] = head + br[0];
#pragma unroll
  for (int c = 1; c < C; ++c) x_out[c * plane + cell] = coef * zc[c] + br[c];
}

// z = Pi_K(z2 - beta) on one column i of a flat (C, M) view; one thread per
// column. Every operation is rounded on its own (__f*_rn, never an FMA) and
// the squares are summed left to right, as the plain version
// cone_project_diff_plain does: the kernel is bit-equal to it. A C of the
// solver's cone (6, 10, 14) is a template argument and the column stays in
// registers; any other C (CT = 0) reads its column twice.
template <int CT>
__global__ void cone_kernel(const float* __restrict__ z2,
                            const float* __restrict__ beta,
                            float* __restrict__ z, int C_rt, int M) {
  const int C = CT > 0 ? CT : C_rt;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float v[CT > 0 ? CT : 1];
  float nrm2 = 0.f;
  float v0 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t at = c * (int64_t)M + i;
    const float vc = __fsub_rn(z2[at], beta[at]);
    if (CT > 0) v[c] = vc;
    if (c == 0) {
      v0 = vc;
    } else {
      const float sq = __fmul_rn(vc, vc);
      nrm2 = c == 1 ? sq : __fadd_rn(nrm2, sq);
    }
  }
  const float nrm = __fsqrt_rn(nrm2);
  const float safe = nrm > 0.f ? nrm : 1.f;
  const float coef = fminf(
      fmaxf(__fmul_rn(0.5f, __fadd_rn(1.f, __fdiv_rn(v0, safe))), 0.f), 1.f);
  z[i] = fmaxf(v0, __fmul_rn(coef, nrm));
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const int64_t at = c * (int64_t)M + i;
    const float vc = CT > 0 ? v[c] : __fsub_rn(z2[at], beta[at]);
    z[at] = __fmul_rn(coef, vc);
  }
}

// w q - alpha at flat offset i of a staggered block (w the weight's block,
// WEIGHTED only), each operation rounded on its own.
template <bool WEIGHTED>
__device__ __forceinline__ float wq_minus_alpha(const float* __restrict__ q,
                                                const float* __restrict__ al,
                                                const float* __restrict__ w,
                                                int64_t i) {
  return __fsub_rn(WEIGHTED ? __fmul_rn(w[i], q[i]) : q[i], al[i]);
}

// The phi-step's right-hand side rhs = D A^T (w q - alpha) + c; one thread
// per node (t <= nt-1, s), blockIdx.z the instance (every array but the
// weight is the instance's). A^T of the staggered y = w q - alpha is the
// time difference y0[t-1] - y0[t] (zero beyond either end, as the plain
// version's zero pads) times 1/h_t, plus, axis by axis, the forward shift
// yb_a[s - k_a] (zero for s < k_a) minus yb_a[s], times 1/h_a. Every
// operation is rounded on its own, in the plain version's order, and the
// spacings enter as the float32 reciprocals that PyTorch multiplies by
// when it divides a CUDA tensor by a Python float (ax.hs holds 1/h_a): the
// kernel is bit-equal to its plain version on the card. Writes only out.
template <int DIM, bool WEIGHTED>
__global__ void rhs_kernel(const float* __restrict__ q0,
                           const float* __restrict__ qb,
                           const float* __restrict__ a0,
                           const float* __restrict__ ab,
                           const float* __restrict__ c,
                           const float* __restrict__ w0,
                           const float* __restrict__ wb,
                           float* __restrict__ out, int nt, int S,
                           const Axes<DIM> ax, float D, float inv_ht) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (s >= S) return;
  const int64_t nodes = (int64_t)nt * S;
  const int64_t plane = nodes - S;
  const int64_t node = (int64_t)t * S + s;
  q0 += b * plane;
  a0 += b * plane;
  qb += b * (DIM * nodes);
  ab += b * (DIM * nodes);
  c += b * nodes;
  out += b * nodes;
  // node (t, s) and cell (t, s) share the flat offset
  const float lo = t >= 1 ? wq_minus_alpha<WEIGHTED>(q0, a0, w0, node - S)
                          : 0.f;
  const float hi = t < nt - 1 ? wq_minus_alpha<WEIGHTED>(q0, a0, w0, node)
                              : 0.f;
  float acc = __fmul_rn(__fsub_rn(lo, hi), inv_ht);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const int64_t face = (int64_t)a * nodes + node;
    const int k = ax.k[a];
    const float prev = s >= k ? wq_minus_alpha<WEIGHTED>(qb, ab, wb, face - k)
                              : 0.f;
    const float here = wq_minus_alpha<WEIGHTED>(qb, ab, wb, face);
    acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(prev, here), ax.hs[a]));
  }
  out[node] = __fadd_rn(__fmul_rn(D, acc), c[node]);
}

// -- the KKT battery's sums --------------------------------------------------
//
// kkt_kernel forms, in one pass over the state, every sum of squares and
// inner product that Kernels._kkt_parts_plain (algorithms/core.py) forms
// with ~300 PyTorch operations: the twelve sqsums of q, z, D grad phi,
// alpha, beta, s_bf BF^T beta, the residuals D grad phi - w q, z - BF_d q,
// D A^T alpha - c, s_bf BF^T beta + w alpha, z - Pi_K(z - sigma beta) and
// phi; <q, alpha> and <c, phi>; and the original-DOT complementarity sums of
// _dot_complement (rho_t - rho_fq, rho_t, rho_fq, and per space axis m_a,
// rho_b,a and m_a - rho_b,a). It replaces no Pallas kernel: the JAX package
// leaves the battery to XLA, which fuses it. Each element is formed in the
// plain version's operation order, every float32 operation rounded on its
// own (__f*_rn), the divisions by h as the float32 reciprocals PyTorch
// multiplies by; only the sums differ: each square or product is formed and
// accumulated in float64.
//
// Design: one thread per (t, s) node of a block's rows (s fastest, as the
// step kernels), each thread walking ``rows`` consecutive time rows, so a
// block re-reads its previous row's neighbours from L1. Stencil neighbours
// (t +- 1, s +- k_a) come through L1/L2; each input array is read from HBM
// about once (bytes at 513^2 x 65: 1.89 GB, the state phi, q, z, alpha,
// beta, c; weighted 2.11 GB). The rho node and face interpolations are
// linear in alpha.q0 (and w.q0), so they are formed from its neighbours and
// need no temporary field. Each block reduces its threads' sums (warp
// shuffles, then shared memory, in a fixed order) into one float64 row of
// ``partial``; kkt_finish, one block, adds the rows in a fixed order and
// writes the sums as float32. The grid depends only on (nt, S), so the sums
// are bit-identical from run to run and between eager launches and graph
// replays.

// The sums in the order of Kernels._kkt_parts_plain's keys; after kFace0,
// three per space axis a: m_a, rb_a, diff_a.
enum KktSum {
  kSumQ, kSumZ, kSumAphi, kSumAlpha, kSumBeta, kSumFbbeta, kSumPrim1,
  kSumPrim2, kSumDual1, kSumDual2, kSumComplem, kSumPhi, kSumPri, kSumDual,
  kSumDotcomplem, kSumRho, kSumRhoFq, kSumFace0
};

template <int DIM>
__host__ __device__ constexpr int kkt_count() {
  return kSumFace0 + 3 * DIM;
}

constexpr int kKktThreads = 256;
// the grid aims at about this many blocks: rows = ceil(sblocks nt / this)
constexpr int kKktBlocks = 1024;

// The state's scalars, each by value or, where its pointer is not null,
// from memory: sigma, cScale and dScale the 0-d tensors of the device
// driver's state (or of a fleet's instance), ev the device driver's
// E-derived vector (E, E/D, E/D/sqrt2, two diagonal values, 1/E:
// algorithms/core.EScalars). The products the battery scales by, sd = E /
// dScale, rs = sigma cScale D, dsd = dScale / D and dse = dScale / E, are
// formed here as PyTorch forms them from 0-d tensors where their operands
// are tensors, and come by value, formed in double on the host, where they
// are floats: either way as the plain version rounds them. D, 1/D and 1/h_t
// are the level's.
struct KktScalars {
  float sigma, cscale, e, sbf, sv, inv_e, sd, rs, dsd, dse, D, inv_D, inv_ht;
  const float* sigma_at;
  const float* cscale_at;
  const float* dscale_at;
  const float* ev_at;
};

__device__ __forceinline__ void add_sq(double& acc, float v) {
  acc += (double)v * (double)v;
}

// The block's sums of acc[i] over its threads, in a fixed order; thread i
// (i < NS) returns sum i. blockDim.x is kKktThreads.
template <int NS>
__device__ __forceinline__ double block_sum(double (&acc)[NS]) {
  __shared__ double part[kKktThreads / 32][NS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    double v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) part[warp][i] = v;
  }
  __syncthreads();
  double v = 0.0;
  if (threadIdx.x < NS) {
    for (int w = 0; w < kKktThreads / 32; ++w) v += part[w][threadIdx.x];
  }
  return v;
}

// rho_t = (sigma cScale D) (w alpha0) at cell (t, s); zero outside
// 0 <= t < nt - 1 (the zero-padded ends of the time-node interpolation).
template <bool W>
__device__ __forceinline__ float rho_t_at(const float* __restrict__ a0,
                                          const float* __restrict__ w0,
                                          int t, int last, int64_t cell,
                                          float rs) {
  if (t < 0 || t >= last) return 0.f;
  const float da = W ? __fmul_rn(w0[cell], a0[cell]) : a0[cell];
  return __fmul_rn(rs, da);
}

// One node's (t, s) contributions to every sum: the node terms (phi, c,
// D A^T alpha - c), the cell terms for t < nt - 1 (q0, alpha0, the cone
// columns, rho), and the face terms of each axis.
template <int DIM, bool W>
__device__ __forceinline__ void kkt_node(
    double (&acc)[kkt_count<DIM>()], const float* __restrict__ phi,
    const float* __restrict__ q0, const float* __restrict__ qb,
    const float* __restrict__ z, const float* __restrict__ a0,
    const float* __restrict__ ab, const float* __restrict__ beta,
    const float* __restrict__ c, const float* __restrict__ w0,
    const float* __restrict__ wb, int nt, int S, const Axes<DIM>& ax, int t,
    int s, float sigma, float sbf, float sv, float sd, float rs, float dsD,
    float dsE, const KktScalars& sc) {
  constexpr int C = 2 + 4 * DIM;
  const int last = nt - 1;
  const int64_t plane = (int64_t)last * S;
  const int64_t nodes = (int64_t)nt * S;
  const int64_t node = (int64_t)t * S + s;
  const float D = sc.D;

  // node terms
  const float p = phi[node];
  const float cn = c[node];
  add_sq(acc[kSumPhi], p);
  acc[kSumDual] += (double)cn * (double)p;
  {
    // D A^T alpha - c, as phi_rhs's plain version composes A^T
    const float lo = t >= 1 ? a0[node - S] : 0.f;
    const float hi = t < last ? a0[node] : 0.f;
    float g = __fmul_rn(__fsub_rn(lo, hi), sc.inv_ht);
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const int64_t face = (int64_t)a * nodes + node;
      const int k = ax.k[a];
      const float prev = s >= k ? ab[face - k] : 0.f;
      g = __fadd_rn(g, __fmul_rn(__fsub_rn(prev, ab[face]), ax.hs[a]));
    }
    add_sq(acc[kSumDual1], __fsub_rn(__fmul_rn(g, D), cn));
  }

  // cell terms: node (t, s) and cell (t, s) share the flat offset
  if (t < last) {
    const int64_t cell = node;
    const float q = q0[cell];
    const float al = a0[cell];
    const float wq = W ? __fmul_rn(w0[cell], q) : q;
    const float da = W ? __fmul_rn(w0[cell], al) : al;
    add_sq(acc[kSumQ], q);
    add_sq(acc[kSumAlpha], al);
    acc[kSumPri] += (double)q * (double)al;
    const float aphi =
        __fmul_rn(__fmul_rn(__fsub_rn(phi[node + S], p), sc.inv_ht), D);
    add_sq(acc[kSumAphi], aphi);
    add_sq(acc[kSumPrim1], __fsub_rn(aphi, wq));

    // z2 = BF_d q, column by column (ops/engine.OpsFlat.bfd), the cone
    // terms, and v = z - sigma beta for the projection
    const float sq = __fmul_rn(sbf, q);
    float zc[C], v[C];
    float b0 = 0.f, bl = 0.f, bsum = 0.f;
#pragma unroll
    for (int col = 0; col < C; ++col) {
      float z2;
      if (col == 0) {
        z2 = __fsub_rn(sd, sq);
      } else if (col == C - 1) {
        z2 = __fadd_rn(sd, sq);
      } else {
        const int a = (col - 1) / 4;
        const int j = (col - 1) % 4;       // t_lo x_lo, t_lo x_hi, t_hi ...
        const int k = ax.k[a];
        const int64_t row = cell + (j >= 2 ? S : 0);
        const float* b = qb + (int64_t)a * nodes;
        const float f = (j & 1) ? b[row] : (s >= k ? b[row - k] : 0.f);
        z2 = __fmul_rn(sv, f);
        const float u = __fmul_rn(dsE, z2);
        bsum = col == 1 ? __fmul_rn(u, u) : __fadd_rn(bsum, __fmul_rn(u, u));
      }
      const float zv = z[col * plane + cell];
      const float bv = beta[col * plane + cell];
      if (col == 0) b0 = bv;
      if (col == C - 1) bl = bv;
      add_sq(acc[kSumZ], zv);
      add_sq(acc[kSumBeta], bv);
      add_sq(acc[kSumPrim2], __fsub_rn(zv, z2));
      zc[col] = zv;
      v[col] = __fsub_rn(zv, __fmul_rn(sigma, bv));
    }
    // z - Pi_K(z - sigma beta) (ops/cone.proj_soc)
    {
      float nrm2 = __fmul_rn(v[1], v[1]);
#pragma unroll
      for (int col = 2; col < C; ++col) {
        nrm2 = __fadd_rn(nrm2, __fmul_rn(v[col], v[col]));
      }
      const float nrm = __fsqrt_rn(nrm2);
      const float safe = nrm > 0.f ? nrm : 1.f;
      const float coef = fminf(
          fmaxf(__fmul_rn(0.5f, __fadd_rn(1.f, __fdiv_rn(v[0], safe))), 0.f),
          1.f);
      add_sq(acc[kSumComplem],
             __fsub_rn(zc[0], fmaxf(v[0], __fmul_rn(coef, nrm))));
#pragma unroll
      for (int col = 1; col < C; ++col) {
        add_sq(acc[kSumComplem], __fsub_rn(zc[col], __fmul_rn(coef, v[col])));
      }
    }
    // s_bf BF^T beta at the cell (its q0 part) and + w alpha
    const float fb = __fmul_rn(sbf, __fsub_rn(bl, b0));
    add_sq(acc[kSumFbbeta], fb);
    add_sq(acc[kSumDual2], __fadd_rn(fb, da));
    // rho_t and rho_fq (_dot_complement)
    const float rt = __fmul_rn(rs, da);
    float rf = __fadd_rn(__fadd_rn(rt, __fmul_rn(dsD, q)),
                         __fmul_rn(bsum, 0.25f));
    rf = rf < 0.f ? 0.f : rf;  // torch.clamp(min=0): NaN stays NaN
    add_sq(acc[kSumDotcomplem], __fsub_rn(rt, rf));
    add_sq(acc[kSumRho], rt);
    add_sq(acc[kSumRhoFq], rf);
  }

  // face terms of each axis (every node row, ghost slots included)
  const float rn = __fmul_rn(0.5f, __fadd_rn(rho_t_at<W>(a0, w0, t - 1, last,
                                                         node - S, rs),
                                             rho_t_at<W>(a0, w0, t, last,
                                                         node, rs)));
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const int k = ax.k[a];
    const int n = ax.n[a];
    const float m = ((s / k) % n) != n - 1 ? 1.f : 0.f;  // ghost mask
    const bool in = s + k < S;                           // backward shift
    const int64_t face = (int64_t)a * nodes + node;
    const float qv = qb[face];
    const float av = ab[face];
    const float wv = W ? wb[face] : 1.f;
    add_sq(acc[kSumQ], qv);
    add_sq(acc[kSumAlpha], av);
    acc[kSumPri] += (double)qv * (double)av;
    const float ps = in ? phi[node + k] : 0.f;
    const float aphi =
        __fmul_rn(__fmul_rn(__fmul_rn(__fsub_rn(ps, p), ax.hs[a]), m), D);
    add_sq(acc[kSumAphi], aphi);
    add_sq(acc[kSumPrim1], __fsub_rn(aphi, W ? __fmul_rn(wv, qv) : qv));
    // s_bf BF^T beta on the face: the zero-padded x_lo / x_hi column pairs
    // of ops/engine.OpsFlat.bfd_T, summed left to right
    const int c0 = 1 + 4 * a;
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
    if (t < last) {
      y0 = in ? beta[c0 * plane + node + k] : 0.f;
      y1 = beta[(c0 + 1) * plane + node];
    }
    if (t >= 1) {
      y2 = in ? beta[(c0 + 2) * plane + node - S + k] : 0.f;
      y3 = beta[(c0 + 3) * plane + node - S];
    }
    const float fb = __fmul_rn(
        __fmul_rn(sv, __fadd_rn(__fadd_rn(__fadd_rn(y0, y1), y2), y3)), m);
    const float dab = W ? __fmul_rn(wv, av) : av;
    add_sq(acc[kSumFbbeta], fb);
    add_sq(acc[kSumDual2], __fadd_rn(fb, dab));
    // rho on the face: the node value and its neighbour along a, times
    // (dScale / D) q; m_a = (sigma cScale D) w alpha
    float rnext = 0.f;
    if (in) {
      rnext = __fmul_rn(
          0.5f, __fadd_rn(rho_t_at<W>(a0, w0, t - 1, last, node - S + k, rs),
                          rho_t_at<W>(a0, w0, t, last, node + k, rs)));
    }
    const float rb = __fmul_rn(
        __fmul_rn(dsD, __fmul_rn(0.5f, __fadd_rn(rn, rnext))), qv);
    const float ma = __fmul_rn(rs, dab);
    add_sq(acc[kSumFace0 + 3 * a], ma);
    add_sq(acc[kSumFace0 + 3 * a + 1], rb);
    add_sq(acc[kSumFace0 + 3 * a + 2], __fsub_rn(ma, rb));
  }
}

// The sums of a block's nodes into its row of ``partial`` (kkt_count<DIM>
// doubles); grid (ceil(S / 256), ceil(nt / rows)), rows time rows a block.
template <int DIM, bool W>
__global__ void __launch_bounds__(kKktThreads)
kkt_kernel(const float* __restrict__ phi, const float* __restrict__ q0,
           const float* __restrict__ qb, const float* __restrict__ z,
           const float* __restrict__ a0, const float* __restrict__ ab,
           const float* __restrict__ beta, const float* __restrict__ c,
           const float* __restrict__ w0, const float* __restrict__ wb,
           double* __restrict__ partial, int nt, int S, int rows,
           const Axes<DIM> ax, const KktScalars sc) {
  constexpr int NS = kkt_count<DIM>();
  const float sigma = sc.sigma_at ? *sc.sigma_at : sc.sigma;
  float e = sc.e, sbf = sc.sbf, sv = sc.sv, inv_e = sc.inv_e;
  if (sc.ev_at) {
    e = sc.ev_at[0];
    sbf = sc.ev_at[1];
    sv = sc.ev_at[2];
    inv_e = sc.ev_at[5];
  }
  // from 0-d tensors PyTorch forms E / dScale as dScale's reciprocal times
  // E, and divides by the floats D and E as products with their float32
  // reciprocals
  float rs = sc.rs, sd = sc.sd, dsD = sc.dsd, dsE = sc.dse;
  if (sc.sigma_at || sc.cscale_at) {
    const float cscale = sc.cscale_at ? *sc.cscale_at : sc.cscale;
    rs = __fmul_rn(__fmul_rn(sigma, cscale), sc.D);
  }
  if (sc.dscale_at) {
    const float dscale = *sc.dscale_at;
    sd = __fmul_rn(__frcp_rn(dscale), e);
    dsD = __fmul_rn(dscale, sc.inv_D);
    dsE = __fmul_rn(dscale, inv_e);
  }
  double acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.0;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) {
    const int t0 = (int)blockIdx.y * rows;
    const int t1 = min(nt, t0 + rows);
    for (int t = t0; t < t1; ++t) {
      kkt_node<DIM, W>(acc, phi, q0, qb, z, a0, ab, beta, c, w0, wb, nt, S,
                       ax, t, s, sigma, sbf, sv, sd, rs, dsD, dsE, sc);
    }
  }
  const double v = block_sum<NS>(acc);
  if (threadIdx.x < NS) {
    partial[(int64_t)(blockIdx.y * gridDim.x + blockIdx.x) * NS +
            threadIdx.x] = v;
  }
}

// The blocks' rows of ``partial`` added in a fixed order; out[i] the sum i
// as a float32. One block of kKktThreads.
template <int NS>
__global__ void __launch_bounds__(kKktThreads)
kkt_finish(const double* __restrict__ partial, int blocks,
           float* __restrict__ out) {
  double acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[i] += partial[(int64_t)b * NS + i];
  }
  const double v = block_sum<NS>(acc);
  if (threadIdx.x < NS) out[threadIdx.x] = (float)v;
}

// The battery's grid: (blocks along s, blocks along t, rows a block).
inline void kkt_grid(int nt, int S, int& sblocks, int& tblocks, int& rows) {
  sblocks = (S + kKktThreads - 1) / kKktThreads;
  const int64_t want = ((int64_t)sblocks * nt + kKktBlocks - 1) / kKktBlocks;
  rows = (int)(want < 1 ? 1 : (want > nt ? nt : want));
  tblocks = (nt + rows - 1) / rows;
}

// (S / 256 blocks, rows, B instances)
inline dim3 grid_for(int S, int rows, int B = 1) {
  return dim3((unsigned)((S + kThreads - 1) / kThreads), (unsigned)rows,
              (unsigned)B);
}

constexpr int kMaxBatch = 65535;  // gridDim.z

inline AxesIn make_axes(int k0, int k1, int k2, int n0 = 1, int n1 = 1,
                        int n2 = 1, float hs0 = 1.f, float hs1 = 1.f,
                        float hs2 = 1.f) {
  return AxesIn{{k0, k1, k2}, {n0, n1, n2}, {hs0, hs1, hs2}};
}

template <bool PLUS_BETA>
int launch_x(const float* q0, const float* bs, const float* beta, float* x,
             int dim, int nt, int S, const AxesIn& ax, float sbf, float sd,
             const FromMemory& mem, void* stream, int B = 1,
             const uint8_t* active = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(S, nt - 1, B);
  switch (dim) {
    case 1:
      x_kernel<1, PLUS_BETA><<<grid, kThreads, 0, st>>>(
          q0, bs, beta, x, nt, S, axes_for<1>(ax), sbf, sd, mem, active);
      break;
    case 2:
      x_kernel<2, PLUS_BETA><<<grid, kThreads, 0, st>>>(
          q0, bs, beta, x, nt, S, axes_for<2>(ax), sbf, sd, mem, active);
      break;
    case 3:
      x_kernel<3, PLUS_BETA><<<grid, kThreads, 0, st>>>(
          q0, bs, beta, x, nt, S, axes_for<3>(ax), sbf, sd, mem, active);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool WEIGHTED, bool SPLIT>
int launch_qx(const float* phi, const float* x, const float* beta,
              const float* a0, const float* ab, float* a0n, float* abn,
              float* q0n, float* bsn, const float* w0, const float* wb,
              int dim, int nt, int S, const AxesIn& ax, float D, float sbf,
              float tau, float ht, float diag_in, float diag_bd,
              float sv_host, const FromMemory& mem, void* stream, int B = 1,
              const uint8_t* active = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(S, nt, B);
  switch (dim) {
    case 1:
      qx_kernel<1, WEIGHTED, SPLIT><<<grid, kThreads, 0, st>>>(
          phi, x, beta, a0, ab, a0n, abn, q0n, bsn, w0, wb, nt, S,
          axes_for<1>(ax), D, sbf, tau, ht, diag_in, diag_bd, sv_host, mem,
          active);
      break;
    case 2:
      qx_kernel<2, WEIGHTED, SPLIT><<<grid, kThreads, 0, st>>>(
          phi, x, beta, a0, ab, a0n, abn, q0n, bsn, w0, wb, nt, S,
          axes_for<2>(ax), D, sbf, tau, ht, diag_in, diag_bd, sv_host, mem,
          active);
      break;
    case 3:
      qx_kernel<3, WEIGHTED, SPLIT><<<grid, kThreads, 0, st>>>(
          phi, x, beta, a0, ab, a0n, abn, q0n, bsn, w0, wb, nt, S,
          axes_for<3>(ax), D, sbf, tau, ht, diag_in, diag_bd, sv_host, mem,
          active);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_cx(const float* q0n, const float* bsn, const float* beta,
              const float* x, float* beta_out, float* x_out, int dim, int nt,
              int S, const AxesIn& ax, float sbf, float sd,
              const FromMemory& mem, float tau, void* stream, int B = 1,
              const uint8_t* active = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(S, nt - 1, B);
  switch (dim) {
    case 1:
      cx_kernel<1, MODE><<<grid, kThreads, 0, st>>>(
          q0n, bsn, beta, x, beta_out, x_out, nt, S, axes_for<1>(ax), sbf, sd,
          mem, tau, active);
      break;
    case 2:
      cx_kernel<2, MODE><<<grid, kThreads, 0, st>>>(
          q0n, bsn, beta, x, beta_out, x_out, nt, S, axes_for<2>(ax), sbf, sd,
          mem, tau, active);
      break;
    case 3:
      cx_kernel<3, MODE><<<grid, kThreads, 0, st>>>(
          q0n, bsn, beta, x, beta_out, x_out, nt, S, axes_for<3>(ax), sbf, sd,
          mem, tau, active);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool WEIGHTED>
int launch_rhs(const float* q0, const float* qb, const float* a0,
               const float* ab, const float* c, const float* w0,
               const float* wb, float* out, int B, int dim, int nt, int S,
               const AxesIn& ax, float D, float inv_ht, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(S, nt, B);
  switch (dim) {
    case 1:
      rhs_kernel<1, WEIGHTED><<<grid, kThreads, 0, st>>>(
          q0, qb, a0, ab, c, w0, wb, out, nt, S, axes_for<1>(ax), D, inv_ht);
      break;
    case 2:
      rhs_kernel<2, WEIGHTED><<<grid, kThreads, 0, st>>>(
          q0, qb, a0, ab, c, w0, wb, out, nt, S, axes_for<2>(ax), D, inv_ht);
      break;
    case 3:
      rhs_kernel<3, WEIGHTED><<<grid, kThreads, 0, st>>>(
          q0, qb, a0, ab, c, w0, wb, out, nt, S, axes_for<3>(ax), D, inv_ht);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int DIM, bool W>
void launch_kkt_dim(const float* phi, const float* q0, const float* qb,
                    const float* z, const float* a0, const float* ab,
                    const float* beta, const float* c, const float* w0,
                    const float* wb, double* partial, float* out, int nt,
                    int S, const AxesIn& ax, const KktScalars& sc,
                    cudaStream_t st) {
  int sblocks, tblocks, rows;
  kkt_grid(nt, S, sblocks, tblocks, rows);
  kkt_kernel<DIM, W><<<dim3(sblocks, tblocks), kKktThreads, 0, st>>>(
      phi, q0, qb, z, a0, ab, beta, c, w0, wb, partial, nt, S, rows,
      axes_for<DIM>(ax), sc);
  kkt_finish<kkt_count<DIM>()><<<1, kKktThreads, 0, st>>>(
      partial, sblocks * tblocks, out);
}

template <bool W>
int launch_kkt(const float* phi, const float* q0, const float* qb,
               const float* z, const float* a0, const float* ab,
               const float* beta, const float* c, const float* w0,
               const float* wb, double* partial, float* out, int dim, int nt,
               int S, const AxesIn& ax, const KktScalars& sc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1:
      launch_kkt_dim<1, W>(phi, q0, qb, z, a0, ab, beta, c, w0, wb, partial,
                           out, nt, S, ax, sc, st);
      break;
    case 2:
      launch_kkt_dim<2, W>(phi, q0, qb, z, a0, ab, beta, c, w0, wb, partial,
                           out, nt, S, ax, sc, st);
      break;
    case 3:
      launch_kkt_dim<3, W>(phi, q0, qb, z, a0, ab, beta, c, w0, wb, partial,
                           out, nt, S, ax, sc, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point takes the flat stride k_a of each space axis (k0..k2),
// and the q-steps also its size n_a and spacing hs_a; a d < 3 launch passes
// 0, 1 and 1 for the axes it lacks.

int dotsocp_x_step(const float* q0, const float* bs, const float* beta,
                   float* x, int dim, int nt, int S, int k0, int k1, int k2,
                   float sbf, float sd, void* stream) {
  return launch_x<true>(q0, bs, beta, x, dim, nt, S, make_axes(k0, k1, k2),
                        sbf, sd, FromMemory{}, stream);
}

// z = Pi_K(BF_d q - beta) into the fresh z.
int dotsocp_z_step(const float* q0, const float* bs, const float* beta,
                   float* z, int dim, int nt, int S, int k0, int k1, int k2,
                   float sbf, float sd, void* stream) {
  return launch_x<false>(q0, bs, beta, z, dim, nt, S, make_axes(k0, k1, k2),
                         sbf, sd, FromMemory{}, stream);
}

// alpha (a0, ab) updated in place; sv is the host's s_bf / sqrt2, which
// the 3D kernel takes (see qx_kernel).
int dotsocp_qx_step(const float* phi, const float* x, float* a0, float* ab,
                    float* q0n, float* bsn, int dim, int nt, int S, int k0,
                    int k1, int k2, int n0, int n1, int n2, float D, float sbf,
                    float tau, float ht, float hs0, float hs1, float hs2,
                    float dinv_in, float dinv_bd, float sv, void* stream) {
  return launch_qx<false, false>(
      phi, x, nullptr, a0, ab, a0, ab, q0n, bsn, nullptr, nullptr, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, sbf, tau, ht,
      dinv_in, dinv_bd, sv, FromMemory{}, stream);
}

// The weighted q-step: w0 (nt-1, S) and wb (d, nt, S) the flat weight,
// (base_in, base_bd) the values of the diagonal of (E/D)^2 F*B*BF, sv the
// host's s_bf / sqrt2.
int dotsocp_qx_step_w(const float* phi, const float* x, float* a0, float* ab,
                      float* q0n, float* bsn, const float* w0, const float* wb,
                      int dim, int nt, int S, int k0, int k1, int k2, int n0,
                      int n1, int n2, float D, float sbf, float tau, float ht,
                      float hs0, float hs1, float hs2, float base_in,
                      float base_bd, float sv, void* stream) {
  return launch_qx<true, false>(
      phi, x, nullptr, a0, ab, a0, ab, q0n, bsn, w0, wb, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, sbf, tau, ht,
      base_in, base_bd, sv, FromMemory{}, stream);
}

// The single step's q-step from z and beta; alpha' into the fresh
// (a0n, abn).
int dotsocp_q_step(const float* phi, const float* z, const float* beta,
                   const float* a0, const float* ab, float* a0n, float* abn,
                   float* q0n, float* bsn, int dim, int nt, int S, int k0,
                   int k1, int k2, int n0, int n1, int n2, float D, float sbf,
                   float tau, float ht, float hs0, float hs1, float hs2,
                   float dinv_in, float dinv_bd, float sv, void* stream) {
  return launch_qx<false, true>(
      phi, z, beta, a0, ab, a0n, abn, q0n, bsn, nullptr, nullptr, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, sbf, tau, ht,
      dinv_in, dinv_bd, sv, FromMemory{}, stream);
}

int dotsocp_q_step_w(const float* phi, const float* z, const float* beta,
                     const float* a0, const float* ab, float* a0n, float* abn,
                     float* q0n, float* bsn, const float* w0, const float* wb,
                     int dim, int nt, int S, int k0, int k1, int k2, int n0,
                     int n1, int n2, float D, float sbf, float tau, float ht,
                     float hs0, float hs1, float hs2, float base_in,
                     float base_bd, float sv, void* stream) {
  return launch_qx<true, true>(
      phi, z, beta, a0, ab, a0n, abn, q0n, bsn, w0, wb, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, sbf, tau, ht,
      base_in, base_bd, sv, FromMemory{}, stream);
}

// beta and x updated in place.
int dotsocp_cx_step(const float* q0n, const float* bsn, float* beta, float* x,
                    int dim, int nt, int S, int k0, int k1, int k2, float sbf,
                    float sd, float tau, int final_step, void* stream) {
  const AxesIn ax = make_axes(k0, k1, k2);
  if (final_step) {
    return launch_cx<kCxFinal>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax,
                               sbf, sd, FromMemory{}, tau, stream);
  }
  return launch_cx<kCx>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax, sbf, sd,
                        FromMemory{}, tau, stream);
}

// beta' = beta + tau (z - BF_d q') into the fresh beta_out.
int dotsocp_beta_step(const float* q0n, const float* bsn, const float* beta,
                      const float* z, float* beta_out, int dim, int nt, int S,
                      int k0, int k1, int k2, float sbf, float sd, float tau,
                      void* stream) {
  return launch_cx<kBeta>(q0n, bsn, beta, z, beta_out, nullptr, dim, nt, S,
                          make_axes(k0, k1, k2), sbf, sd, FromMemory{}, tau,
                          stream);
}

// The entries above with their problem-dependent scalars read from device
// memory (float32 scalars of the device driver's state, which a captured
// CUDA graph must not freeze): sbf_at and sd_at for the four that take sd;
// sbf_at, sv_at and the two diagonal values for the q-steps. The same
// arithmetic on the same floats.
int dotsocp_x_step_dev(const float* q0, const float* bs, const float* beta,
                       float* x, int dim, int nt, int S, int k0, int k1,
                       int k2, const float* sbf_at, const float* sd_at,
                       void* stream) {
  return launch_x<true>(q0, bs, beta, x, dim, nt, S, make_axes(k0, k1, k2),
                        0.f, 0.f, FromMemory{sd_at, sbf_at}, stream);
}

int dotsocp_z_step_dev(const float* q0, const float* bs, const float* beta,
                       float* z, int dim, int nt, int S, int k0, int k1,
                       int k2, const float* sbf_at, const float* sd_at,
                       void* stream) {
  return launch_x<false>(q0, bs, beta, z, dim, nt, S, make_axes(k0, k1, k2),
                         0.f, 0.f, FromMemory{sd_at, sbf_at}, stream);
}

int dotsocp_cx_step_dev(const float* q0n, const float* bsn, float* beta,
                        float* x, int dim, int nt, int S, int k0, int k1,
                        int k2, const float* sbf_at, const float* sd_at,
                        float tau, int final_step, void* stream) {
  const AxesIn ax = make_axes(k0, k1, k2);
  const FromMemory mem{sd_at, sbf_at};
  if (final_step) {
    return launch_cx<kCxFinal>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax,
                               0.f, 0.f, mem, tau, stream);
  }
  return launch_cx<kCx>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax, 0.f, 0.f,
                        mem, tau, stream);
}

int dotsocp_beta_step_dev(const float* q0n, const float* bsn,
                          const float* beta, const float* z, float* beta_out,
                          int dim, int nt, int S, int k0, int k1, int k2,
                          const float* sbf_at, const float* sd_at, float tau,
                          void* stream) {
  return launch_cx<kBeta>(q0n, bsn, beta, z, beta_out, nullptr, dim, nt, S,
                          make_axes(k0, k1, k2), 0.f, 0.f,
                          FromMemory{sd_at, sbf_at}, tau, stream);
}

int dotsocp_qx_step_dev(const float* phi, const float* x, float* a0,
                        float* ab, float* q0n, float* bsn, int dim, int nt,
                        int S, int k0, int k1, int k2, int n0, int n1, int n2,
                        float D, float tau, float ht, float hs0, float hs1,
                        float hs2, const float* sbf_at, const float* sv_at,
                        const float* din_at, const float* dbd_at,
                        void* stream) {
  return launch_qx<false, false>(
      phi, x, nullptr, a0, ab, a0, ab, q0n, bsn, nullptr, nullptr, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, 0.f, tau, ht, 0.f,
      0.f, 0.f, FromMemory{nullptr, sbf_at, sv_at, din_at, dbd_at}, stream);
}

int dotsocp_qx_step_w_dev(const float* phi, const float* x, float* a0,
                          float* ab, float* q0n, float* bsn, const float* w0,
                          const float* wb, int dim, int nt, int S, int k0,
                          int k1, int k2, int n0, int n1, int n2, float D,
                          float tau, float ht, float hs0, float hs1,
                          float hs2, const float* sbf_at, const float* sv_at,
                          const float* bin_at, const float* bbd_at,
                          void* stream) {
  return launch_qx<true, false>(
      phi, x, nullptr, a0, ab, a0, ab, q0n, bsn, w0, wb, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, 0.f, tau, ht, 0.f,
      0.f, 0.f, FromMemory{nullptr, sbf_at, sv_at, bin_at, bbd_at}, stream);
}

int dotsocp_q_step_dev(const float* phi, const float* z, const float* beta,
                       const float* a0, const float* ab, float* a0n,
                       float* abn, float* q0n, float* bsn, int dim, int nt,
                       int S, int k0, int k1, int k2, int n0, int n1, int n2,
                       float D, float tau, float ht, float hs0, float hs1,
                       float hs2, const float* sbf_at, const float* sv_at,
                       const float* din_at, const float* dbd_at,
                       void* stream) {
  return launch_qx<false, true>(
      phi, z, beta, a0, ab, a0n, abn, q0n, bsn, nullptr, nullptr, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, 0.f, tau, ht, 0.f,
      0.f, 0.f, FromMemory{nullptr, sbf_at, sv_at, din_at, dbd_at}, stream);
}

int dotsocp_q_step_w_dev(const float* phi, const float* z, const float* beta,
                         const float* a0, const float* ab, float* a0n,
                         float* abn, float* q0n, float* bsn, const float* w0,
                         const float* wb, int dim, int nt, int S, int k0,
                         int k1, int k2, int n0, int n1, int n2, float D,
                         float tau, float ht, float hs0, float hs1, float hs2,
                         const float* sbf_at, const float* sv_at,
                         const float* bin_at, const float* bbd_at,
                         void* stream) {
  return launch_qx<true, true>(
      phi, z, beta, a0, ab, a0n, abn, q0n, bsn, w0, wb, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, 0.f, tau, ht, 0.f,
      0.f, 0.f, FromMemory{nullptr, sbf_at, sv_at, bin_at, bbd_at}, stream);
}

// The batched forms: B instances over contiguous (B, ...) fields, sd_at the
// (B,) per-instance sd, active the (B,) byte mask (0: the instance's blocks
// return at once). x into x (which no thread reads); alpha (a0, ab) updated
// in place and q' into (q0n, bsn); beta and x updated in place.
int dotsocp_x_step_b(const float* q0, const float* bs, const float* beta,
                     float* x, const float* sd_at, const uint8_t* active,
                     int B, int dim, int nt, int S, int k0, int k1, int k2,
                     float sbf, void* stream) {
  return launch_x<true>(q0, bs, beta, x, dim, nt, S, make_axes(k0, k1, k2),
                        sbf, 0.f, FromMemory{sd_at}, stream, B, active);
}

int dotsocp_qx_step_b(const float* phi, const float* x, float* a0, float* ab,
                      float* q0n, float* bsn, const uint8_t* active, int B,
                      int dim, int nt, int S, int k0, int k1, int k2, int n0,
                      int n1, int n2, float D, float sbf, float tau, float ht,
                      float hs0, float hs1, float hs2, float dinv_in,
                      float dinv_bd, float sv, void* stream) {
  return launch_qx<false, false>(
      phi, x, nullptr, a0, ab, a0, ab, q0n, bsn, nullptr, nullptr, dim, nt, S,
      make_axes(k0, k1, k2, n0, n1, n2, hs0, hs1, hs2), D, sbf, tau, ht,
      dinv_in, dinv_bd, sv, FromMemory{}, stream, B, active);
}

int dotsocp_cx_step_b(const float* q0n, const float* bsn, float* beta,
                      float* x, const float* sd_at, const uint8_t* active,
                      int B, int dim, int nt, int S, int k0, int k1, int k2,
                      float sbf, float tau, int final_step, void* stream) {
  const AxesIn ax = make_axes(k0, k1, k2);
  const FromMemory mem{sd_at};
  if (final_step) {
    return launch_cx<kCxFinal>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax,
                               sbf, 0.f, mem, tau, stream, B, active);
  }
  return launch_cx<kCx>(q0n, bsn, beta, x, beta, x, dim, nt, S, ax, sbf, 0.f,
                        mem, tau, stream, B, active);
}

// z = Pi_K(z2 - beta) over flat (C, M) views, into the fresh z.
int dotsocp_cone_project_diff(const float* z2, const float* beta, float* z,
                              int C, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 2 || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + kThreads - 1) / kThreads));
  if (C == 6) {
    cone_kernel<6><<<grid, kThreads, 0, st>>>(z2, beta, z, C, M);
  } else if (C == 10) {
    cone_kernel<10><<<grid, kThreads, 0, st>>>(z2, beta, z, C, M);
  } else if (C == 14) {
    cone_kernel<14><<<grid, kThreads, 0, st>>>(z2, beta, z, C, M);
  } else {
    cone_kernel<0><<<grid, kThreads, 0, st>>>(z2, beta, z, C, M);
  }
  return (int)cudaGetLastError();
}

// rhs = D A^T (w q - alpha) + c into the fresh out, for B instances over
// contiguous (B, ...) fields; w0 / wb (one weight, shared by the instances)
// null for the unweighted form. iht and ih0..ih2 are 1/h_t and 1/h_a as
// float32 reciprocals; a d < 3 launch passes k 0 and ih 1 for the axes it
// lacks.
int dotsocp_phi_rhs(const float* q0, const float* qb, const float* a0,
                    const float* ab, const float* c, const float* w0,
                    const float* wb, float* out, int B, int dim, int nt,
                    int S, int k0, int k1, int k2, float D, float iht,
                    float ih0, float ih1, float ih2, void* stream) {
  const AxesIn ax = make_axes(k0, k1, k2, 1, 1, 1, ih0, ih1, ih2);
  if (w0 != nullptr) {
    return launch_rhs<true>(q0, qb, a0, ab, c, w0, wb, out, B, dim, nt, S,
                            ax, D, iht, stream);
  }
  return launch_rhs<false>(q0, qb, a0, ab, c, nullptr, nullptr, out, B, dim,
                           nt, S, ax, D, iht, stream);
}

// The number of float64 rows (one a block) the KKT battery's ``partial``
// workspace needs for (nt, S); each row holds the battery's 17 + 3 d sums.
int dotsocp_kkt_blocks(int nt, int S) {
  int sblocks, tblocks, rows;
  kkt_grid(nt, S, sblocks, tblocks, rows);
  return sblocks * tblocks;
}

// The KKT battery's 17 + 3 d sums into out (float32), through the
// workspace ``partial`` of ``partial_rows`` rows (dotsocp_kkt_blocks); w0 /
// wb null for an unweighted level. ih0..ih2 and iht are 1/h_a and 1/h_t as
// float32 reciprocals, inv_D = 1/D likewise. The state's scalars as
// KktScalars takes them: sigma, cScale, E, sbf, sv, 1/E, sd, rs, dsd and
// dse by value, and the pointers sigma_at, cscale_at, dscale_at and ev_at
// (E, sbf, sv and 1/E at offsets 0, 1, 2 and 5), each null or replacing
// its values. A d < 3 launch passes k 0, n 1 and ih 1 for the axes it
// lacks.
int dotsocp_kkt_sums(const float* phi, const float* q0, const float* qb,
                     const float* z, const float* a0, const float* ab,
                     const float* beta, const float* c, const float* w0,
                     const float* wb, double* partial, int partial_rows,
                     float* out, int dim, int nt, int S, int k0, int k1,
                     int k2, int n0, int n1, int n2, float ih0, float ih1,
                     float ih2, float iht, float D, float inv_D, float sigma,
                     float cscale, float e, float sbf, float sv, float inv_e,
                     float sd, float rs, float dsd, float dse,
                     const float* sigma_at, const float* cscale_at,
                     const float* dscale_at, const float* ev_at,
                     void* stream) {
  if (nt < 2 || S < 1 || partial_rows < dotsocp_kkt_blocks(nt, S)) {
    return (int)cudaErrorInvalidValue;
  }
  const AxesIn ax = make_axes(k0, k1, k2, n0, n1, n2, ih0, ih1, ih2);
  const KktScalars sc{sigma,  cscale, e,         sbf,       sv,
                      inv_e,  sd,     rs,        dsd,       dse,
                      D,      inv_D,  iht,       sigma_at,  cscale_at,
                      dscale_at, ev_at};
  if (w0 != nullptr) {
    return launch_kkt<true>(phi, q0, qb, z, a0, ab, beta, c, w0, wb, partial,
                            out, dim, nt, S, ax, sc, stream);
  }
  return launch_kkt<false>(phi, q0, qb, z, a0, ab, beta, c, nullptr, nullptr,
                           partial, out, dim, nt, S, ax, sc, stream);
}

}  // extern "C"
