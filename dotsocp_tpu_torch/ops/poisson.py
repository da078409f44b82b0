"""Spectral solve of the space-time Neumann Laplacian by the DCT; port of
``dotsocp_tpu/ops/poisson.py:31-176,217-258``: the plain path and the
iterative-refinement (IR) f64 solve. The double-word split-f32 path is not
ported: it works around the TPU's emulated f64.

Solves  D^2 * (A^T A) phi = rhs  (``oper_poisson3dim.m``) as

    phi = C^T_t C^T_y C^T_x [ (C_t C_y C_x rhs) * inv_kernel ]

with one orthonormal DCT-II per axis and inv_kernel = 1 / (D^2 * kernel).
A space axis takes one of two routes, by its length alone
(:func:`fast_axis`); the t axis always takes the first:

- the matrix route: a product with the dense DCT matrix, 2n flops an
  element. On a 2D grid whose axes are all on it, a float32 solve on the
  card runs as three hand-written passes (:func:`dense_passes`,
  ``csrc/dct_dense.cu``: each (t) slab's two space transforms, each space
  column's t transform with the inverse kernel and the inverse t
  transform, each slab's inverse space transforms), which launch or
  raise; elsewhere (the CPU, float64, 1D and 3D grids, the FFT route's
  shorter axes) ``torch.matmul`` in full precision (the JAX package runs
  its matmuls at ``Precision.HIGHEST``, and a TF32 solve loses ~4 digits,
  so building a solver switches TF32 off for CUDA matmuls);
  :func:`dense_route` decides;
- the FFT route (space axes of ``FAST_DCT_MIN`` points or more): Makhoul's
  algorithm over all of them at once (:class:`FftPlan`): one pass applies
  the t axis's matrix and the reorder (x0, x2, x4, ..., x5, x3, x1) along
  each (:func:`t_pass`), then one ``torch.fft.rfftn`` (cuFFT on the card),
  the spectral step (:func:`spectral_multiply`: twiddles, the inverse
  kernel laid out on the half spectrum, inverse twiddles), ``irfftn`` and
  the inverse pass; O(log n) an element. On float32 CUDA tensors both the
  passes and the spectral step are kernels (``csrc/dct_spectral.cu``),
  which launch or raise; on the CPU and in float64 their plain versions
  run.

Both routes compute the same transform; they differ in rounding only.

An IR build (``split="ir"`` or ``"ir1"``) keeps its matrices and inverse
kernel in float32 and solves a float64 rhs by refinement: the f32 DCT solve
is the preconditioner, the residual is formed in true f64 through the
Neumann stencil (:func:`neumann_ata_apply`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .geometry import Geometry

# the f64 strategies of make_dct_poisson's ``split``
SPLITS = (False, "ir", "ir1")


def is_split(value) -> bool:
    """True for a value of ``SPLITS``; False by identity (0 and 0.0 are
    not strategies)."""
    return value is False or (isinstance(value, str) and value in SPLITS)


def full_precision_matmul() -> None:
    """Pin float32 matmuls to full f32 (no TF32) — process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dct_matrix(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Orthonormal DCT-II matrix: C[k, j] = s_k cos(pi k (2j+1) / (2n))."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    C = np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    C[0] *= math.sqrt(1.0 / n)
    C[1:] *= math.sqrt(2.0 / n)
    return torch.as_tensor(C, dtype=dtype, device=device)


# The shortest space axis that takes the FFT route (the crossover). Measured
# on the NVIDIA H100 80GB HBM3 in float32 by ``chip_smoke.py`` phase 5c
# (PERF.md §6): the whole phi-solve with the spatial axes on each route at
# 129^2 x 17, 129^2 x 33, 257^2 x 33 and 513^2 x 65.
FAST_DCT_MIN = 257

# The longest axis the matrix route's passes take (:func:`dense_route`): a
# block holds a slab of ny x nx points, or the t axis's T x T matrix, in its
# shared memory (227 KB on the H100: a slab of at most 236 points a side, a
# t axis of at most 224). A float32 solve on the card with a longer axis
# runs the matmuls.
DENSE_PASS_MAX = 192

# the kernel launches of the FFT route (``csrc/dct_spectral.cu``) and of the
# matrix route's passes (``csrc/dct_dense.cu``), as ``fused_step.LAUNCHES``
# counts the step kernels'
LAUNCHES = {"dct_spectral": 0, "dct_t_gather": 0, "dct_slab_fwd": 0,
            "dct_t_spectral": 0, "dct_slab_inv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fast_axis(n: int) -> bool:
    """The route of a space axis of n points: True for the FFT route,
    False for the dense matrix. A function of the length alone; the t axis
    keeps its matrix at any length (the route's passes apply it)."""
    return n >= FAST_DCT_MIN


def dense_route(grid: Tuple[int, ...], dtype: torch.dtype, device,
                fast_axes: Tuple[int, ...] = ()) -> bool:
    """Whether the matrix route of a solve over ``grid`` (the lengths of t
    and the space axes) of a rhs of ``dtype`` on ``device`` runs the three
    passes of :func:`dense_passes` (True) or the matmuls: True for a
    float32 rhs on a CUDA device, a grid of three axes (t, y, x), no space
    axis on the FFT route (``fast_axes``, the solver's) and no axis longer
    than ``DENSE_PASS_MAX``. A function of what the solve can see, as
    :func:`fast_axis` is."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and len(grid) == 3 and not fast_axes
            and max(grid) <= DENSE_PASS_MAX)


class DensePlan(NamedTuple):
    """What the passes read besides the field: each axis's (C^T, C), and
    the inverse kernel laid out as the intermediate is, (T, ny, nxp), all
    with zero columns up to a multiple of 4 (nxp = nx rounded up)."""

    mats: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    kernel: torch.Tensor


def _pad4(a: torch.Tensor) -> torch.Tensor:
    """a with zero columns (last axis) up to a multiple of 4, contiguous."""
    return torch.nn.functional.pad(a, (0, -a.shape[-1] % 4)).contiguous()


def dense_passes(y: torch.Tensor, p: "DctPoisson", scale) -> torch.Tensor:
    """The matrix route's solve of y (..., T, ny, nx), contiguous float32 on
    the card, in three launches of ``csrc/dct_dense.cu``: the forward slab
    pass (C_y X C_x^T a slab) into one fresh intermediate whose rows are
    padded to nxp (a multiple of 4) with zeros, the t pass in place on it
    (a column's C_t, times the inverse kernel times ``scale``, then
    C_t^T), the inverse slab pass (C_y^T Y C_x) into the fresh output.
    Leading axes (a stack of instances) fold into the slabs and columns.
    Raises on any other input."""
    from . import _build, fused_step

    grid = p.grid
    if (y.dtype != torch.float32 or p.inv_kernel.dtype != torch.float32
            or y.device != p.inv_kernel.device or not y.is_contiguous()
            or tuple(y.shape[-3:]) != grid):
        raise ValueError(f"dense_passes: y {y.dtype} {tuple(y.shape)} on "
                         f"{y.device} (contiguous: {y.is_contiguous()}), "
                         f"expected a contiguous float32 (..., {grid}) on "
                         f"{p.inv_kernel.device}")
    T, ny, nx = grid
    nxp = -(-nx // 4) * 4
    (Ctt, Ct), (Cyt, Cy), (Cxt, Cx) = p.dense.mats
    slabs = y.numel() // (ny * nx)
    lib = _build.library()
    mid = torch.empty(y.shape[:-1] + (nxp,), dtype=y.dtype, device=y.device)
    fused_step._launch(LAUNCHES, "dct_slab_fwd", lib.dotsocp_dct_slab,
                       y.device, y.data_ptr(), nx, mid.data_ptr(), nxp,
                       Cyt.data_ptr(), Cxt.data_ptr(), slabs, ny, nx)
    fused_step._launch(LAUNCHES, "dct_t_spectral",
                       lib.dotsocp_dct_t_spectral, y.device, mid.data_ptr(),
                       Ctt.data_ptr(), Ct.data_ptr(),
                       p.dense.kernel.data_ptr(), slabs // T, T, ny * nxp,
                       1.0 if scale is None else float(scale))
    out = torch.empty_like(y)
    fused_step._launch(LAUNCHES, "dct_slab_inv", lib.dotsocp_dct_slab,
                       y.device, mid.data_ptr(), nxp, out.data_ptr(), nx,
                       Cy.data_ptr(), Cx.data_ptr(), slabs, ny, nx)
    return out


def dense_passes_plain(y: torch.Tensor, p: "DctPoisson",
                       scale) -> torch.Tensor:
    """:func:`dense_passes`' arithmetic as PyTorch operations: the forward
    slab product, the t axis's transform, kernel and inverse a column, the
    inverse slab product."""
    (Ct, Cy, Cx), (T, ny, nx) = p.mats, p.grid
    z = torch.matmul(torch.matmul(Cy, y), Cx.T)
    w = torch.matmul(Ct, z.reshape(-1, T, ny * nx))
    g = p.inv_kernel if scale is None else p.inv_kernel * scale
    w = torch.matmul(Ct.T, w * g.reshape(T, ny * nx))
    return torch.matmul(torch.matmul(Cy.T, w.reshape(y.shape)), Cx)


class FftPlan(NamedTuple):
    """The FFT route of a solve over its space axes of at least
    ``FAST_DCT_MIN`` points; the t axis and the shorter space axes keep
    their matrices. The forward pass (:func:`t_pass`) applies the t axis's
    matrix and lays the space points out as ``layout``: the shorter space
    axes first, then the route's m axes, each in Makhoul's order
    (x0, x2, ..., x3, x1). ``torch.fft.rfftn`` over the route's axes leaves
    the half spectrum (n_1, ..., n_{m-1}, h_m), h_m = n_m // 2 + 1, on
    which :func:`spectral_multiply` runs; the inverse pass takes the
    layout back to the grid's."""

    axes: Tuple[int, ...]          # grid axes on the route (space: >= 1)
    n: Tuple[int, ...]             # their lengths
    space: Tuple[int, ...]         # the grid's space shape
    layout: Tuple[int, ...]        # the space shape between the passes
    t_matrix: torch.Tensor         # the t axis's DCT matrix (T, T)
    # the same for ``t_gather_kernel``, forward and inverse, (T, TP) with
    # At[t, k] = A[k, t], rows padded with zeros to a multiple of 16
    t_mats: Tuple[torch.Tensor, torch.Tensor]
    # flat maps over the S space points, int32: point s of the forward
    # pass's output reads point src[0][s] of its input; of the inverse's,
    # src[1][s]
    src: Tuple[torch.Tensor, torch.Tensor]
    flip: Tuple[torch.Tensor, ...]    # (n - k) mod n, each axis but the last
    twiddle: torch.Tensor          # prod_a exp(-i pi k_a / (2 n_a))
    untwiddle: torch.Tensor        # its conjugate
    # the inverse kernel over (T, shorter space axes, n_1, ..., h_m, 2): at
    # k_m the modes k_m and n_m - k_m (none for k_m = 0: 0), times
    # 1 / (n_1 ... n_m) for the unnormalised inverse FFT
    kernel: torch.Tensor


def _fft_plan(inv: np.ndarray, axes: Tuple[int, ...], dtype, device,
              t_matrix: torch.Tensor) -> FftPlan:
    """The plan of the FFT route over the space ``axes`` for the
    phi-shaped inverse kernel ``inv`` (float64); ``t_matrix`` is the t
    axis's DCT matrix."""
    m = len(axes)
    n = tuple(inv.shape[a] for a in axes)
    space = inv.shape[1:]
    perm = (0,) + tuple(a for a in range(1, inv.ndim) if a not in axes) + axes
    g = np.transpose(inv, perm) / math.prod(n)
    h = n[-1] // 2 + 1
    k = np.arange(h)
    im = np.where(k == 0, 0.0, np.take(g, (n[-1] - k) % n[-1], axis=-1))
    kernel = np.stack([g[..., :h], im], axis=-1)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    tw = np.ones(n[:-1] + (h,), dtype=complex)
    for i, na in enumerate(n):
        ka = np.arange(na if i < m - 1 else h)
        tw = tw * np.exp(-1j * np.pi * ka / (2 * na)).reshape(
            (-1,) + (1,) * (m - 1 - i))
    # the grid's flat space index of each point of the layout
    idx = np.transpose(np.arange(math.prod(space)).reshape(space),
                       [a - 1 for a in perm[1:]])
    for i, na in enumerate(n):
        order = np.concatenate([np.arange(0, na, 2), np.arange(1, na, 2)[::-1]])
        idx = np.take(idx, order, axis=idx.ndim - m + i)
    fwd = idx.reshape(-1)
    T = inv.shape[0]
    pad = (0, -(-T // 16) * 16 - T)

    def put(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return FftPlan(axes=axes, n=n, space=tuple(space), layout=idx.shape,
                   t_matrix=t_matrix,
                   t_mats=tuple(torch.nn.functional.pad(A, pad)
                                for A in (t_matrix.T, t_matrix)),
                   src=(put(fwd, torch.int32),
                        put(np.argsort(fwd), torch.int32)),
                   flip=tuple(put((na - np.arange(na)) % na) for na in n[:-1]),
                   twiddle=put(tw, cdtype), untwiddle=put(tw.conj(), cdtype),
                   kernel=put(kernel, dtype))


def _pass_shapes(plan: FftPlan, which: int):
    """The (T, space) shapes a pass reads and writes: ``which`` 0 the
    forward pass (grid to layout), 1 the inverse."""
    T = plan.t_matrix.shape[0]
    grid, layout = (T,) + plan.space, (T,) + plan.layout
    return (grid, layout) if which == 0 else (layout, grid)


def t_gather(x: torch.Tensor, plan: FftPlan, which: int) -> torch.Tensor:
    """One launch of ``t_gather_kernel`` (``csrc/dct_spectral.cu``) on x
    (..., T, space), contiguous float32 on the card, into a fresh tensor:
    ``which`` 0, the t axis's DCT and the space points from the grid's
    layout to the route's; 1, the inverse DCT and the way back."""
    from . import _build, fused_step

    At, src = plan.t_mats[which], plan.src[which]
    T, TP = At.shape
    into, out = _pass_shapes(plan, which)
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or tuple(x.shape[-len(into):]) != into):
        raise ValueError(f"t_gather: x {x.dtype} {tuple(x.shape)} "
                         f"(contiguous: {x.is_contiguous()}), expected a "
                         f"contiguous float32 (..., {into})")
    lead = tuple(x.shape[:-len(into)])
    y = torch.empty(lead + out, dtype=x.dtype, device=x.device)
    S = src.numel()
    fused_step._launch(LAUNCHES, "dct_t_gather",
                       _build.library().dotsocp_dct_t_gather, x.device,
                       x.data_ptr(), y.data_ptr(), At.data_ptr(),
                       src.data_ptr(), x.numel() // (T * S), T, TP, S)
    return y


def t_gather_plain(x: torch.Tensor, plan: FftPlan, which: int) -> torch.Tensor:
    """:func:`t_gather`'s plain version: the matrix product along t, then
    the gather of the space points."""
    into, out = _pass_shapes(plan, which)
    M = plan.t_matrix if which == 0 else plan.t_matrix.T
    lead = tuple(x.shape[:-len(into)])
    y = torch.matmul(M, x.reshape(-1, into[0], math.prod(into[1:])))
    return y.index_select(-1, plan.src[which]).reshape(lead + out)


def t_pass(x: torch.Tensor, plan: FftPlan, which: int) -> torch.Tensor:
    """:func:`t_gather` on float32 CUDA tensors (it launches or raises: a
    non-contiguous x raises), its plain version on the CPU and in
    float64 (``fused_step._use_kernel``)."""
    from . import fused_step

    if fused_step._use_kernel(plan.kernel, x):
        return t_gather(x, plan, which)
    return t_gather_plain(x, plan, which)


def _dims(plan: FftPlan) -> Tuple[int, ...]:
    return tuple(range(-len(plan.n), 0))


def _inverse_fft(V: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """Unnormalised (``norm="forward"``): no pass scales by 1/n, the kernel
    holds it."""
    return torch.fft.irfftn(V, s=plan.n, dim=_dims(plan), norm="forward")


def _unpair(Y: torch.Tensor, dim: int, flip: torch.Tensor) -> torch.Tensor:
    """(Y(k) + i Y(-k)) / 2 along ``dim``, -k = (n - k) mod n, and Y(0) at
    0: the two real transforms a complex DFT along that axis holds."""
    F = (Y + 1j * Y.index_select(dim, flip)) / 2
    F.select(dim, 0).copy_(Y.select(dim, 0))
    return F


def _pair(F: torch.Tensor, dim: int, flip: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_unpair`: F(k) - i F(-k), and F(0) at 0."""
    Y = F - 1j * F.index_select(dim, flip)
    Y.select(dim, 0).copy_(F.select(dim, 0))
    return Y


def spectral_forward(V: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """From the half spectrum V of the reordered field to F: along each of
    the route's axes but the last, F's index is the DCT-II mode; along the
    last, Re F holds mode k and -Im F mode n - k (nothing at k = 0)."""
    F = V * plan.twiddle
    for i, flip in enumerate(plan.flip):
        F = _unpair(F, i - len(plan.n), flip)
    return F


def spectral_inverse(F: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """The inverse of :func:`spectral_forward`."""
    for i in reversed(range(len(plan.flip))):
        F = _pair(F, i - len(plan.n), plan.flip[i])
    return F * plan.untwiddle


def spectral_multiply_plain(V: torch.Tensor, plan: FftPlan,
                            scale) -> torch.Tensor:
    """The spectral step of the FFT route: the forward transform's end, the
    inverse kernel (times ``scale``), the inverse's start, as PyTorch
    operations (the kernel's plain version)."""
    F = spectral_forward(V, plan)
    g = plan.kernel if scale is None else plan.kernel * scale
    F = torch.view_as_complex(torch.view_as_real(F) * g)
    return spectral_inverse(F, plan)


def spectral_multiply(V: torch.Tensor, plan: FftPlan, scale) -> torch.Tensor:
    """:func:`spectral_multiply_plain`, in one launch of the kernel of
    ``csrc/dct_spectral.cu`` (in place on V) where the plan is float32 on
    the card (``fused_step._use_kernel``: it launches or raises); the plain
    version on the CPU and in float64."""
    from . import _build, fused_step

    if not fused_step._use_kernel(plan.kernel):
        return spectral_multiply_plain(V, plan, scale)
    half = tuple(plan.twiddle.shape)
    if (V.dtype != torch.complex64 or not V.is_contiguous()
            or tuple(V.shape[-len(half):]) != half):
        raise ValueError(f"dct_spectral: V {V.dtype} {tuple(V.shape)} "
                         f"(contiguous: {V.is_contiguous()}), expected a "
                         f"contiguous complex64 (..., {half})")
    # the route's axes as (n1, n2, h3), ones in front of fewer than three
    n1, n2, h3 = (1,) * (3 - len(half)) + half
    fused_step._launch(LAUNCHES, "dct_spectral",
                       _build.library().dotsocp_dct_spectral, V.device,
                       V.data_ptr(), plan.kernel.data_ptr(),
                       plan.twiddle.data_ptr(),
                       V.numel() // plan.twiddle.numel(), n1, n2, h3,
                       plan.kernel.numel() // (2 * plan.twiddle.numel()),
                       1.0 if scale is None else float(scale))
    return V


def neumann_eigenvalues(n: int) -> np.ndarray:
    """Eigenvalues of the 1-D forward-difference normal matrix D^T D with
    Neumann ends, h = 1/(n-1): 2 (n-1)^2 (1 - cos(pi k / n))
    (``initialize_FFTkernel.m:6-8``)."""
    k = np.arange(n)
    return 2.0 * (n - 1) ** 2 * (1.0 - np.cos(np.pi * k / n))


def neumann_ata_apply(y: torch.Tensor,
                      coeffs: Tuple[float, ...]) -> torch.Tensor:
    """A^T A y: sum over axes of (n_a-1)^2 * (D^T D y)_a with forward
    differences and Neumann ends -- row 0: y0-y1, interior: -y[i-1]+2y[i]
    -y[i+1], row n-1: y[n-1]-y[n-2]. Eigenvalues match
    ``neumann_eigenvalues`` (2 (n-1)^2 (1 - cos(pi k / n)) per axis)."""
    out = None
    for ax, c in enumerate(coeffs):
        d = torch.diff(y, dim=ax)
        zero = torch.zeros_like(y.narrow(ax, 0, 1))
        term = c * (torch.cat([zero, d], dim=ax)
                    - torch.cat([d, zero], dim=ax))
        out = term if out is None else out + term
    return out


def _apply_axis(M: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract M over ``axis`` of x, keeping the axis in place, as one
    batched matmul with no transpose materialized: leading axes fold into
    the batch, trailing axes into the free dimension."""
    shape = x.shape
    if axis == x.ndim - 1:
        return torch.matmul(x, M.T)
    lead = math.prod(shape[:axis])
    trail = math.prod(shape[axis + 1:])
    y = torch.matmul(M, x.reshape(lead, shape[axis], trail))
    return y.reshape(shape[:axis] + (M.shape[0],) + shape[axis + 1:])


class IrSpec(NamedTuple):
    """Config of the iterative-refinement f64 solve (``split="ir"``)."""

    coeffs: Tuple[float, ...]  # (n_a - 1)^2 per axis for the A^T A stencil
    d2: float                  # D^2 baked at build time (unit-D builds: 1)
    epsilon: Optional[float]   # Helmholtz shift; None = zero mode pinned
    steps: int                 # refinement rounds (2 reach ~f64 grade)


class DctPoisson:
    """The DCT solve of one geometry: per axis its dense DCT matrix; the
    space axes of at least ``FAST_DCT_MIN`` points take the FFT route
    (``fft``, None when none does), the others their matrix.
    ``inv_kernel`` is the matrix route's phi-shaped inverse kernel (None
    on the FFT route, whose plan holds it on the half spectrum);
    ``dense`` the passes' :class:`DensePlan` where they may run (the
    matrices' dtype and device on :func:`dense_route`), else None."""

    def __init__(self, mats: Tuple[torch.Tensor, ...],
                 inv_kernel: Optional[torch.Tensor], fft: Optional[FftPlan],
                 ir: Optional[IrSpec] = None):
        self.mats = mats    # one orthonormal DCT matrix per axis
        self.inv_kernel = inv_kernel
        self.fft = fft
        self.ir = ir        # f32 solve + f64-residual refinement
        self.grid = tuple(C.shape[0] for C in mats)
        self.dense = None
        if dense_route(self.grid, mats[0].dtype, mats[0].device,
                       self.fast_axes):
            self.dense = DensePlan(
                mats=tuple((_pad4(C.T), _pad4(C)) for C in mats),
                kernel=_pad4(inv_kernel))

    @property
    def fast_axes(self) -> Tuple[int, ...]:
        """The grid axes (0 = t) on the FFT route."""
        return () if self.fft is None else self.fft.axes

    def on_passes(self, dtype: torch.dtype, device) -> bool:
        """Whether a solve of a ``dtype`` rhs on ``device`` runs the
        passes (:func:`dense_route`); an IR build's float64 rhs runs its
        float32 preconditioner there."""
        if self.ir is not None and dtype == torch.float64:
            dtype = torch.float32
        return dense_route(self.grid, dtype, device, self.fast_axes)

    def solve(self, rhs: torch.Tensor, scale=None) -> torch.Tensor:
        """phi = idctn(dctn(rhs) * inv_kernel) (``oper_poisson3dim.m:4``).
        ``scale`` multiplies the inverse kernel at use time (1/D^2 against
        a unit-D build). An IR build solves a float64 rhs by refinement.
        Leading axes before the grid's (a batch of instances) pass
        through."""
        if self.ir is not None and rhs.dtype == torch.float64:
            return self._solve_ir(rhs, scale)
        return self._spectral(rhs, scale)

    def _spectral(self, y: torch.Tensor, scale) -> torch.Tensor:
        """C^T (inv_kernel * scale * (C y)) over the grid's axes, the last
        of ``y``. The matrix route runs the passes where :func:`dense_route`
        says so, else the matmuls. On the FFT route the shorter space axes'
        matrices apply at their place, before and after the route's passes
        (the two commute), and the spectral step multiplies by the kernel
        over every axis."""
        lead = y.ndim - len(self.mats)
        if self.fft is None:
            if dense_route(self.grid, y.dtype, y.device):
                return dense_passes(y, self, scale)
            return self._matmuls(y, scale)
        plan = self.fft
        short = [ax for ax in range(1, len(self.mats)) if ax not in plan.axes]
        for ax in short:
            y = _apply_axis(self.mats[ax], y, lead + ax)
        V = spectral_multiply(torch.fft.rfftn(t_pass(y, plan, 0),
                                              dim=_dims(plan)), plan, scale)
        y = t_pass(_inverse_fft(V, plan), plan, 1)
        for ax in short:
            y = _apply_axis(self.mats[ax].T, y, lead + ax)
        return y

    def _matmuls(self, y: torch.Tensor, scale) -> torch.Tensor:
        """The matrix route as one matmul an axis each way and the kernel
        between."""
        lead = y.ndim - len(self.mats)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C, y, lead + ax)
        y = y * (self.inv_kernel if scale is None
                 else self.inv_kernel * scale)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C.T, y, lead + ax)
        return y

    def _base32(self, r: torch.Tensor, scale32) -> torch.Tensor:
        """Plain f32 DCT solve (the IR preconditioner); the matrices and
        the kernel are f32 in IR builds."""
        return self._spectral(r.to(torch.float32), scale32)

    def _solve_ir(self, rhs: torch.Tensor, scale=None) -> torch.Tensor:
        """f64 solve by iterative refinement over the f32 DCT solve
        (``dotsocp_tpu/ops/poisson.py:96-129``). The f32 solve is only a
        preconditioner (operator error ~1e-6); the residual

            r = rhs - (D^2/scale) * (A^T A y + P0 y)

        is formed in true f64, A^T A being the per-axis Neumann
        second-difference stencil and P0 y = mean(y) the pinned zero mode
        (``initialize_FFTkernel.m:15``); a Helmholtz build adds epsilon y
        instead. Each round contracts the error by the f32 solve's
        operator error: two rounds reach the f64 rounding floor."""
        spec = self.ir
        dtype = rhs.dtype
        # a Python scale: a float32 tensor times it rounds it to float32
        # first, as the JAX package's float32 scale, with no copy to the card
        scale32 = None if scale is None else float(scale)
        inv_scale = spec.d2 if scale is None else spec.d2 / scale
        y = self._base32(rhs, scale32).to(dtype)
        for _ in range(spec.steps):
            ay = neumann_ata_apply(y, spec.coeffs)
            ay = ay + (spec.epsilon * y if spec.epsilon is not None
                       else torch.mean(y))
            r = rhs - inv_scale * ay
            y = y + self._base32(r, scale32).to(dtype)
        return y


def _inverse_kernel(ns: Tuple[int, ...], D, epsilon) -> np.ndarray:
    """1 / (D^2 * kernel), phi-shaped, in float64: the sum of each axis's
    Neumann eigenvalues, the zero mode pinned to 1 (epsilon None) or the
    Helmholtz shift added."""
    kernel = np.zeros(ns)
    for ax, n in enumerate(ns):
        shape = [1] * len(ns)
        shape[ax] = n
        kernel = kernel + neumann_eigenvalues(n).reshape(shape)
    if epsilon is None:
        kernel.flat[0] = 1.0  # zero mode: pass-through (pinned)
    else:
        kernel = kernel + epsilon
    return 1.0 / (float(D) ** 2 * kernel)


def make_dct_poisson(geom: Geometry, D=1.0, epsilon=None, dtype=torch.float32,
                     split=False, ir_steps: int = 2, *,
                     device) -> DctPoisson:
    """Build the solver for  D^2 * (A^T A + epsilon I) phi = rhs.

    epsilon=None pins the zero mode's kernel entry to 1 (pure Neumann
    Poisson, ``initialize_FFTkernel.m:15``); otherwise the Helmholtz shift
    is added (``initialize_FFTkernel.m:17-22``). Each space axis takes its
    route by :func:`fast_axis`; the t axis keeps its matrix.

    ``split`` selects the f64 strategy (``SPLITS``): False runs the
    transforms in ``dtype``; "ir" builds them and the inverse kernel in
    float32 and solves a float64 rhs by ``ir_steps`` refinement rounds;
    "ir1" is the same with one round."""
    if not is_split(split):
        raise ValueError(f"split={split!r}: not one of {SPLITS}")
    full_precision_matmul()
    use_ir = split in ("ir", "ir1")
    if split == "ir1":
        ir_steps = 1
    ns = (geom.nt,) + geom.space
    mat_dtype = torch.float32 if use_ir else dtype
    mats = tuple(dct_matrix(n, mat_dtype, device) for n in ns)
    inv = _inverse_kernel(ns, D, epsilon)
    axes = tuple(ax for ax in range(1, len(ns)) if fast_axis(ns[ax]))
    fft = inv_kernel = None
    if axes:
        fft = _fft_plan(inv, axes, mat_dtype, device, mats[0])
    else:
        inv_kernel = torch.as_tensor(inv, dtype=mat_dtype, device=device)
    ir = None
    if use_ir:
        ir = IrSpec(coeffs=tuple(float((n - 1) ** 2) for n in ns),
                    d2=float(D) ** 2,
                    epsilon=None if epsilon is None else float(epsilon),
                    steps=int(ir_steps))
    return DctPoisson(mats, inv_kernel, fft, ir)
