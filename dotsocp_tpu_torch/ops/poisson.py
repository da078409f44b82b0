"""Spectral solve of the space-time Neumann Laplacian via matmul-DCT; port of
``dotsocp_tpu/ops/poisson.py:31-176,217-258``: the plain path and the
iterative-refinement (IR) f64 solve. The double-word split-f32 path is not
ported: it works around the TPU's emulated f64.

Solves  D^2 * (A^T A) phi = rhs  (``oper_poisson3dim.m``) as

    phi = C^T_t C^T_y C^T_x [ (C_t C_y C_x rhs) * inv_kernel ]

with one orthonormal DCT-II matrix per axis and inv_kernel = 1 / (D^2 *
kernel). The per-axis products are ``torch.matmul`` in full precision: the
JAX package runs them at ``Precision.HIGHEST``, and a TF32 solve loses ~4
digits, so building a solver switches TF32 off for CUDA matmuls.

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


class DctPoisson(NamedTuple):
    """Transform matrices + inverse kernel for one geometry."""

    mats: Tuple[torch.Tensor, ...]   # one orthonormal DCT matrix per axis
    inv_kernel: torch.Tensor         # 1 / (D^2 * kernel), phi-shaped
    ir: Optional[IrSpec] = None      # f32 solve + f64-residual refinement

    def solve(self, rhs: torch.Tensor, scale=None) -> torch.Tensor:
        """phi = idctn(dctn(rhs) * inv_kernel) (``oper_poisson3dim.m:4``).
        ``scale`` multiplies the inverse kernel at use time (1/D^2 against
        a unit-D build). An IR build solves a float64 rhs by refinement."""
        if self.ir is not None and rhs.dtype == torch.float64:
            return self._solve_ir(rhs, scale)
        y = rhs
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C, y, ax)
        inv_k = self.inv_kernel if scale is None else self.inv_kernel * scale
        y = y * inv_k
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C.T, y, ax)
        return y

    def _base32(self, r: torch.Tensor, scale32) -> torch.Tensor:
        """Plain f32 DCT solve (the IR preconditioner); mats/inv_kernel are
        f32 in IR builds."""
        y = r.to(torch.float32)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C, y, ax)
        y = y * (self.inv_kernel if scale32 is None
                 else self.inv_kernel * scale32)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C.T, y, ax)
        return y

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


def make_dct_poisson(geom: Geometry, D=1.0, epsilon=None, dtype=torch.float32,
                     split=False, ir_steps: int = 2, *,
                     device) -> DctPoisson:
    """Build the solver for  D^2 * (A^T A + epsilon I) phi = rhs.

    epsilon=None pins the zero mode's kernel entry to 1 (pure Neumann
    Poisson, ``initialize_FFTkernel.m:15``); otherwise the Helmholtz shift
    is added (``initialize_FFTkernel.m:17-22``).

    ``split`` selects the f64 strategy (``SPLITS``): False runs the matmuls
    in ``dtype``; "ir" builds the matrices and inverse kernel in float32
    and solves a float64 rhs by ``ir_steps`` refinement rounds; "ir1" is
    the same with one round."""
    if not is_split(split):
        raise ValueError(f"split={split!r}: not one of {SPLITS}")
    full_precision_matmul()
    use_ir = split in ("ir", "ir1")
    if split == "ir1":
        ir_steps = 1
    ns = (geom.nt,) + geom.space
    kernel = np.zeros(ns)
    for ax, n in enumerate(ns):
        shape = [1] * len(ns)
        shape[ax] = n
        kernel = kernel + neumann_eigenvalues(n).reshape(shape)
    if epsilon is None:
        kernel.flat[0] = 1.0  # zero mode: pass-through (pinned)
    else:
        kernel = kernel + epsilon
    mat_dtype = torch.float32 if use_ir else dtype
    inv_kernel = torch.as_tensor(1.0 / (float(D) ** 2 * kernel),
                                 dtype=mat_dtype, device=device)
    mats = tuple(dct_matrix(n, mat_dtype, device) for n in ns)
    ir = None
    if use_ir:
        ir = IrSpec(coeffs=tuple(float((n - 1) ** 2) for n in ns),
                    d2=float(D) ** 2,
                    epsilon=None if epsilon is None else float(epsilon),
                    steps=int(ir_steps))
    return DctPoisson(mats=mats, inv_kernel=inv_kernel, ir=ir)
