"""Red-black symmetric Gauss-Seidel smoother for the scaled space-time
Neumann Laplacian  d2 * A^T A phi = rhs; port of ``dotsocp_tpu/ops/sgs.py``
in the form the JAX solver uses it: built with D = 1, the scale d2 = D^2
passed to every call (the ``eps`` shift, 0 at every caller there, and the
baked-D form are not ported).

One symmetric sweep = forward (B, A) + backward (A, B) half-sweeps, which
collapses to B, A, B since repeating a colour with unchanged neighbours is
a no-op. Colour A is the class containing the grid origin, the class whose
residual the reference monitors (``solver_socp_sGSinPALM.m:213-217``).

Fields are shaped ``(nt, *space)``; the solver's flat ``(nt, S)`` phi is
the same buffer reshaped. This module is the plain PyTorch version of the
sweep kernel (``ops/sgs_sweep.py``, ``csrc/sgs_sweep.cu``). Passing d2 per
call, as the JAX package's traced-``d2`` path does, means a level never
rebuilds the smoother.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import Geometry


def _axis_h2inv(geom: Geometry):
    """1/h^2 per array axis (t first)."""
    return [float((n - 1) ** 2) for n in (geom.nt,) + geom.space]


def checkerboard(geom: Geometry) -> np.ndarray:
    """Parity mask over (nt, *space); True = colour A (contains the origin,
    the reference's odd-linear-index class)."""
    ns = (geom.nt,) + geom.space
    acc = np.zeros((), dtype=np.int64)
    for ax, n in enumerate(ns):
        shape = [1] * len(ns)
        shape[ax] = n
        acc = acc + np.arange(n).reshape(shape)
    return (acc % 2) == 0


def _pad_axis(x: torch.Tensor, ax: int, lo: int, hi: int) -> torch.Tensor:
    pad = [0, 0] * x.ndim
    # F.pad lists (lo, hi) pairs from the last axis backwards
    pad[2 * (x.ndim - 1 - ax)] = lo
    pad[2 * (x.ndim - 1 - ax) + 1] = hi
    return F.pad(x, pad)


class RedBlackSGS:
    """The smoother's constants: 1/diag(A^T A) and the colour-A mask, both
    phi-shaped, and the per-axis weights 1/h^2."""

    def __init__(self, geom: Geometry, inv_diag: torch.Tensor,
                 mask_a: torch.Tensor, h2inv):
        self.geom = geom
        self.inv_diag = inv_diag
        self.mask_a = mask_a
        self.h2inv = tuple(h2inv)

    def _neighbor_sum(self, phi: torch.Tensor) -> torch.Tensor:
        """Sum of neighbour values weighted by 1/h^2 per axis, t first
        (zero beyond the boundary: Neumann drops the missing neighbour)."""
        out = torch.zeros_like(phi)
        for ax, w in enumerate(self.h2inv):
            n = phi.shape[ax]
            lo = _pad_axis(phi.narrow(ax, 0, n - 1), ax, 1, 0)   # phi[p-1]
            hi = _pad_axis(phi.narrow(ax, 1, n - 1), ax, 0, 1)   # phi[p+1]
            out = out + w * (lo + hi)
        return out

    def _half_sweep(self, phi, rhs, color_a: bool, d2: float):
        new = (rhs + d2 * self._neighbor_sum(phi)) * (self.inv_diag / d2)
        mask = self.mask_a if color_a else ~self.mask_a
        return torch.where(mask, new, phi)

    def sweep(self, phi, rhs, its: int = 1, *, d2: float) -> torch.Tensor:
        """``its`` symmetric red-black sweeps (B, A, B) of M = d2 A^T A."""
        for _ in range(its):
            phi = self._half_sweep(phi, rhs, color_a=False, d2=d2)
            phi = self._half_sweep(phi, rhs, color_a=True, d2=d2)
            phi = self._half_sweep(phi, rhs, color_a=False, d2=d2)
        return phi

    def residual(self, phi, rhs, *, d2: float) -> torch.Tensor:
        """rhs - M phi (full grid)."""
        diag_term = phi / (self.inv_diag / d2)
        return rhs - diag_term + d2 * self._neighbor_sum(phi)

    def residual_color_a_norm(self, phi, rhs, h, *,
                              d2: float) -> torch.Tensor:
        """sqrt(h) * || (rhs - M phi)[colour A] ||: the monitored sGS-block
        residual (``solver_socp_sGSinPALM.m:216``), a 0-d tensor."""
        r = torch.where(self.mask_a, self.residual(phi, rhs, d2=d2),
                        torch.zeros((), dtype=phi.dtype, device=phi.device))
        return torch.sqrt(h * torch.sum(torch.square(r)))


def make_sgs(geom: Geometry, *, dtype: torch.dtype = torch.float32,
             device="cpu") -> RedBlackSGS:
    ns = (geom.nt,) + geom.space
    h2inv = _axis_h2inv(geom)
    diag = np.zeros(ns)
    for ax, w in enumerate(h2inv):
        deg = np.full(ns[ax], 2.0)
        deg[0] = deg[-1] = 1.0
        shape = [1] * len(ns)
        shape[ax] = ns[ax]
        diag = diag + w * deg.reshape(shape)
    return RedBlackSGS(
        geom=geom,
        inv_diag=torch.as_tensor(1.0 / diag, dtype=dtype, device=device),
        mask_a=torch.as_tensor(checkerboard(geom), device=device),
        h2inv=h2inv,
    )
