"""Multilevel transfer operators; port of
``dotsocp_tpu/multilevel/transfer.py``.

The reference's 2-D full-weighting restriction with boundary
renormalization (``socp/dot2d/utils/downSample_phi.m``) is the separable
application of the 1-D stencil [1/4, 1/2, 1/4] with boundary rows
[2/3, 1/3], so the 1-D operator is applied per axis as a small dense
matmul. Prolongations (``socp/dot2d/utils/interpolate.m``): phi is linear
on the centered grid in every axis; cone-layout fields (beta) are nearest-
neighbour in t and linear in space. Staggered weights (wdot2d) restrict
with the normalized transposes of those prolongations
(``socp/wdot2d/utils/downSample_q.m``), in log space for barrier weights
(``downSample_barrier.m``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.staggered import Staggered


def restrict_matrix_fw(n_fine: int) -> np.ndarray:
    """Full-weighting restriction (n_fine odd) -> (n_fine+1)//2 points:
    interior [1/4, 1/2, 1/4], boundaries [2/3, 1/3]."""
    n_c = (n_fine - 1) // 2 + 1
    R = np.zeros((n_c, n_fine))
    R[0, 0] = 2.0 / 3.0
    R[0, 1] = 1.0 / 3.0
    R[-1, -1] = 2.0 / 3.0
    R[-1, -2] = 1.0 / 3.0
    for i in range(1, n_c - 1):
        j = 2 * i
        R[i, j - 1] = 0.25
        R[i, j] = 0.5
        R[i, j + 1] = 0.25
    return R


def prolong_matrix_linear(n_coarse: int) -> np.ndarray:
    """Linear prolongation on a centered axis: n -> 2(n-1)+1."""
    n_f = 2 * (n_coarse - 1) + 1
    P = np.zeros((n_f, n_coarse))
    for j in range(n_coarse):
        P[2 * j, j] = 1.0
    for j in range(n_coarse - 1):
        P[2 * j + 1, j] = 0.5
        P[2 * j + 1, j + 1] = 0.5
    return P


def prolong_matrix_nearest(n_coarse: int) -> np.ndarray:
    """Nearest prolongation on a staggered axis: n -> 2n."""
    P = np.zeros((2 * n_coarse, n_coarse))
    for j in range(n_coarse):
        P[2 * j, j] = 1.0
        P[2 * j + 1, j] = 1.0
    return P


def _normalized_restriction(P: np.ndarray) -> np.ndarray:
    """R = transpose(P / column_sums(P)) (``downSample_q.m:10-12``)."""
    return (P / P.sum(axis=0, keepdims=True)).T


def _apply_axis(M: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    Mt = torch.as_tensor(M, dtype=x.dtype, device=x.device)
    return torch.tensordot(Mt, x, dims=([1], [axis])).movedim(0, axis)


def restrict_density(rho: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction of a spatial density over every axis."""
    for ax in range(rho.ndim):
        rho = _apply_axis(restrict_matrix_fw(rho.shape[ax]), rho, ax)
    return rho


def prolong_phi(phi: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the centered potential in every axis
    (``interpolate.m: interpolate_phi``)."""
    for ax in range(phi.ndim):
        phi = _apply_axis(prolong_matrix_linear(phi.shape[ax]), phi, ax)
    return phi


def prolong_z_like(z: torch.Tensor) -> torch.Tensor:
    """Prolongation of a (C, nt-1, *space) cone-layout field: nearest in t,
    linear in space, per column (``interpolate.m: interpolate_tStagger``);
    duplicate in t first, as the reference does."""
    z = _apply_axis(prolong_matrix_nearest(z.shape[1]), z, 1)
    for ax in range(2, z.ndim):
        z = _apply_axis(prolong_matrix_linear(z.shape[ax]), z, ax)
    return z.contiguous()


def restrict_staggered(st: Staggered, log_space: bool = False) -> Staggered:
    """Restriction of a shaped q-layout field (a weight) to the next coarser
    staggered grid, in the field's dtype. Along its staggered axis a block
    restricts with the normalized transpose of the nearest prolongation,
    along the others with that of the linear one. ``log_space=True`` is
    ``downSample_barrier.m`` (a geometric mean, so 1e6 walls survive
    coarsening); ``False`` is ``downSample_q.m``."""
    def apply_block(block, stag_axis):
        y = torch.log(block) if log_space else block
        for ax in range(block.ndim):
            n = block.shape[ax]
            if ax == stag_axis:
                R = _normalized_restriction(prolong_matrix_nearest(n // 2))
            else:
                R = _normalized_restriction(
                    prolong_matrix_linear((n - 1) // 2 + 1))
            y = _apply_axis(R, y, ax)
        return (torch.exp(y) if log_space else y).contiguous()

    return Staggered(q0=apply_block(st.q0, 0),
                     bs=tuple(apply_block(b, 1 + a) for a, b in enumerate(st.bs)))
