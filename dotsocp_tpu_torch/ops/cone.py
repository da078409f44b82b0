"""Per-cell cone operators on shaped fields: the BF gather, its adjoint,
the Lorentz projection and the diagonal of I + (E/D)^2 F* B* B F; port of
``dotsocp_tpu/ops/cone.py`` (the reference's ``mexBFd``, ``mexBFdConj``,
``mexProjSoc`` and ``oper_q.m``). The shaped engine ``ops/engine.Ops3D``
wraps them; the flat engine (``OpsFlat``) computes the same values on its
flat layout, in the same operation order.

Cone-column convention (C = 2 + 4d columns per time-staggered cell):

  col 0      : scaleD - scaleBF * q0[cell]            (head of the cone)
  cols 1+4a..4+4a (axis a): scaleBF/sqrt(2) * the four face values of b_a
               bounding the cell, in the order [t-lo,x-lo], [t-lo,x-hi],
               [t-hi,x-lo], [t-hi,x-hi]; out-of-domain faces contribute 0
  col C-1    : scaleD + scaleBF * q0[cell]

Shaped fields may carry leading axes (a stack of instances): the t axis,
the space axes and the column axis of a cone array ``(..., C, nt-1,
*space)`` are counted from the end.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .geometry import Geometry
from .staggered import Staggered

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero padding of ``lo`` / ``hi`` entries along ``axis``."""
    pad = [0, 0] * (x.ndim - axis % x.ndim)
    # F.pad lists (lo, hi) pairs from the last axis backwards
    pad[-2], pad[-1] = lo, hi
    return F.pad(x, pad)


def bfd(geom: Geometry, q: Staggered, scale_bf, scale_d,
        sv=None) -> torch.Tensor:
    """z2 = scale_bf * (BF q) + scale_d * d, shape (..., C, nt-1, *space)
    (``mexBFd``, ``solver_socp_inPALM.m:133,212``). ``sv`` is scale_bf /
    sqrt2 as the caller rounded it (the device driver's tensor scalars);
    None forms it here."""
    d = geom.ndim_space
    t = q.q0.ndim - d - 1
    nt = geom.nt
    cols = [scale_d - scale_bf * q.q0]
    s = scale_bf * _INV_SQRT2 if sv is None else sv
    for a in range(d):
        ax = t + 1 + a
        n_a = geom.space[a]
        # faces of axis a padded on both sides: aligned with cell centres
        bp = _pad_axis(q.bs[a], ax, 1, 1)
        x_lo = bp.narrow(ax, 0, n_a)
        x_hi = bp.narrow(ax, 1, n_a)
        for t0 in (0, 1):
            cols.append(s * x_lo.narrow(t, t0, nt - 1))
            cols.append(s * x_hi.narrow(t, t0, nt - 1))
    cols.append(scale_d + scale_bf * q.q0)
    return torch.stack(cols, dim=t)


def bfd_T(geom: Geometry, x: torch.Tensor, scale_bf, sv=None) -> Staggered:
    """q2 = scale_bf * (BF)^T x, the scatter-free adjoint of the gather as
    shifted adds (``mexBFdConj``, ``solver_socp_inPALM.m:205,225``); ``sv``
    as in :func:`bfd`."""
    d = geom.ndim_space
    c = x.ndim - d - 2
    C = x.shape[c]
    q0 = scale_bf * (x.select(c, C - 1) - x.select(c, 0))
    s = scale_bf * _INV_SQRT2 if sv is None else sv
    # after a column is selected, t sits where the column axis was
    t = c
    bs = []
    col = 1
    for a in range(d):
        ax = t + 1 + a
        acc = None
        for t_lo in (True, False):
            for x_lo in (True, False):
                xi = x.select(c, col)
                col += 1
                # time: cells (nt-1) -> face time-nodes (nt)
                y = _pad_axis(xi, t, 0 if t_lo else 1, 1 if t_lo else 0)
                # space: cells (n_a) -> padded faces (n_a + 1)
                y = _pad_axis(y, ax, 0 if x_lo else 1, 1 if x_lo else 0)
                acc = y if acc is None else acc + y
        # drop the two ghost faces
        bs.append(s * acc.narrow(ax, 1, geom.space[a] - 1))
    return Staggered(q0=q0, bs=tuple(bs))


def proj_soc(v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Row-wise projection onto K = {z: z[0] >= ||z[1:]||} over axis
    ``dim`` (the engines' ``cone_dim`` for a stack of instances).

    Branch-free: coef = clip((1 + z0/||w||)/2, 0, 1); head = max(z0,
    coef*||w||) covers the interior, boundary-projection and zero cases,
    with the ``nrm > 0`` guard exactly as in the JAX version."""
    z0 = v.select(dim, 0)
    w = v.narrow(dim, 1, v.shape[dim] - 1)
    nrm = torch.sqrt(torch.sum(w * w, dim=dim))
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    coef = torch.clamp(0.5 * (1.0 + z0 / safe), 0.0, 1.0)
    head = torch.maximum(z0, coef * nrm)
    return torch.cat([head.unsqueeze(dim), coef.unsqueeze(dim) * w],
                     dim=dim)


def oper_q_diag(geom: Geometry, D, E, weight: Staggered | None = None,
                dtype=torch.float32, device="cpu") -> Staggered:
    """Diagonal of D_w^* D_w + (E/D)^2 F^* B^* B F on the shaped staggered
    grid. Unweighted (w = 1, ``socp/dot2d/utils/oper_q.m``): 1 + 2(E/D)^2
    in the interior, 1 + (E/D)^2 on the two boundary time slabs of the face
    blocks; weighted (``socp/wdot2d/utils/oper_q.m``) the identity is w^2,
    in the weight's dtype. Both are base + w^2, formed as the JAX package
    forms them: (E/D)^2 rounded to the dtype, then the sums."""
    if weight is not None:
        dtype = weight.dtype
        device = weight.q0.device
    tmp = torch.tensor((E / D) ** 2, dtype=dtype, device=device)
    q0 = torch.full(geom.q0_shape, 2.0, dtype=dtype, device=device) * tmp
    bs = []
    for a in range(geom.ndim_space):
        b = torch.full(geom.b_shape(a), 2.0, dtype=dtype, device=device) * tmp
        # the boundary time slabs take part in one cell only
        b[0] = tmp
        b[-1] = tmp
        bs.append(b)
    base = Staggered(q0=q0, bs=tuple(bs))
    if weight is None:
        return base.map(lambda b: b + torch.ones_like(b))
    return base + weight * weight
