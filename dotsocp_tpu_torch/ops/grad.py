"""Forward-difference gradient A and its adjoint on shaped fields, as slicing
and zero padding; port of ``dotsocp_tpu/ops/grad.py``.

The reference materialises A as a sparse Kronecker-product matrix
(``socp/dot2d/utils/initialize.m:35-39,67-87``); both directions are
difference stencils, written here in the JAX package's operation order so
that float64 results agree to the last bits. A^T A is the (negative)
space-time Neumann Laplacian, which makes the phi-step a DCT solve
(``ops/poisson.py``).

Fields are shaped ``(..., nt, *space)``: the t axis and the space axes are
counted from the end, so a stack of instances on leading axes (the lockstep
fleet's) goes through one call.
"""
from __future__ import annotations

import torch

from .cone import _pad_axis
from .geometry import Geometry
from .staggered import Staggered


def _diff(x: torch.Tensor, dim: int, h: float) -> torch.Tensor:
    """(x[i+1] - x[i]) / h along ``dim``."""
    n = x.shape[dim]
    return (x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)) / h


def _diff_adjoint(u: torch.Tensor, dim: int, h: float) -> torch.Tensor:
    """Adjoint of :func:`_diff`: out[j] = (u[j-1] - u[j]) / h with u padded
    by a zero on each side (``n - 1`` entries along ``dim`` in, ``n``
    out)."""
    return (_pad_axis(u, dim, 1, 0) - _pad_axis(u, dim, 0, 1)) / h


def grad(geom: Geometry, phi: torch.Tensor) -> Staggered:
    """A phi: q0 = D_t phi (time-staggered), bs[a] = D_a phi
    (face-staggered); ``model.grad * phi`` of ``initialize.m:35-39``."""
    d = geom.ndim_space
    t = phi.ndim - d - 1
    return Staggered(
        q0=_diff(phi, t, geom.ht),
        bs=tuple(_diff(phi, t + 1 + a, geom.hs(a)) for a in range(d)))


def grad_T(geom: Geometry, st: Staggered) -> torch.Tensor:
    """A^T of a staggered field, a centred field."""
    d = geom.ndim_space
    t = st.q0.ndim - d - 1
    out = _diff_adjoint(st.q0, t, geom.ht)
    for a in range(d):
        out = out + _diff_adjoint(st.bs[a], t + 1 + a, geom.hs(a))
    return out
