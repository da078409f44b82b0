"""Operator engines of one process: the flat engine ``OpsFlat``, port of
``dotsocp_tpu/ops/engine.py:126-333`` with the flat Poisson wrapper, which
every level of one process runs, and the shaped engine ``Ops3D``
(``engine.py:60-123``, the JAX package's ``"3d"`` layout), the flat
engine's independent oracle: the tests and the native check on the card
construct it; no solver does.

Flat: every field stores its spatial axes flattened into one trailing axis
of S = prod(space) elements. Face blocks are kept in cell-shaped ``(nt, S)``
arrays with a **ghost slot** (coordinate n_a - 1 along axis a) pinned to
zero, so a spatial shift by one cell along axis a is a flat shift by
stride_a whose zero fill lands exactly where the staggered boundary needs
zeros. Only the two producers of face arrays (``grad``, ``bfd_T``) multiply
their output by the ghost mask. All face blocks of a field are one
``(d, nt, S)`` tensor (see ``ops/staggered.py``).

Shaped: fields keep their grid axes, ``(nt, *space)``, and face blocks are
a tuple of ``(nt, ..., n_a - 1, ...)`` tensors; the operators are those of
``ops/grad.py`` and ``ops/cone.py``. Both engines compute the same values
in the same operation order. The kernels that take ``ops`` run on the flat
engine only (``fused_step.on_kernel``); the sGS sweep and the cone
projection take shaped fields as they are.

Under a mesh the halo engine (``ops/halo_engine.py``) takes these ones'
place, with the same methods (:func:`make_ops`); ``psum`` is where a norm's
sum of squares would be summed over the mesh, the identity here.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import cone
from .geometry import Geometry
from .grad import grad as grad_shaped, grad_T as grad_T_shaped
from .poisson import make_dct_poisson
from .staggered import Staggered

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def flat_sfwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[..., i] = x[..., i - k] with zero fill, any k >= 0 (pad and
    slice; ``dotsocp_tpu/ops/pallas_kernels.py:280-283``)."""
    S = x.shape[-1]
    k = min(k, S)
    return F.pad(x[..., : S - k], (k, 0))


def flat_sbwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[..., i] = x[..., i + k] with zero fill, any k >= 0."""
    S = x.shape[-1]
    k = min(k, S)
    return F.pad(x[..., k:], (0, k))


class OpsFlat:
    """Flat-space engine: fields carry (time, S) with S = prod(space)."""

    layout = "flat"
    mesh = None
    # the column axis of a (..., C, nt-1, S) cone array
    cone_dim = -3

    def __init__(self, geom: Geometry, dtype: torch.dtype, device):
        self.geom = geom
        self.dtype = dtype
        self.device = torch.device(device)
        d = geom.ndim_space
        self.S = int(np.prod(geom.space))
        self.strides = tuple(int(np.prod(geom.space[a + 1:])) for a in range(d))
        # ghost mask per axis: 0 where coord_a == n_a - 1, 1 elsewhere; (d, 1, S)
        # so it broadcasts over the time axis of a (d, nt, S) face tensor
        coords = [(np.arange(self.S) // self.strides[a]) % geom.space[a]
                  for a in range(d)]
        masks = np.stack([(c != geom.space[a] - 1) for a, c in enumerate(coords)])
        self.masks = torch.as_tensor(masks[:, None, :], dtype=dtype,
                                     device=self.device)

    @staticmethod
    def psum(t: torch.Tensor) -> torch.Tensor:
        """A partial sum over the mesh: one process holds the whole field."""
        return t

    # -- flat shifts --------------------------------------------------------
    def _sfwd(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """y[..., i] = x[..., i - stride_a] (zeros shifted in)."""
        return flat_sfwd(x, self.strides[a])

    def _sbwd(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """y[..., i] = x[..., i + stride_a] (zeros shifted in)."""
        return flat_sbwd(x, self.strides[a])

    # -- operators ----------------------------------------------------------
    def grad(self, phi: torch.Tensor) -> Staggered:
        """A phi. phi: (nt, S) -> Staggered(q0 (nt-1, S), bs (d, nt, S))."""
        geom = self.geom
        q0 = (phi[1:] - phi[:-1]) / geom.ht
        bs = torch.stack([
            ((self._sbwd(phi, a) - phi) / geom.hs(a)) * self.masks[a]
            for a in range(geom.ndim_space)
        ])
        return Staggered(q0=q0, bs=bs)

    def grad_T(self, st: Staggered) -> torch.Tensor:
        """A^T. Ghost-zero faces supply the boundary zeros of the adjoint
        differences, so no masks are needed here. Leading axes (a batch of
        instances: q0 ``(..., nt-1, S)``, bs ``(..., d, nt, S)``) pass
        through."""
        geom = self.geom
        q0 = st.q0
        out = (F.pad(q0, (0, 0, 1, 0)) - F.pad(q0, (0, 0, 0, 1))) / geom.ht
        for a in range(geom.ndim_space):
            b = st.bs[..., a, :, :]
            out = out + (self._sfwd(b, a) - b) / geom.hs(a)
        return out

    def bfd(self, q: Staggered, scale_bf, scale_d, sv=None) -> torch.Tensor:
        """z2 = scale_bf * (BF q) + scale_d * d, shape (C, nt-1, S). Column
        order per axis: [t_lo x_lo, t_lo x_hi, t_hi x_lo, t_hi x_hi].
        ``sv`` is scale_bf / sqrt2 as the caller rounded it (the device
        driver's tensor scalars, ``algorithms/core.EScalars``); None forms
        it here."""
        geom = self.geom
        nt = geom.nt
        cols = [scale_d - scale_bf * q.q0]
        s = scale_bf * _INV_SQRT2 if sv is None else sv
        for a in range(geom.ndim_space):
            x_lo = self._sfwd(q.bs[a], a)   # face j-1 at cell j (0 at j=0)
            x_hi = q.bs[a]                  # face j at cell j (ghost: 0)
            for t_sel in (slice(0, nt - 1), slice(1, nt)):
                cols.append(s * x_lo[t_sel])
                cols.append(s * x_hi[t_sel])
        cols.append(scale_d + scale_bf * q.q0)
        return torch.stack(cols, dim=0)

    def bfd_T(self, x: torch.Tensor, scale_bf, sv=None) -> Staggered:
        """q2 = scale_bf * (BF)^T x; ghost slots re-zeroed by the axis mask;
        ``sv`` as in :meth:`bfd`."""
        geom = self.geom
        q0 = scale_bf * (x[-1] - x[0])
        s = scale_bf * _INV_SQRT2 if sv is None else sv
        bs = []
        col = 1
        for a in range(geom.ndim_space):
            acc = None
            for t_lo in (True, False):
                for x_lo in (True, False):
                    xi = x[col]
                    col += 1
                    y = self._sbwd(xi, a) if x_lo else xi
                    y = F.pad(y, (0, 0, 0, 1) if t_lo else (0, 0, 1, 0))
                    acc = y if acc is None else acc + y
            bs.append((s * acc) * self.masks[a])
        return Staggered(q0=q0, bs=torch.stack(bs))

    def oper_q_diag(self, D: float, E: float,
                    weight: Optional[Staggered] = None) -> Staggered:
        """Diagonal of D_w*D_w + (E/D)^2 F*B*BF: base + w*w, base being
        2(E/D)^2 and (E/D)^2 on the two boundary time slabs of the face
        blocks (``dotsocp_tpu/ops/engine.py:224-244``). Unweighted (w = 1,
        ``oper_q.m``) the two values are formed in double precision
        (``diag_values``); weighted (``wdot2d/utils/oper_q.m``) base + w*w
        is summed in the weight's dtype, as the JAX package does. Ghost
        slots get the interior base (+ 1, the flat weight's ghost value):
        harmless, every numerator that multiplies 1/diag is exactly zero
        there."""
        if weight is None:
            inner, bnd = diag_values(D, E)
        else:
            inner, bnd = base_values(D, E)
        geom = self.geom
        kw = dict(dtype=self.dtype if weight is None else weight.dtype,
                  device=self.device)
        q0 = torch.full((geom.nt - 1, self.S), inner, **kw)
        bs = torch.full((geom.ndim_space, geom.nt, self.S), inner, **kw)
        bs[:, 0] = bnd
        bs[:, -1] = bnd
        diag = Staggered(q0=q0, bs=bs)
        return diag if weight is None else diag + weight * weight

    def make_poisson(self, D: float = 1.0, split=False) -> "FlatPoisson":
        inner = make_dct_poisson(self.geom, D=D, dtype=self.dtype,
                                 split=split, device=self.device)
        return FlatPoisson(inner, self.geom)

    def t_edge_row(self, d_in, d_bd, like: torch.Tensor) -> torch.Tensor:
        """The per-time factor of the unweighted q-step diagonal's inverse
        on face blocks: ``d_bd`` on the two boundary time slabs, ``d_in``
        elsewhere, in ``like``'s dtype (``fused_step.times_dinv``)."""
        # fill_ takes a float as a kernel argument and a 0-d tensor (the
        # device driver's) from memory: no copy from the host, which a CUDA
        # graph capture would refuse
        row = torch.empty((self.geom.nt, 1), dtype=like.dtype,
                          device=like.device).fill_(d_in)
        row[0].fill_(d_bd)
        row[-1].fill_(d_bd)
        return row

    def demean(self, phi: torch.Tensor) -> torch.Tensor:
        """phi minus its mean (the sGS methods' prep)."""
        return phi - torch.mean(phi)

    def face_interp(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """0.5 * (x[j] + x[j+1]) at face slot j. The ghost slot holds
        garbage from the next row; every consumer multiplies it by a
        ghost-zero face array."""
        return 0.5 * (x + self._sbwd(x, a))

    def t_node_interp(self, x: torch.Tensor) -> torch.Tensor:
        """Time-staggered -> time-node interpolation with zero-padded ends
        (``compute_kkt_dot_complement.m`` movmean): (nt-1, S) -> (nt, S)."""
        padded = F.pad(x, (0, 0, 1, 1))
        return 0.5 * (padded[:-1] + padded[1:])

    # -- layout conversions --------------------------------------------------
    def stag_to_internal(self, st: Staggered) -> Staggered:
        geom = self.geom
        q0 = st.q0.reshape(geom.nt - 1, self.S)
        bs = []
        for a in range(geom.ndim_space):
            pad = [0, 0] * st.bs[a].ndim
            # F.pad lists (lo, hi) pairs from the last axis backwards
            pad[2 * (st.bs[a].ndim - 2 - a) + 1] = 1
            bs.append(F.pad(st.bs[a], pad).reshape(geom.nt, self.S))
        return Staggered(q0=q0, bs=torch.stack(bs))

    def stag_from_internal(self, st: Staggered) -> Staggered:
        geom = self.geom
        q0 = st.q0.reshape((geom.nt - 1,) + geom.space)
        bs = []
        for a in range(geom.ndim_space):
            b = st.bs[a].reshape((geom.nt,) + geom.space)
            bs.append(b.narrow(1 + a, 0, geom.space[a] - 1))
        return Staggered(q0=q0, bs=tuple(bs))

    def weight_to_internal(self, w: Staggered) -> Staggered:
        """A shaped weight in the flat layout, ghost slots padded with 1.0
        (any finite value works: they only ever multiply exact zeros;
        ``dotsocp_tpu/ops/engine.py:283-297``)."""
        geom = self.geom
        bs = []
        for a in range(geom.ndim_space):
            pad = [0, 0] * w.bs[a].ndim
            pad[2 * (w.bs[a].ndim - 2 - a) + 1] = 1
            bs.append(F.pad(w.bs[a], pad, value=1.0).reshape(geom.nt, self.S))
        return Staggered(q0=w.q0.reshape(geom.nt - 1, self.S).contiguous(),
                         bs=torch.stack(bs))

    def z_to_internal(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(tuple(z.shape[:2]) + (self.S,))

    def z_from_internal(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(tuple(z.shape[:2]) + self.geom.space)

    def phi_to_internal(self, phi: torch.Tensor) -> torch.Tensor:
        return phi.reshape(phi.shape[0], self.S)

    def phi_from_internal(self, phi: torch.Tensor) -> torch.Tensor:
        return phi.reshape((phi.shape[0],) + self.geom.space)


class Ops3D:
    """Shaped engine: fields ``(..., nt, *space)``, face blocks a tuple of
    per-axis tensors, cone arrays ``(..., C, nt-1, *space)``; leading axes
    (a stack of instances) pass through every operator."""

    layout = "3d"
    mesh = None

    def __init__(self, geom: Geometry, dtype: torch.dtype, device):
        self.geom = geom
        self.dtype = dtype
        self.device = torch.device(device)
        self.d = geom.ndim_space
        # the column axis of a cone array
        self.cone_dim = -(self.d + 2)

    psum = staticmethod(OpsFlat.psum)

    def _tdim(self, x: torch.Tensor) -> int:
        """The t axis of a phi-, cell- or face-shaped field."""
        return x.ndim - self.d - 1

    # -- operators ------------------------------------------------------------
    def grad(self, phi: torch.Tensor) -> Staggered:
        return grad_shaped(self.geom, phi)

    def grad_T(self, st: Staggered) -> torch.Tensor:
        return grad_T_shaped(self.geom, st)

    def bfd(self, q: Staggered, scale_bf, scale_d, sv=None) -> torch.Tensor:
        return cone.bfd(self.geom, q, scale_bf, scale_d, sv)

    def bfd_T(self, x: torch.Tensor, scale_bf, sv=None) -> Staggered:
        return cone.bfd_T(self.geom, x, scale_bf, sv)

    def oper_q_diag(self, D: float, E: float,
                    weight: Optional[Staggered] = None) -> Staggered:
        return cone.oper_q_diag(self.geom, D, E, weight, dtype=self.dtype,
                                device=self.device)

    def make_poisson(self, D: float = 1.0, split=False):
        """The shaped DCT solve (``ops/poisson.DctPoisson``), which takes
        leading axes."""
        return make_dct_poisson(self.geom, D=D, dtype=self.dtype,
                                split=split, device=self.device)

    def t_edge_row(self, d_in, d_bd, like: torch.Tensor) -> torch.Tensor:
        """``OpsFlat.t_edge_row`` shaped ``(nt, 1, ..., 1)``, to broadcast
        over every face block."""
        return OpsFlat.t_edge_row(self, d_in, d_bd, like).reshape(
            (self.geom.nt,) + (1,) * self.d)

    demean = OpsFlat.demean

    def face_interp(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """Average a node-positioned field onto the faces of axis a."""
        ax = x.ndim - self.d + a
        n_a = self.geom.space[a]
        return 0.5 * (x.narrow(ax, 0, n_a - 1) + x.narrow(ax, 1, n_a - 1))

    def t_node_interp(self, x: torch.Tensor) -> torch.Tensor:
        """Time-staggered -> time-node interpolation with zero-padded ends:
        (..., nt-1, *space) -> (..., nt, *space)."""
        t = self._tdim(x)
        padded = cone._pad_axis(x, t, 1, 1)
        n = padded.shape[t] - 1
        return 0.5 * (padded.narrow(t, 0, n) + padded.narrow(t, 1, n))

    # -- layout conversions: the identity --------------------------------------
    def stag_to_internal(self, st: Staggered) -> Staggered:
        return st

    def stag_from_internal(self, st: Staggered) -> Staggered:
        return st

    def weight_to_internal(self, w: Staggered) -> Staggered:
        """The shaped weight as it is: there are no ghost slots to fill."""
        return w

    def z_to_internal(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def z_from_internal(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def phi_to_internal(self, phi: torch.Tensor) -> torch.Tensor:
        return phi

    def phi_from_internal(self, phi: torch.Tensor) -> torch.Tensor:
        return phi


def make_ops(geom: Geometry, dtype: torch.dtype, device, mesh=None):
    """The level's engine: the flat engine on one process, the halo engine
    on a mesh."""
    if mesh is not None:
        from .halo_engine import OpsHalo

        return OpsHalo(geom, dtype, device, mesh)
    return OpsFlat(geom, dtype, device)


def diag_values(D: float, E: float):
    """(interior, boundary-slab) entries of the q-step diagonal, in the
    operation order of ``dotsocp_tpu/ops/engine.py:224-244``."""
    tmp = (E / D) ** 2
    return 2.0 * tmp + 1.0, tmp + 1.0


def base_values(D: float, E: float):
    """(interior, boundary-slab) entries of the diagonal of (E/D)^2 F*B*BF,
    which the weighted q-step adds to w*w."""
    tmp = (E / D) ** 2
    return 2.0 * tmp, tmp


class FlatPoisson:
    """DCT Poisson solve on the flat layout: reshape to the shaped axes for
    the per-axis matmuls and back. Leading axes before ``(nt, S)`` (a
    batch of instances) pass through."""

    def __init__(self, inner, geom: Geometry):
        self.inner = inner
        self.geom = geom

    def solve(self, rhs: torch.Tensor, scale=None) -> torch.Tensor:
        shaped = rhs.reshape(tuple(rhs.shape[:-1]) + self.geom.space)
        return self.inner.solve(shaped, scale=scale).reshape(rhs.shape)
