"""Halo-exchange engine: shaped fields padded to mesh multiples, each rank
holding one block and exchanging one-slab halos with its neighbours; port
of ``dotsocp_tpu/ops/halo_engine.py`` (``OpsHalo`` :98-449,
``_HaloPoisson`` :451-488, ``HaloSGS`` :490-595) from ``shard_map`` to
SPMD ranks on ``torch.distributed`` (``parallel/comm.py``).

Layout contract (``halo_engine.py:14-26``), per rank:

- a centered field is the rank's block of ``(Pt, *P)`` with P_a = k_a *
  ceil(n_a / k_a) (k_a the mesh extent of space axis a); entries at
  coord_a >= n_a are structural zeros;
- face blocks are stored cell-shaped, all axes in one ``(d, Pt, *P)``
  block tensor, with the ghost slot coord_a == n_a - 1 *and* the pads
  pinned to zero;
- ``grad`` and ``bfd_T``, the two producers of face arrays, re-mask their
  outputs; ``bfd`` masks its whole cone block (the +scale_d constant must
  not reach a pad cell); every other operation is element-wise and keeps
  the zeros, so norms and dot products over the blocks, summed over the
  mesh (``psum``), are the unpadded ones.

Mesh axes: ``x`` (1D), ``y`` ``x`` (2D), ``z`` ``y`` ``x`` (3D); an axis the
mesh lacks is not split. A ``batch`` axis of extent > 1 is refused: a
fleet's level runs on its batch row (``Mesh.row``), so that every sum
over the mesh stays within one instance. A ``t`` axis splits time too: every
time-staggered array then shares the padded node extent Pt with a zero
ghost slab at t = nt - 1, so cell k and node k sit on one rank and the BF
time coupling is one slab (``halo_engine.py:131-152``); without it time
stays unpadded (nt nodes, nt - 1 cells). A mesh that splits no axis of the
grid raises.

Leading axes: every operator counts the t axis, the face axis of a face
block and the column axis of a cone array from the end, so a stack of
instances on a leading axis (the lockstep fleet's ``(B, ...)`` blocks)
goes through one call, one halo exchange and one all-gather for all of
them, each instance's result bit-equal to the operator on it alone.

The phi-step is the exact DCT solve on zero-extended matrices
(``_HaloPoisson``): along an axis the mesh splits, the rank gathers the
axis's shards (``comm.all_gather``) and applies its own rows of the
matrix, so the result is the rank's block of the transform. The inverse
kernel's pads hold 1.0 (they multiply zero coefficients).

Its ops are plain PyTorch on the rank's block, as the JAX package launches
no Pallas kernel under a mesh (``dotsocp_tpu/multilevel/solve.py:228``);
the route of the CUDA kernels that read neighbouring cells on halo-padded
blocks waits in ROADMAP.md queue 6 item 10. (The acc methods' cone
projection, pointwise, runs its kernel on the block:
``algorithms/variants.py``.)
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import comm
from .engine import base_values, diag_values
from .geometry import Geometry
from .poisson import (_apply_axis, _inverse_kernel, dct_matrix,
                      full_precision_matmul)
from .staggered import Staggered

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
SPACE_NAMES = {1: ("x",), 2: ("y", "x"), 3: ("z", "y", "x")}


def _pad_dim(x: torch.Tensor, dim: int, lo: int, hi: int,
             value: float = 0.0) -> torch.Tensor:
    pad = [0, 0] * x.ndim
    # F.pad lists (lo, hi) pairs from the last axis backwards
    pad[2 * (x.ndim - 1 - dim)] = lo
    pad[2 * (x.ndim - 1 - dim) + 1] = hi
    return F.pad(x, pad, value=value)


class OpsHalo:
    """The shaped engine on one rank's block of the mesh-padded grid."""

    layout = "halo"

    def __init__(self, geom: Geometry, dtype: torch.dtype, device, mesh):
        if mesh is None:
            raise ValueError("layout='halo' requires a mesh")
        d = geom.ndim_space
        if d not in (1, 2, 3):
            raise NotImplementedError("halo layout supports 1D/2D/3D grids")
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not in the mesh")
        if mesh.shape.get("batch", 1) > 1:
            raise ValueError(
                f"mesh {mesh.shape}: its batch axis carries independent "
                f"instances, and a sum over the whole mesh would add them "
                f"together; build the level on the rank's batch row "
                f"(mesh.row())")
        self.geom = geom
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = mesh
        self.d = d
        self.names = SPACE_NAMES[d]
        # space axes the mesh lacks are not split (k = 1): a 3D grid on a
        # (y, x) mesh splits two of its three axes
        self.k = tuple(mesh.shape.get(n, 1) for n in self.names)
        self.kt = mesh.shape.get("t", 1)
        if all(k == 1 for k in self.k):
            raise ValueError(
                f"mesh {mesh.shape} shares no spatial axis with "
                f"{self.names}; use axis names from {self.names}")
        self.P = tuple(-(-n // k) * k for n, k in zip(geom.space, self.k))
        self.L = tuple(p // k for p, k in zip(self.P, self.k))
        self.off = tuple(mesh.coords.get(n, 0) * l
                         for n, l in zip(self.names, self.L))
        self.sharded_t = self.kt > 1
        # padded t extents: node (phi/c) and cell (q0/z) arrays share Pt
        # when t is split; unpadded nt / nt - 1 otherwise
        self.Pt = (-(-geom.nt // self.kt) * self.kt if self.sharded_t
                   else geom.nt)
        self.Pt_cell = self.Pt if self.sharded_t else geom.nt - 1
        self.Lt = self.Pt // self.kt
        self.Lt_cell = self.Pt_cell // self.kt
        self.off_t = mesh.coords.get("t", 0) * self.Lt
        self.t_name = "t" if self.sharded_t else None
        # the column axis of a cone array, the face axis of a face block
        self.cone_dim = -(d + 2)
        self._masks = {}

    @property
    def phi_padded_shape(self):
        return (self.Pt,) + self.P

    def axis_comm(self, ax: int):
        """(mesh axis name or None, extent) of a phi-layout array axis
        (0 = t)."""
        if ax == 0:
            return self.t_name, self.kt
        return self.names[ax - 1], self.k[ax - 1]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial sums ``t`` (``comm.psum``)."""
        return comm.psum(t, self.mesh)

    # -- masks: the rank's slice of broadcastable 1-D factors --------------
    def _vec(self, length, real, off, local, ndim, ax):
        key = (length, real, off, local, ndim, ax)
        m = self._masks.get(key)
        if m is None:
            v = np.zeros(length)
            v[:real] = 1.0
            shape = [1] * ndim
            shape[ax] = local
            m = torch.as_tensor(v[off:off + local].reshape(shape),
                                dtype=self.dtype, device=self.device)
            self._masks[key] = m
        return m

    def _face_mask(self, a: int, ndim: int):
        return self._vec(self.P[a], self.geom.space[a] - 1, self.off[a],
                         self.L[a], ndim, ndim - self.d + a)

    def _t_mask(self, ndim: int, cell: bool):
        """1 where the t-coordinate is real (nt - 1 cells, nt nodes); None
        when t is not split (unpadded)."""
        if not self.sharded_t:
            return None
        real = self.geom.nt - 1 if cell else self.geom.nt
        return self._vec(self.Pt, real, self.off_t, self.Lt, ndim,
                         ndim - self.d - 1)

    def _cell_mask(self, ndim: int, t_cell: bool = False, t_node=False):
        m = None
        for a in range(self.d):
            v = self._vec(self.P[a], self.geom.space[a], self.off[a],
                          self.L[a], ndim, ndim - self.d + a)
            m = v if m is None else m * v
        if t_cell or t_node:
            tm = self._t_mask(ndim, cell=t_cell)
            if tm is not None:
                m = m * tm
        return m

    # -- axes counted from the end (leading batch axes pass through) ----------
    def _tdim(self, x) -> int:
        """The t axis of a phi-, cell- or face-shaped block."""
        return x.ndim - self.d - 1

    def _face(self, bs, a: int):
        """Axis a's face block of a ``(..., d, T, *L)`` tensor."""
        return bs.select(bs.ndim - self.d - 2, a)

    def _col(self, x, c: int):
        """Column c of a ``(..., C, T, *L)`` cone array."""
        return x.select(x.ndim - self.d - 2, c)

    def _stack(self, parts):
        """Face blocks or cone columns stacked on the axis before t."""
        return torch.stack(parts, dim=self._tdim(parts[0]))

    # -- halo shifts ---------------------------------------------------------
    def _shift(self, x, a: int, fwd: bool):
        """Space axis a: y[i] = x[i-1] (``fwd``) or x[i+1]."""
        return self._shifts([(x, a, fwd)])[0]

    def _shifts(self, items):
        """:meth:`_shift` of each ``(x, a, fwd)``, exchanged as one batch."""
        return comm.shifts([(x, x.ndim - self.d + a, self.names[a], fwd)
                            for x, a, fwd in items], self.mesh)

    def _shift_t(self, x, fwd: bool):
        return comm.shift(x, self._tdim(x), self.mesh, "t", fwd)

    def _t_cell_sel(self, x, hi: bool):
        """Node-t array -> cell-t extent: node k (``hi=False``) or k+1."""
        if self.sharded_t:
            return self._shift_t(x, fwd=False) if hi else x
        t = self._tdim(x)
        return x.narrow(t, 1 if hi else 0, x.shape[t] - 1)

    def _t_node_scatter(self, y, t_lo: bool):
        """Cell-t array -> node-t extent: cell k to node k (``t_lo``) or
        k+1."""
        if self.sharded_t:
            return y if t_lo else self._shift_t(y, fwd=True)
        t = self._tdim(y)
        return _pad_dim(y, t, 0, 1) if t_lo else _pad_dim(y, t, 1, 0)

    # -- operators -------------------------------------------------------
    def grad(self, phi) -> Staggered:
        """A phi (``initialize.m:35-39``); face outputs re-masked."""
        geom = self.geom
        if self.sharded_t:
            q0 = (self._shift_t(phi, fwd=False) - phi) / geom.ht
            q0 = q0 * self._t_mask(phi.ndim, cell=True)
        else:
            q0 = (self._t_cell_sel(phi, True)
                  - self._t_cell_sel(phi, False)) / geom.ht
        nxt = self._shifts([(phi, a, False) for a in range(self.d)])
        bs = self._stack([
            ((nxt[a] - phi) / geom.hs(a)) * self._face_mask(a, phi.ndim)
            for a in range(self.d)])
        return Staggered(q0=q0, bs=bs)

    def grad_T(self, st: Staggered):
        """A^T; ghost-zero faces supply the adjoint's boundary zeros."""
        geom = self.geom
        q0 = st.q0
        if self.sharded_t:
            out = (self._shift_t(q0, fwd=True) - q0) / geom.ht
        else:
            out = (self._t_node_scatter(q0, False)
                   - self._t_node_scatter(q0, True)) / geom.ht
        faces = [self._face(st.bs, a) for a in range(self.d)]
        prev = self._shifts([(faces[a], a, True) for a in range(self.d)])
        for a in range(self.d):
            out = out + (prev[a] - faces[a]) / geom.hs(a)
        return out

    def bfd(self, q: Staggered, scale_bf, scale_d, sv=None):
        """z2 = scale_bf (BF q) + scale_d d (``mexBFd``), the whole block
        cell-masked in space and t; ``sv`` as in ``OpsFlat.bfd``."""
        cols = [scale_d - scale_bf * q.q0]
        s = scale_bf * _INV_SQRT2 if sv is None else sv
        faces = [self._face(q.bs, a) for a in range(self.d)]
        lows = self._shifts([(faces[a], a, True) for a in range(self.d)])
        for a in range(self.d):
            x_lo = lows[a]
            x_hi = faces[a]
            for hi in (False, True):
                cols.append(s * self._t_cell_sel(x_lo, hi))
                cols.append(s * self._t_cell_sel(x_hi, hi))
        cols.append(scale_d + scale_bf * q.q0)
        z2 = self._stack(cols)
        return z2 * self._cell_mask(z2.ndim, t_cell=True)

    def bfd_T(self, x, scale_bf, sv=None) -> Staggered:
        """q2 = scale_bf (BF)^T x (``mexBFdConj``), scatter-free; ``sv`` as
        in ``OpsFlat.bfd``."""
        q0 = scale_bf * (self._col(x, -1) - self._col(x, 0))
        s = scale_bf * _INV_SQRT2 if sv is None else sv
        # the x_lo columns of each axis: 1 + 4a (t_lo) and 3 + 4a (t_hi)
        nxt = iter(self._shifts([(self._col(x, 1 + 4 * a + 2 * j), a, False)
                                 for a in range(self.d) for j in (0, 1)]))
        bs = []
        col = 1
        for a in range(self.d):
            acc = None
            for t_lo in (True, False):
                for x_lo in (True, False):
                    xi = self._col(x, col)
                    col += 1
                    y = next(nxt) if x_lo else xi
                    y = self._t_node_scatter(y, t_lo)
                    acc = y if acc is None else acc + y
            bs.append((s * acc) * self._face_mask(a, acc.ndim))
        return Staggered(q0=q0, bs=self._stack(bs))

    def _t_rows(self, inner, bnd, dtype, device):
        """(Lt, 1, ...) values: ``bnd`` on the rank's slabs of global t = 0
        and nt - 1, ``inner`` elsewhere."""
        # fill_ takes a float or a 0-d tensor on the card (see
        # OpsFlat.t_edge_row)
        row = torch.empty((self.Lt,) + (1,) * self.d, dtype=dtype,
                          device=device).fill_(inner)
        for t in (0, self.geom.nt - 1):
            if self.off_t <= t < self.off_t + self.Lt:
                row[t - self.off_t].fill_(bnd)
        return row

    def t_edge_row(self, d_in, d_bd, like: torch.Tensor):
        """The per-time factor of the unweighted q-step diagonal's inverse
        on face blocks (``fused_step.times_dinv``), in ``like``'s dtype."""
        return self._t_rows(d_in, d_bd, like.dtype, like.device)

    def oper_q_diag(self, D: float, E: float,
                    weight: Optional[Staggered] = None) -> Staggered:
        """The q-step diagonal (``OpsFlat.oper_q_diag``) on the rank's
        block; ghost and pad slots hold interior values (their numerators
        are exact zeros)."""
        inner, bnd = diag_values(D, E) if weight is None \
            else base_values(D, E)
        dtype = self.dtype if weight is None else weight.dtype
        q0 = torch.full((self.Lt_cell,) + self.L, inner, dtype=dtype,
                        device=self.device)
        row = self._t_rows(inner, bnd, dtype, self.device)
        bs = row.expand((self.d, self.Lt) + self.L).clone()
        diag = Staggered(q0=q0, bs=bs)
        return diag if weight is None else diag + weight * weight

    def make_poisson(self, D: float = 1.0, split=False) -> "_HaloPoisson":
        if split is not False:
            # _HaloPoisson applies its own zero-extended matrices and would
            # drop the IR strategy (``halo_engine.py:326-339``)
            raise ValueError(
                "halo layout: fast f64 DCT modes (refine_dct_split="
                f"{split!r}) are not supported under a mesh; use the plain "
                "f64 tail (refine_dct_split=False or 'auto')")
        return _HaloPoisson(self, D)

    def face_interp(self, x, a: int):
        """0.5 (x[j] + x[j+1]) at face slot j."""
        return 0.5 * (x + self._shift(x, a, fwd=False))

    def t_node_interp(self, x):
        """Time-staggered -> time-node interpolation with zero-padded ends:
        node k gets 0.5 (cell[k-1] + cell[k])."""
        if self.sharded_t:
            return 0.5 * (self._shift_t(x, fwd=True) + x)
        t = self._tdim(x)
        padded = _pad_dim(x, t, 1, 1)
        n = padded.shape[t] - 1
        return 0.5 * (padded.narrow(t, 0, n) + padded.narrow(t, 1, n))

    def demean(self, phi):
        """phi minus its mean over the real cells, pads kept at zero."""
        mean = self.psum(torch.sum(phi)) / self.geom.n_centered
        return (phi - mean) * self._cell_mask(phi.ndim, t_node=True)

    # -- layout conversions: global shaped <-> the rank's block -------------
    def _pad_space(self, x, extra_short_axis=None, value=0.0, t_real=None):
        for a in range(self.d):
            ax = x.ndim - self.d + a
            real = self.geom.space[a] - (1 if a == extra_short_axis else 0)
            x = _pad_dim(x, ax, 0, self.P[a] - real, value)
        if self.sharded_t and t_real is not None:
            x = _pad_dim(x, x.ndim - self.d - 1, 0, self.Pt - t_real, value)
        return x

    def _local(self, x, t=False):
        for a in range(self.d):
            x = x.narrow(x.ndim - self.d + a, self.off[a], self.L[a])
        if self.sharded_t and t:
            x = x.narrow(x.ndim - self.d - 1, self.off_t, self.Lt)
        return x.contiguous()

    def _gather(self, x, t=False):
        dims = {n: x.ndim - self.d + a for a, n in enumerate(self.names)}
        if self.sharded_t and t:
            dims["t"] = x.ndim - self.d - 1
        return comm.gather_blocks(x, self.mesh, dims)

    def _slice(self, x, extra_short_axis=None, t_real=None):
        for a in range(self.d):
            real = self.geom.space[a] - (1 if a == extra_short_axis else 0)
            x = x.narrow(x.ndim - self.d + a, 0, real)
        if self.sharded_t and t_real is not None:
            x = x.narrow(x.ndim - self.d - 1, 0, t_real)
        return x

    def _to(self, x, t_real, short=None, value=0.0):
        return self._local(self._pad_space(x, short, value, t_real), t=True)

    def stag_to_internal(self, st: Staggered) -> Staggered:
        nt = self.geom.nt
        return Staggered(
            q0=self._to(st.q0, nt - 1),
            bs=torch.stack([self._to(st.bs[a], nt, a)
                            for a in range(self.d)]))

    def stag_from_internal(self, st: Staggered) -> Staggered:
        nt = self.geom.nt
        bs = self._gather(st.bs, t=True)
        return Staggered(
            q0=self._slice(self._gather(st.q0, t=True), t_real=nt - 1),
            bs=tuple(self._slice(bs[a], a, nt) for a in range(self.d)))

    def weight_to_internal(self, w: Staggered) -> Staggered:
        """Ghost and pad slots hold 1.0 (they only multiply zeros)."""
        nt = self.geom.nt
        return Staggered(
            q0=self._to(w.q0, nt - 1, value=1.0),
            bs=torch.stack([self._to(w.bs[a], nt, a, 1.0)
                            for a in range(self.d)]))

    def z_to_internal(self, z):
        return self._to(z, self.geom.nt - 1)

    def z_from_internal(self, z):
        return self._slice(self._gather(z, t=True), t_real=self.geom.nt - 1)

    def phi_to_internal(self, phi):
        return self._to(phi, self.geom.nt)

    def phi_from_internal(self, phi):
        return self._slice(self._gather(phi, t=True), t_real=self.geom.nt)


class _HaloPoisson:
    """The exact DCT Poisson solve on the rank's block of the padded grid:
    per axis the DCT matrix zero-extended to (P_a, P_a), so coefficients
    and outputs stay zero on the pads while the real block equals the
    unpadded transform (``halo_engine.py:451-488``). Along an axis the mesh
    splits, the rank gathers the axis's shards and applies its own rows."""

    def __init__(self, ops: OpsHalo, D: float):
        full_precision_matmul()
        geom = ops.geom
        ns = (geom.nt,) + geom.space
        exts = [(geom.nt, ops.Pt, ops.kt, ops.off_t, ops.Lt)] + [
            (geom.space[a], ops.P[a], ops.k[a], ops.off[a], ops.L[a])
            for a in range(ops.d)]
        self.ops = ops
        self.axes = []
        for ax, (n, Pn, k, off, L) in enumerate(exts):
            M = dct_matrix(n, ops.dtype, ops.device)
            if Pn != n:
                M = F.pad(M, (0, Pn - n, 0, Pn - n))
            fwd, inv = M, M.T
            if k > 1:
                fwd = fwd[off:off + L].contiguous()
                inv = inv[off:off + L].contiguous()
            name = ops.axis_comm(ax)[0] if k > 1 else None
            self.axes.append((ax, name, fwd, inv))
        ik = torch.as_tensor(_inverse_kernel(ns, D, None), dtype=ops.dtype,
                             device=ops.device)
        ik = ops._pad_space(ik, value=1.0, t_real=geom.nt)
        self.inv_kernel = ops._local(ik, t=True)

    def _transform(self, y, which: int):
        # phi-layout axis ax (0 = t) counted from the end: leading axes of
        # a stack of instances pass through
        lead = y.ndim - len(self.axes)
        for ax, name, *mats in self.axes:
            if name is not None:
                y = comm.all_gather(y, lead + ax, self.ops.mesh, name)
            y = _apply_axis(mats[which], y, lead + ax)
        return y

    def solve(self, rhs, scale=None):
        y = self._transform(rhs, 0)
        inv_k = self.inv_kernel if scale is None else self.inv_kernel * scale
        return self._transform(y * inv_k, 1)


class HaloSGS:
    """The red-black symmetric Gauss-Seidel sweep on the halo layout
    (``halo_engine.py:490-595``; the plain sweep is ``ops/sgs.py``). Each
    of the three half-sweeps (B, A, B) first pulls one slab from every
    neighbour along each axis: the checkerboard colouring makes a
    half-sweep parallel, so halos exchanged at its start reproduce the
    global sweep exactly. Pad cells are excluded by a validity mask and
    stay zero; a real cell's neighbour beyond the domain reads a zero pad.
    Built with D = 1, the scale d2 = D^2 passed per call, as
    :class:`~.sgs.RedBlackSGS`."""

    def __init__(self, ops: OpsHalo):
        self.ops = ops
        geom = ops.geom
        ns = (geom.nt,) + geom.space
        padded = ops.phi_padded_shape
        self.h2inv = tuple(float((n - 1) ** 2) for n in ns)
        diag = np.zeros(padded)
        acc = np.zeros((), np.int64)
        valid = np.ones(padded, bool)
        for ax, (n, w) in enumerate(zip(ns, self.h2inv)):
            m = padded[ax]
            deg = np.full(m, 2.0)
            deg[0] = 1.0
            deg[n - 1] = 1.0
            shape = [1] * len(padded)
            shape[ax] = m
            diag = diag + w * deg.reshape(shape)
            # checkerboard parity on global coordinates (the padding is
            # appended, never interleaved)
            acc = acc + np.arange(m).reshape(shape)
            v = np.ones(m, bool)
            v[n:] = False
            valid = valid & v.reshape(shape)

        def local(a, dtype):
            return ops._local(torch.as_tensor(a, dtype=dtype,
                                              device=ops.device), t=True)

        self.inv_diag = local(1.0 / diag, ops.dtype)
        self.mask_a = local((acc % 2) == 0, torch.bool)
        self.valid = local(valid, torch.bool)

    def _nbr(self, p):
        """Neighbour sum weighted by 1/h^2 per axis, with one-slab halos."""
        ops = self.ops
        nbrs = comm.shifts([(p, ax, ops.axis_comm(ax)[0], fwd)
                            for ax in range(len(self.h2inv))
                            for fwd in (True, False)], ops.mesh)
        out = torch.zeros_like(p)
        for ax, w in enumerate(self.h2inv):
            out = out + w * (nbrs[2 * ax] + nbrs[2 * ax + 1])
        return out

    def sweep(self, phi, rhs, its: int = 1, *, d2):
        """``its`` symmetric sweeps (B, A, B) of M = d2 A^T A."""
        invd = self.inv_diag / d2
        for _ in range(its):
            for color_a in (False, True, False):
                new = (rhs + d2 * self._nbr(phi)) * invd
                m = self.mask_a if color_a else ~self.mask_a
                phi = torch.where(m & self.valid, new, phi)
        return phi

    def residual(self, phi, rhs, *, d2):
        """rhs - M phi on real cells (zero on pads)."""
        res = rhs - phi / (self.inv_diag / d2) + d2 * self._nbr(phi)
        return torch.where(self.valid, res, torch.zeros_like(res))

    def residual_color_a_norm(self, phi, rhs, h, *, d2):
        """sqrt(h) || (rhs - M phi)[colour A] || over the whole grid."""
        r = torch.where(self.mask_a, self.residual(phi, rhs, d2=d2),
                        torch.zeros((), dtype=phi.dtype, device=phi.device))
        return torch.sqrt(h * self.ops.psum(torch.sum(torch.square(r))))
