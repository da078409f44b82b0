"""Meshes over a ``torch.distributed`` world, and the state's shards; port of
``dotsocp_tpu/parallel/sharding.py:29-166``.

The JAX mesh is single-controller: one program, which XLA partitions over
the devices from sharding annotations. The port runs SPMD instead, one
rank per shard: every rank runs the same solve on its own block of the
fields, and the collectives are explicit (``parallel/comm.py``). So a
:class:`Mesh` here is one rank's view of the mesh: the axis names and
extents, this rank's coordinates, one process group per axis (the ranks
that differ only along it) and the rank's device.

Axes, as in the JAX package: ``batch`` carries independent instances (the
fleet, ``parallel/batch.py``); ``y``, ``x`` (``z`` in 3D, ``x`` in 1D) and
``t`` split the space-time grid of one instance (the halo engine,
``ops/halo_engine.py``). On a mesh with both, the ranks that share a
``batch`` coordinate hold the blocks of the same instances: ``Mesh.row``
is that batch row as a mesh of its own, whose sums stay within it. The counterparts of ``state_shardings`` /
``constrain`` are :func:`shard_state` and :func:`gather_state`, which cut
a global state into one rank's padded block and join the blocks again.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm


def factorize(n: int, k: int) -> list:
    """Split n into k near-balanced factors (largest first)."""
    dims = [1] * k
    remaining = n
    i = 0
    while remaining > 1:
        # smallest prime factor
        p = next(
            (d for d in range(2, int(math.isqrt(remaining)) + 1)
             if remaining % d == 0),
            remaining,
        )
        dims[i % k] *= p
        remaining //= p
        i += 1
    return sorted(dims, reverse=True)


class Mesh:
    """One rank's view of a mesh of ``ranks`` (world ranks, row-major over
    ``shape``). ``coords`` are this rank's coordinates (None on a rank the
    mesh leaves out); ``stats`` counts the collectives this rank issued
    through ``parallel/comm.py`` and the bytes it sent."""

    def __init__(self, axis_names, shape, rank: int, ranks, groups: dict,
                 group, backend: Optional[str], device, row_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        self.member = rank in self.ranks
        self.coords = self.coords_of(self.ranks.index(rank)) \
            if self.member else None
        self._groups = groups
        self.group = group
        self.backend = backend
        self.device = torch.device(device)
        self.stats = {"calls": 0, "bytes": 0}
        self._row_group = row_group
        self._row = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, coords {self.coords}, "
                f"{self.backend}, {self.device})")

    def coords_of(self, index: int) -> dict:
        """The coordinates of the mesh's ``index``-th rank."""
        ext = [self.shape[n] for n in self.axis_names]
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(index, ext))))

    def neighbor(self, name: str, step: int) -> Optional[int]:
        """The world rank ``step`` along axis ``name`` from this rank, or
        None past the mesh's edge."""
        c = dict(self.coords)
        c[name] += step
        if not 0 <= c[name] < self.shape[name]:
            return None
        ext = [self.shape[n] for n in self.axis_names]
        idx = np.ravel_multi_index([c[n] for n in self.axis_names], ext)
        return self.ranks[int(idx)]

    def group_of(self, name: str):
        """The process group of the ranks that differ from this one only
        along axis ``name`` (ordered by coordinate)."""
        return self._groups[name]

    def row(self) -> "Mesh":
        """This rank's batch row: the ranks that share its ``batch``
        coordinate, as a mesh of the other axes (their groups, its own
        ``group``, ``size`` and ``ranks``; the same ``stats``). A fleet's
        level runs on it, so that a norm's sum over the mesh adds the
        blocks of one instance and never another's. Without a batch axis
        of extent > 1 the row is the mesh itself, as a mesh of the other
        axes."""
        if self._row is None:
            names = [n for n in self.axis_names if n != "batch"]
            mine = self.coords.get("batch", 0)
            ranks = [r for i, r in enumerate(self.ranks)
                     if self.coords_of(i).get("batch", 0) == mine]
            group = self.group if self.shape.get("batch", 1) == 1 \
                else self._row_group
            row = Mesh(names, [self.shape[n] for n in names], self.rank,
                       ranks, {n: g for n, g in self._groups.items()
                               if n != "batch"}, group, self.backend,
                       self.device)
            row.stats = self.stats
            self._row = row
        return self._row


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, None


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("batch", "y", "x"),
              device=None) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: the whole world; without a
    process group, one rank) shaped ``factorize(n, len(axis_names))``, as
    the JAX ``make_mesh``. Every rank of the world calls it, in the same
    order as its other collectives: each axis's process groups are made
    here. ``device`` is the rank's device (default: the one
    ``initialize_distributed`` set; without it, pass the device)."""
    rank, world, backend = _world()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}): the world has {world} "
                         f"rank(s)")
    names = tuple(axis_names)
    if len(set(names)) != len(names):
        raise ValueError(f"axis names {names} repeat")
    shape = factorize(n, len(names))
    ranks = tuple(range(n))
    groups = {}
    for a, name in enumerate(names):
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            line = []
            for c in range(shape[a]):
                coord = list(rest)
                coord.insert(a, c)
                line.append(ranks[int(np.ravel_multi_index(coord, shape))])
            # every world rank makes every group, in the same order
            grp = dist.new_group(line) if shape[a] > 1 else None
            if rank in line:
                groups[name] = grp
    # a group a batch row, where the batch axis and the row both have
    # more than one rank (``Mesh.row``)
    row_group = None
    if "batch" in names:
        b = names.index("batch")
        if 1 < shape[b] < n:
            coords = np.unravel_index(np.arange(n), shape)[b]
            for c in range(shape[b]):
                line = [ranks[i] for i in range(n) if coords[i] == c]
                grp = dist.new_group(line)
                if rank in line:
                    row_group = grp
    group = None
    if n < world:
        group = dist.new_group(list(ranks))
    if device is None:
        from .distributed import local_device

        device = local_device()
    return Mesh(names, shape, rank, ranks, groups, group, backend, device,
                row_group)


def spatial_axes(mesh: Mesh) -> list:
    """The axes of extent > 1 that split one instance's grid."""
    return [n for n in ("t", "z", "y", "x") if mesh.shape.get(n, 1) > 1]


# -- the state's shards -------------------------------------------------------

_FIELDS = ("phi", "q", "z", "alpha", "beta", "c")


def _convert(state, fn_stag, fn_z, fn_phi):
    return state.replace(
        phi=fn_phi(state.phi), c=fn_phi(state.c), z=fn_z(state.z),
        beta=fn_z(state.beta), q=fn_stag(state.q), alpha=fn_stag(state.alpha))


def _engines(geom, mesh: Mesh, like: torch.Tensor):
    from ..ops.engine import OpsFlat
    from ..ops.halo_engine import OpsHalo

    return (OpsFlat(geom, like.dtype, like.device),
            OpsHalo(geom, like.dtype, like.device, mesh))


def shard_state(state, mesh: Mesh, geom):
    """This rank's block of a global ``SolverState`` of grid ``geom`` (the
    single-process flat layout): each field padded to mesh multiples as the
    halo engine lays it out, then cut to the rank's coordinates."""
    flat, halo = _engines(geom, mesh, state.phi)
    return _convert(
        state,
        lambda st: halo.stag_to_internal(flat.stag_from_internal(st)),
        lambda z: halo.z_to_internal(flat.z_from_internal(z)),
        lambda p: halo.phi_to_internal(flat.phi_from_internal(p)))


def gather_state(local, mesh: Mesh, geom):
    """The global ``SolverState`` (flat layout) from every rank's block: the
    inverse of :func:`shard_state`, the same on every rank."""
    flat, halo = _engines(geom, mesh, local.phi)
    return _convert(
        local,
        lambda st: flat.stag_to_internal(halo.stag_from_internal(st)),
        lambda z: flat.z_to_internal(halo.z_from_internal(z)).contiguous(),
        lambda p: flat.phi_to_internal(halo.phi_from_internal(p))
        .contiguous())


def _on_mesh(kernels, mesh: Mesh):
    """The level's class rebuilt on the halo engine of ``mesh``, with the
    level's weight (shaped again from its flat layout) and the acc
    methods' parameters."""
    kw = {k: getattr(kernels, k) for k in ("restart", "rho", "theta")
          if hasattr(kernels, k)}
    if kernels.weight is not None:
        kw["weight"] = kernels.ops.stag_from_internal(kernels.weight)
    return type(kernels)(dataclasses.replace(kernels.cfg, mesh=mesh), **kw)


def make_sharded_step(kernels, mesh: Mesh, batched: bool = True):
    """The level's step over the mesh, global state in and out on every
    rank (the JAX ``make_sharded_step``, ``sharding.py:151-166``).

    ``batched``: the state holds B instances on a leading axis, which the
    mesh's ``batch`` axis splits. Where the mesh splits no axis of the
    grid, each rank steps its instances with ``kernels`` (their scalars
    in memory, as the device driver's); where it does,
    each rank cuts its block of each of its instances, steps the stack of
    them with the level's class rebuilt on its batch row (``Mesh.row``,
    the halo engine) and joins the blocks. The results are then gathered
    along ``batch``. Not ``batched``: the mesh splits the grid, and the
    step is the same level's on the halo engine, run on this rank's block
    of the state and gathered back. A weighted level's halo kernels carry
    its weight."""
    from ..algorithms.core import BATCH_SCALARS, instance
    from .batch import stack_states

    spatial = bool(spatial_axes(mesh))
    geom = kernels.geom
    if batched:
        k = mesh.shape.get("batch", 1)
        row = mesh.row() if spatial else None
        halo = None if row is None else _on_mesh(kernels, row)

        def batched_step(state):
            B = state.phi.shape[0]
            if B % k:
                raise ValueError(f"{B} instances do not split over a batch "
                                 f"axis of {k}")
            lo = mesh.coords.get("batch", 0) * (B // k)
            mine = [instance(state, b) for b in range(lo, lo + B // k)]
            if halo is None:
                # an instance's scalars are 0-d tensors: its E and the
                # values derived from E go beside them as tensors too (the
                # device driver's), as a kernel reads all its scalars by
                # value or all from memory
                ev = kernels.e_scalars(state.D, state.E)
                steps = [kernels._step(s.replace(ev=ev, E=ev.E))
                         for s in mine]
            else:
                blocks = stack_states([shard_state(s, row, geom)
                                       for s in mine])
                active = torch.ones(len(mine), dtype=torch.bool,
                                    device=blocks.phi.device)
                new = halo._step_batched(blocks, active)
                steps = [gather_state(instance(new, i), row, geom)
                         for i in range(len(mine))]
            local = stack_states(steps)
            out = {}
            for f in _FIELDS + BATCH_SCALARS:
                v = getattr(local, f)
                if hasattr(v, "q0"):
                    out[f] = v.map(
                        lambda b: comm.all_gather(b, 0, mesh, "batch"))
                else:
                    out[f] = comm.all_gather(v, 0, mesh, "batch")
            return state.replace(**out)

        return batched_step
    halo = _on_mesh(kernels, mesh)

    def spatial_step(state):
        return gather_state(halo._step(shard_state(state, mesh, geom)),
                            mesh, geom)

    return spatial_step
