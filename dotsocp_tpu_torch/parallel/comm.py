"""The one place where the port issues collectives: halo shifts, sums over
the mesh and gathers along one mesh axis, on ``torch.distributed``.

Every rank of a mesh runs the same program on its own shard (SPMD), so
every rank must issue the same collectives in the same order, or the run
deadlocks; the process group's timeout (``parallel/distributed.py``) turns
such a hang into an error. The functions here take the rank's
:class:`~.sharding.Mesh` and do nothing collective along an axis of extent
1, so a one-rank mesh runs them with no process group at all.

The gloo backend moves CPU tensors only. Where the backend is gloo and a
tensor lives on the card (several ranks sharing one card: NCCL refuses
two ranks on one GPU), the tensor is staged through a host buffer here and
the result copied back, in this module and nowhere else. Every call adds
to the mesh's ``stats``: ``calls`` and ``bytes``, the payload this rank
sent or contributed.

- :func:`shift` is the one-slab halo exchange of the halo engine
  (``dotsocp_tpu/ops/halo_engine.py:73-95``, ``_shift_local``): y[i] =
  x[i-1] (``fwd``) or x[i+1] along one array axis, zeros entering at the
  global ends, with one ``batch_isend_irecv`` between axis neighbours;
  :func:`shifts` posts the exchanges of several shifts as one batch.
- :func:`psum` sums a tensor over every rank of the mesh. It gathers the
  ranks' partial values and adds them in rank order on every rank, so all
  ranks hold bit-identical results and take the same branch on them (an
  all-reduce need not give every rank the same bits).
- :func:`all_gather` joins the shards of one mesh axis (the DCT along a
  sharded axis); :func:`gather_blocks` joins the shards of every axis
  (a field back to its global form).
- :func:`any_true` agrees on a host flag (a time limit, a fleet's done);
  :func:`all_equal` on a host value (the checkpoints the ranks resume).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the backend moves it: contiguous, and on the host where
    gloo meets a CUDA tensor."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu").contiguous()
    return t.contiguous()


def _count(mesh, t: torch.Tensor) -> None:
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += t.numel() * t.element_size()


def _pad_dim(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    pad = [0, 0] * x.ndim
    # F.pad lists (lo, hi) pairs from the last axis backwards
    pad[2 * (x.ndim - 1 - dim)] = lo
    pad[2 * (x.ndim - 1 - dim) + 1] = hi
    return torch.nn.functional.pad(x, pad)


def shift(x: torch.Tensor, dim: int, mesh, name, fwd: bool) -> torch.Tensor:
    """Shift the shard ``x`` by one along array axis ``dim``, which mesh
    axis ``name`` splits (None: not split): y[i] = x[i-1] with ``fwd``,
    else y[i] = x[i+1]; the slab entering at a shard's edge is the
    neighbour shard's, zeros at the global ends."""
    return shifts([(x, dim, name, fwd)], mesh)[0]


def shifts(items, mesh) -> list:
    """:func:`shift` of each ``(x, dim, name, fwd)`` in ``items``, their
    exchanges posted as one batch (one round trip for all of them)."""
    out, ops, pending = [], [], []
    for i, (x, dim, name, fwd) in enumerate(items):
        n = x.shape[dim]
        k = mesh.shape.get(name, 1) if name is not None else 1
        if k == 1:
            out.append(_pad_dim(x.narrow(dim, 0, n - 1), dim, 1, 0) if fwd
                       else _pad_dim(x.narrow(dim, 1, n - 1), dim, 0, 1))
            continue
        edge = x.narrow(dim, n - 1, 1) if fwd else x.narrow(dim, 0, 1)
        dst = mesh.neighbor(name, 1 if fwd else -1)
        src = mesh.neighbor(name, -1 if fwd else 1)
        send = _wire(edge, mesh)
        recv = torch.zeros_like(send)
        # one tag an item: two items may pass between the same two ranks
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, dst, tag=i))
            _count(mesh, send)
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src, tag=i))
        pending.append((len(out), x, dim, fwd, recv))
        out.append(None)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for j, x, dim, fwd, recv in pending:
        n = x.shape[dim]
        recv = recv.to(x.device)
        body = x.narrow(dim, 0, n - 1) if fwd else x.narrow(dim, 1, n - 1)
        out[j] = torch.cat([recv, body] if fwd else [body, recv], dim=dim)
    return out


def _gather(t: torch.Tensor, mesh, group, size: int) -> list:
    """Every rank's ``t`` over ``group`` (``size`` ranks), in group order,
    on ``t``'s device."""
    wire = _wire(t, mesh)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    _count(mesh, wire)
    return [p.to(t.device) for p in parts]


def psum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over every rank of the mesh, bit-identical on every
    rank (the partial values added in rank order)."""
    if mesh.size == 1:
        return t
    parts = _gather(t.reshape(-1), mesh, mesh.group, mesh.size)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.reshape(t.shape)


def all_gather(x: torch.Tensor, dim: int, mesh, name: str) -> torch.Tensor:
    """The shards of mesh axis ``name`` joined along array axis ``dim``."""
    k = mesh.shape.get(name, 1)
    if k == 1:
        return x
    return torch.cat(_gather(x, mesh, mesh.group_of(name), k), dim=dim)


def gather_blocks(x: torch.Tensor, mesh, dims: dict) -> torch.Tensor:
    """The global field from every rank's shard ``x``: ``dims`` maps each
    split mesh axis to the array axis it splits (equal shards)."""
    dims = {n: d for n, d in dims.items() if mesh.shape.get(n, 1) > 1}
    if not dims:
        return x
    parts = _gather(x, mesh, mesh.group, mesh.size)
    shape = list(x.shape)
    for n, d in dims.items():
        shape[d] *= mesh.shape[n]
    out = x.new_empty(shape)
    for i, part in enumerate(parts):
        coords = mesh.coords_of(i)
        idx = [slice(None)] * x.ndim
        for n, d in dims.items():
            lo = coords[n] * x.shape[d]
            idx[d] = slice(lo, lo + x.shape[d])
        out[tuple(idx)] = part
    return out


def any_true(flag: bool, mesh) -> bool:
    """True on every rank when ``flag`` is true on any rank of the mesh."""
    if mesh.size == 1:
        return bool(flag)
    # NCCL moves device tensors only
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    t = torch.tensor([1.0 if flag else 0.0], dtype=torch.float64, device=dev)
    parts = _gather(t, mesh, mesh.group, mesh.size)
    return any(bool(p.item()) for p in parts)


def all_true(flag: bool, mesh) -> bool:
    """True on every rank when ``flag`` is true on every rank."""
    return not any_true(not flag, mesh)


def all_equal(obj, mesh) -> bool:
    """True on every rank when every rank of the mesh holds an equal
    ``obj`` (picklable, compared with ``==``)."""
    if mesh.size == 1:
        return True
    objs = [None] * mesh.size
    dist.all_gather_object(objs, obj, group=mesh.group)
    mesh.stats["calls"] += 1
    return all(o == objs[0] for o in objs)


def broadcast_object(obj, src: int = 0):
    """``obj`` of world rank ``src`` on every rank of the world (the ranks a
    mesh of fewer ranks leaves out learn its result this way)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
