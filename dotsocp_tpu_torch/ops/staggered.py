"""Staggered-grid field container (q, alpha live on this layout).

Port of ``dotsocp_tpu/ops/staggered.py``. ``q0`` holds the time-staggered
block and ``bs`` the face blocks, one per spatial axis. In the shaped layout
(the ``"3d"`` engine ``ops/engine.Ops3D``, and every level variable) ``bs``
is a tuple of tensors (their shapes differ per axis); in the flat internal
layout (``ops/engine.OpsFlat``) every face block is ``(nt, S)`` and ``bs``
is one ``(d, nt, S)`` tensor, so a kernel takes one pointer for all axes.
Indexing ``bs[a]`` and iterating over ``bs`` work the same for both forms;
:meth:`Staggered.map` and :meth:`Staggered.tensors` treat each form as it
is stored. A stack of instances (the lockstep fleet) carries a leading axis
on every block.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def _map(fn, bs: Blocks, *others: Blocks):
    if isinstance(bs, torch.Tensor):
        return fn(bs, *others)
    return tuple(fn(*parts) for parts in zip(bs, *others))


class Staggered(NamedTuple):
    """q-layout field: q0 on time-staggered cells, bs[a] on faces of axis a.

    Shaped: q0 ``(nt-1, *space)``, bs[a] ``(nt, ..., n_a - 1, ...)``.
    Flat:   q0 ``(nt-1, S)``, bs ``(d, nt, S)``.
    """

    q0: torch.Tensor
    bs: Blocks

    def _zip(self, other, fn) -> "Staggered":
        if isinstance(other, Staggered):
            return Staggered(fn(self.q0, other.q0), _map(fn, self.bs, other.bs))
        return Staggered(fn(self.q0, other), _map(lambda b: fn(b, other), self.bs))

    def __add__(self, other: "Staggered") -> "Staggered":
        return self._zip(other, torch.add)

    def __sub__(self, other: "Staggered") -> "Staggered":
        return self._zip(other, torch.sub)

    def __mul__(self, other) -> "Staggered":
        return self._zip(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "Staggered":
        return self._zip(other, torch.div)

    def __neg__(self) -> "Staggered":
        return Staggered(-self.q0, _map(torch.neg, self.bs))

    def blocks(self):
        """q0 followed by every face block."""
        return [self.q0] + list(self.bs)

    def tensors(self) -> list:
        """The tensors as stored: ``[q0, bs]`` where ``bs`` is one tensor
        (the flat and halo layouts), ``[q0, *bs]`` in the shaped form."""
        if isinstance(self.bs, torch.Tensor):
            return [self.q0, self.bs]
        return [self.q0, *self.bs]

    def map(self, fn, *others: "Staggered") -> "Staggered":
        """``fn`` of the blocks as stored, with the same blocks of
        ``others``: q0, then the face tensor whole or each face block."""
        return Staggered(fn(self.q0, *(o.q0 for o in others)),
                         _map(fn, self.bs, *(o.bs for o in others)))

    def at(self, i) -> "Staggered":
        """Instance ``i`` of a stack on a leading axis, as views."""
        return self.map(lambda b: b[i])

    @staticmethod
    def stack(parts) -> "Staggered":
        """Fields of one layout stacked on a new leading axis, block by
        block."""
        return parts[0].map(lambda *bs: torch.stack(bs), *parts[1:])

    def sqnorm(self) -> torch.Tensor:
        """Sum of squares over all blocks (the flat-vector ||.||^2)."""
        return sum(torch.sum(b * b) for b in self.blocks())

    def dot(self, other: "Staggered") -> torch.Tensor:
        return sum(torch.sum(a * b) for a, b in zip(self.blocks(), other.blocks()))

    @property
    def dtype(self):
        return self.q0.dtype

    def to(self, *args, **kwargs) -> "Staggered":
        return Staggered(self.q0.to(*args, **kwargs),
                         _map(lambda b: b.to(*args, **kwargs), self.bs))

    def clone(self) -> "Staggered":
        return Staggered(self.q0.clone(), _map(torch.clone, self.bs))


# -- shaped fields (``dotsocp_tpu/ops/staggered.py:71-77``) ------------------

def zeros(geom, dtype=torch.float32, device="cpu") -> Staggered:
    """A shaped field of zeros on ``geom``: face blocks a tuple."""
    return Staggered(
        q0=torch.zeros(geom.q0_shape, dtype=dtype, device=device),
        bs=tuple(torch.zeros(geom.b_shape(a), dtype=dtype, device=device)
                 for a in range(geom.ndim_space)))
