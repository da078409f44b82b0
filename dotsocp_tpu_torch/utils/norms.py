"""Grid-scaled norms and integrals (``normL2.m``, ``FnormL2.m``,
``integralL2.m``); port of ``dotsocp_tpu/utils/norms.py``. Real dtypes only."""
from __future__ import annotations

import torch

from ..ops.staggered import Staggered


def sqsum(x) -> torch.Tensor:
    """The sum of squares of all elements; tensors or :class:`Staggered`
    fields."""
    return x.sqnorm() if isinstance(x, Staggered) else torch.sum(x * x)


def norm_l2(x, h) -> torch.Tensor:
    """sqrt(h) * ||x||_2 over all elements; accepts tensors or
    :class:`Staggered` fields."""
    return torch.sqrt(h * sqsum(x))


def integral_l2(f: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean-type integral: (1/n) sum over the spatial axes; for a
    (nt, *space) density this is the per-time-slab mass."""
    if axis is None:
        axis = tuple(range(1, f.ndim))
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= f.shape[a]
    return f.sum(dim=axes) / n


def sdot(x, y, h=1.0) -> torch.Tensor:
    """h-scaled inner product; accepts Staggered or tensors."""
    if isinstance(x, Staggered):
        return h * x.dot(y)
    return h * torch.sum(x * y)
