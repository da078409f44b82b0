"""The flat lane shift with zero fill, beside its plain PyTorch version:
TPU kernel 3 (``make_pallas_shift``, ``dotsocp_tpu/ops/pallas_kernels.py:
291-358``) as the CUDA kernel of ``csrc/flat_shift.cu``.

    forward   y[r, i] = x[r, i - k]   (zero where i < k)
    backward  y[r, i] = x[r, i + k]   (zero where i + k >= S)

on an (R, S) field, or on one plane of a (C, R, S) cone array, read in
place with no copy of the plane. The Pallas kernel refuses k above its
tile width, the z stride of a 3D grid among them; this one takes any
k >= 0. Its plain version is the engine's pad-and-slice shift
(:func:`.engine.flat_sfwd` / :func:`.engine.flat_sbwd`, which
``OpsFlat._sfwd`` / ``_sbwd`` run); the kernel only copies, so the two are
bit-equal. As in the JAX package no solver path calls it: the step kernels
read their shifted operands at offsets themselves.

Dispatch as in ``ops/fused_step.py``: the plain version runs only because
the tensor lies on the CPU or is float64; on a float32 CUDA tensor the
wrapper checks shape and contiguity, launches, and raises on any error.
Every launch adds one to ``LAUNCHES["flat_shift"]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .engine import flat_sbwd, flat_sfwd
from .fused_step import _launch, _use_kernel

LAUNCHES = {"flat_shift": 0}


def reset_launches() -> None:
    LAUNCHES["flat_shift"] = 0


def flat_shift_plain(x: torch.Tensor, k: int, forward: bool,
                     plane: Optional[int] = None) -> torch.Tensor:
    src = x if plane is None else x[plane]
    return flat_sfwd(src, k) if forward else flat_sbwd(src, k)


def flat_shift(x: torch.Tensor, k: int, forward: bool,
               plane: Optional[int] = None) -> torch.Tensor:
    """The shift of ``x`` (R, S) by ``k`` >= 0 lanes, or of ``x[plane]``
    for a (C, R, S) ``x``; returns a fresh (R, S) tensor."""
    if k < 0:
        raise ValueError(f"flat_shift: k = {k} < 0 (use the other direction)")
    if x.dim() != (2 if plane is None else 3):
        raise ValueError(f"flat_shift: shape {tuple(x.shape)} with plane "
                         f"{plane}: expected (R, S), or (C, R, S) and a plane")
    if not _use_kernel(x):
        return flat_shift_plain(x, k, forward, plane)
    C = 1 if plane is None else x.shape[0]
    p = 0 if plane is None else int(plane)
    if not 0 <= p < C:
        raise ValueError(f"flat_shift: plane {p} outside 0..{C - 1}")
    R, S = x.shape[-2:]
    y = torch.empty((R, S), dtype=x.dtype, device=x.device)
    _launch(LAUNCHES, "flat_shift", _build.library().dotsocp_flat_shift,
            x.device, x.data_ptr(), y.data_ptr(), R, S, p, min(k, S),
            int(forward))
    return y
