"""The red-black sGS sweep kernel of the sGS methods' phi-step, beside its
plain PyTorch version (:meth:`..ops.sgs.RedBlackSGS.sweep`).

One CUDA kernel (``csrc/sgs_sweep.cu``, one launch per half-sweep) replaces
both Pallas sweeps of ``dotsocp_tpu/ops/pallas_kernels.py``, the whole-field
``make_sgs_sweep_pallas`` and the row-tiled ``make_sgs_sweep_pallas_tiled``.
Bytes at 513^2 x 65 (f32, 17.1 M cells): phi read, rhs read and out written
per half-sweep, ~205 MB, so ~0.62 GB per symmetric sweep.

Dispatch as in ``ops/fused_step.py``: the plain version runs only because
the tensors lie on the CPU; on CUDA tensors the wrapper checks device,
dtype (f32 only), shape, contiguity and aliasing, launches, and raises on
any error. Every half-sweep launch adds one to ``LAUNCHES["rb_sweep"]``.

The input phi is never written: the first half-sweep writes every cell of
a fresh output, the two that follow update it in place. The acc methods'
Halpern anchor holds the very phi tensor of the state (after ``prep`` and
every restart), so an in-place sweep of its input would corrupt it.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_step import _check_distinct, _check_shape, _launch, _use_kernel
from .sgs import RedBlackSGS

LAUNCHES = {"rb_sweep": 0}

_COLOR_A, _COLOR_B = 0, 1


def reset_launches() -> None:
    LAUNCHES["rb_sweep"] = 0


def rb_sweep(sgs: RedBlackSGS, phi: torch.Tensor, rhs: torch.Tensor,
             d2: float, its: int = 1) -> torch.Tensor:
    """``its`` symmetric red-black sweeps (B, A, B) of (d2 A^T A) phi = rhs
    on the shaped field ``(nt, *space)``. Returns a new tensor; ``phi`` is
    left as it was."""
    if not _use_kernel(phi, rhs) or its < 1:
        return sgs.sweep(phi, rhs, its, d2=d2)
    g = sgs.geom
    if g.ndim_space not in (1, 2):
        raise NotImplementedError("the sweep kernel takes 1D and 2D fields")
    _check_shape(phi, g.phi_shape, "phi")
    _check_shape(rhs, g.phi_shape, "rhs")
    _check_distinct(phi, rhs)
    out = torch.empty_like(phi)
    n = list(g.space) + [1] * (2 - g.ndim_space)
    S = g.n_centered // g.nt
    fn = _build.library().dotsocp_rb_half_sweep
    src = phi
    for _ in range(its):
        for color in (_COLOR_B, _COLOR_A, _COLOR_B):
            # copy the other colour only where out does not hold it yet
            _launch(LAUNCHES, "rb_sweep", fn, phi.device, src.data_ptr(),
                    rhs.data_ptr(), out.data_ptr(), g.ndim_space, g.nt, S,
                    n[0], n[1], float(d2), color, int(src is phi))
            src = out
    return out
