"""The red-black sGS sweep kernel of the sGS methods' phi-step, beside its
plain PyTorch version (:meth:`..ops.sgs.RedBlackSGS.sweep`).

One CUDA kernel (``csrc/sgs_sweep.cu``) replaces both Pallas sweeps of
``dotsocp_tpu/ops/pallas_kernels.py``, the whole-field
``make_sgs_sweep_pallas`` and the row-tiled ``make_sgs_sweep_pallas_tiled``,
on fields of one, two or three space axes. One launch is one whole
symmetric sweep (B, A, B): each block streams its tile of the space axes
(with a 3-cell halo) along t once, keeping the colours in between in shared
memory, so the sweep reads phi and rhs and writes its output once each from
HBM: ~205 MB at 513^2 x 65 (f32, 17.1 M cells).

Dispatch as in ``ops/fused_step.py``: the plain version runs because the
tensors lie on the CPU or are float64 (the route by dtype); on float32 CUDA
tensors the wrapper checks device, shape, contiguity and aliasing,
launches, and raises on any error. Every launch adds one to
``LAUNCHES["rb_sweep"]``: ``its`` sweeps are ``its`` launches.

The input phi is never written: every sweep writes a fresh buffer (two
sweeps or more alternate between the output and one scratch buffer, since
a sweep's blocks read each other's halo cells of its input). The acc
methods' Halpern anchor holds the very phi tensor of the state (after
``prep`` and every restart), so an in-place sweep of its input would
corrupt it.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_step import _check_distinct, _check_shape, _launch, _use_kernel
from .sgs import RedBlackSGS

LAUNCHES = {"rb_sweep": 0}


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
    _check_shape(phi, g.phi_shape, "phi")
    _check_shape(rhs, g.phi_shape, "rhs")
    _check_distinct(phi, rhs)
    if g.n_centered // g.nt >= 2 ** 31:
        raise ValueError("rb_sweep: a t-plane of 2^31 cells or more (the "
                         "kernel's in-plane offsets are 32-bit)")
    out = torch.empty_like(phi)
    # the last sweep writes out; the ones before alternate with scratch
    bufs = (out, torch.empty_like(phi) if its > 1 else None)
    n = list(g.space) + [1] * (3 - g.ndim_space)
    fn = _build.library().dotsocp_rb_sweep
    src = phi
    for k in range(its):
        dst = bufs[(its - 1 - k) % 2]
        _launch(LAUNCHES, "rb_sweep", fn, phi.device, src.data_ptr(),
                rhs.data_ptr(), dst.data_ptr(), g.ndim_space, g.nt, *n,
                float(d2))
        src = dst
    return out
