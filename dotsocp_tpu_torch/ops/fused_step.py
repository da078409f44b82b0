"""The x-carry step kernels of the inPALM / ALG2 segment, each beside its
plain PyTorch version.

Inside a segment the z slot of the state carries x = z + beta: the q-step
only consumes z + beta, so one cone read replaces two, and the CA kernel
(beta multiplier fused with the next cone projection) forms x' = z' + beta'
in registers. Four entry points, three kernel sources in
``csrc/fused_step.cu``:

=========  ==================================================  ==========
wrapper    replaces (dotsocp_tpu/ops/pallas_kernels.py)        bytes at
                                                               513^2 x 65
=========  ==================================================  ==========
x_step     ``make_fused_flat_step.x_step`` / ``x_kernel``      1.55 GB
qx_step    ``make_fused_flat_step.qx_step`` / ``qx_kernel``    1.35 GB
           (unweighted form); weighted form (``WeightedDinv``)  1.56 GB
cx_step    ``make_fused_flat_step.cx_step`` /                  2.90 GB
           ``make_cx_kernel(final=False)``
cx_final   ``make_fused_flat_step.cx_final`` /                 2.90 GB
           ``make_cx_kernel(final=True)``
=========  ==================================================  ==========

Each kernel is one streaming pass over HBM, so bytes moved bound it on the
card; the design is one thread per element with coalesced loads (see the
source). The q-step diagonal enters as its two distinct values (interior,
boundary time slab) instead of two diagonal arrays, which saves ~0.2 GB of
reads per qx pass at 513^2 x 65. The weighted q-step (obstacles,
``solver_wsocp_inPALM.m:198-222``) is the same kernel with the weight w
read once: it forms 1/(base + w*w) in registers from w and base's two
values, and reads no diagonal array (0.41 GB less than carrying one); its
plain version multiplies by the inverse diagonal that
:func:`weighted_dinv` computes once a level, and the kernel rounds every
operation as that plain version does. Shared-memory tiling, TMA and
merging cx with the next qx are left for later work.

Dispatch: a wrapper runs the plain version only because the tensors it was
given lie on the CPU. On CUDA tensors it checks device, dtype (f32 only),
shape, contiguity and aliasing, launches the kernel, and raises on any
error; there is no fallback. Every launch adds one to ``LAUNCHES[name]``;
the weighted q-step counts under ``qx_step_w``.

In-place outputs: ``qx_step`` updates alpha, and ``cx_step`` / ``cx_final``
update beta and x, in the buffers they were given (each thread reads those
arrays only at its own position, so concurrent blocks cannot race). Callers
use the returned tensors and treat the inputs as consumed; the plain
versions return new tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .cone import proj_soc
from .engine import _INV_SQRT2, OpsFlat, base_values
from .staggered import Staggered

LAUNCHES = {"x_step": 0, "qx_step": 0, "qx_step_w": 0, "cx_step": 0,
            "cx_final": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class WeightedDinv(NamedTuple):
    """The weighted q-step's diagonal: the flat weight ``w`` (ghost slots
    1.0), the (interior, boundary-slab) values ``base`` of (E/D)^2 F*B*BF's
    diagonal, and ``inv`` = 1 / (base + w*w). The kernel forms ``inv`` in
    registers from ``w`` and ``base``; the plain version reads ``inv``."""

    w: Staggered
    base: tuple
    inv: Staggered


def weighted_dinv(ops: OpsFlat, w: Staggered, D: float,
                  E: float) -> WeightedDinv:
    """1 / (base + w*w) in w's dtype, in the operation order of
    ``dotsocp_tpu/algorithms/core.py:175-179``."""
    diag = ops.oper_q_diag(D, E, w)
    return WeightedDinv(w=w, base=base_values(D, E),
                        inv=Staggered(1.0 / diag.q0, 1.0 / diag.bs))


# -- plain versions (the composition the JAX _step computes) ----------------

def times_dinv(ops: OpsFlat, st: Staggered, dinv) -> Staggered:
    """st * diag^-1: from its (interior, boundary-slab) values, or the
    weighted inverse diagonal of a :class:`WeightedDinv`."""
    if isinstance(dinv, WeightedDinv):
        return st * dinv.inv
    d_in, d_bd = dinv
    row = torch.full((ops.geom.nt, 1), d_in, dtype=st.q0.dtype,
                     device=st.q0.device)
    row[0] = d_bd
    row[-1] = d_bd
    return Staggered(st.q0 * d_in, st.bs * row)


def x_step_plain(ops: OpsFlat, q: Staggered, beta, sbf, sd):
    return proj_soc(ops.bfd(q, sbf, sd) - beta) + beta


def qx_step_plain(ops: OpsFlat, phi, x, alpha: Staggered, dinv, D, sbf, tau):
    tmp = D * ops.grad(phi)
    if isinstance(dinv, WeightedDinv):
        w = dinv.w
        q = times_dinv(ops, w * (tmp + alpha) + ops.bfd_T(x, sbf), dinv)
        return q, alpha + tau * (tmp - w * q)
    q = times_dinv(ops, tmp + alpha + ops.bfd_T(x, sbf), dinv)
    return q, alpha + tau * (tmp - q)


def cx_step_plain(ops: OpsFlat, beta, x, q: Staggered, sbf, sd, tau,
                  final: bool = False):
    z = x - beta
    z2 = ops.bfd(q, sbf, sd)
    beta = beta + tau * (z - z2)
    if final:
        return beta, z
    return beta, proj_soc(z2 - beta) + beta


# -- kernel launch plumbing --------------------------------------------------

def _use_kernel(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for f32 CUDA tensors on
    one device; raises for anything else."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("CUDA kernels take contiguous tensors")
    return True


def _check_shape(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")


def _check_distinct(*tensors: torch.Tensor) -> None:
    ptrs = [t.untyped_storage().data_ptr() for t in tensors]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("kernel operands must not share storage")


def _dims(ops: OpsFlat):
    g = ops.geom
    d = g.ndim_space
    k = list(ops.strides) + [0] * (2 - d)
    n = list(g.space) + [1] * (2 - d)
    hs = [g.hs(a) for a in range(d)] + [1.0] * (2 - d)
    return d, g.nt, ops.S, k, n, hs


def _launch(counts: dict, name: str, fn, device: torch.device,
            *args) -> None:
    """Launch on the current stream of ``device``, raise on a CUDA error,
    and add one to ``counts[name]``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    counts[name] += 1


def _check_cone(ops: OpsFlat, *cones: torch.Tensor) -> None:
    g = ops.geom
    for c in cones:
        _check_shape(c, (g.cone_cols, g.nt - 1, ops.S), "cone array")


def _check_stag(ops: OpsFlat, st: Staggered) -> None:
    g = ops.geom
    _check_shape(st.q0, (g.nt - 1, ops.S), "q0 block")
    _check_shape(st.bs, (g.ndim_space, g.nt, ops.S), "face blocks")


# -- wrappers ----------------------------------------------------------------

def x_step(ops: OpsFlat, q: Staggered, beta, sbf: float, sd: float):
    """x = Pi_K(BF_d q - beta) + beta: the segment prologue."""
    if not _use_kernel(q.q0, q.bs, beta):
        return x_step_plain(ops, q, beta, sbf, sd)
    _check_stag(ops, q)
    _check_cone(ops, beta)
    x = torch.empty_like(beta)
    d, nt, S, k, _, _ = _dims(ops)
    _launch(LAUNCHES, "x_step", _build.library().dotsocp_x_step,
            beta.device, q.q0.data_ptr(), q.bs.data_ptr(), beta.data_ptr(),
            x.data_ptr(), d, nt, S, k[0], k[1], sbf, sd)
    return x


def qx_step(ops: OpsFlat, phi, x, alpha: Staggered, dinv, D: float,
            sbf: float, tau: float):
    """q' = (D grad phi + alpha + sbf BF^T x) * diag^-1 and alpha' = alpha +
    tau (D grad phi - q'); with a :class:`WeightedDinv`, q' = (w (D grad phi
    + alpha) + sbf BF^T x) * diag^-1 and alpha' = alpha + tau (D grad phi -
    w q'). Returns (q', alpha'); on CUDA alpha' is alpha's own buffers,
    updated in place."""
    weighted = isinstance(dinv, WeightedDinv)
    operands = (phi, x, alpha.q0, alpha.bs)
    if weighted:
        operands += (dinv.w.q0, dinv.w.bs)
    if not _use_kernel(*operands):
        return qx_step_plain(ops, phi, x, alpha, dinv, D, sbf, tau)
    g = ops.geom
    _check_shape(phi, (g.nt, ops.S), "phi")
    _check_cone(ops, x)
    _check_stag(ops, alpha)
    if weighted:
        _check_stag(ops, dinv.w)
    _check_distinct(*operands)
    q = Staggered(torch.empty_like(alpha.q0), torch.empty_like(alpha.bs))
    d, nt, S, k, n, hs = _dims(ops)
    args = [phi.data_ptr(), x.data_ptr(), alpha.q0.data_ptr(),
            alpha.bs.data_ptr(), q.q0.data_ptr(), q.bs.data_ptr()]
    if weighted:
        # s_bf / sqrt2 as the plain version's bfd_T rounds it
        name, fn = "qx_step_w", _build.library().dotsocp_qx_step_w
        args += [dinv.w.q0.data_ptr(), dinv.w.bs.data_ptr()]
        diag = list(dinv.base) + [sbf * _INV_SQRT2]
    else:
        name, fn = "qx_step", _build.library().dotsocp_qx_step
        diag = list(dinv)
    _launch(LAUNCHES, name, fn, phi.device, *args, d, nt, S, k[0], k[1],
            n[0], n[1], D, sbf, tau, g.ht, hs[0], hs[1], *diag)
    return q, alpha


def _cx(name: str, final: bool, ops: OpsFlat, beta, x, q: Staggered, sbf,
        sd, tau):
    if not _use_kernel(beta, x, q.q0, q.bs):
        return cx_step_plain(ops, beta, x, q, sbf, sd, tau, final)
    _check_cone(ops, beta, x)
    _check_stag(ops, q)
    _check_distinct(beta, x, q.q0, q.bs)
    d, nt, S, k, _, _ = _dims(ops)
    _launch(LAUNCHES, name, _build.library().dotsocp_cx_step, beta.device,
            q.q0.data_ptr(), q.bs.data_ptr(), beta.data_ptr(), x.data_ptr(),
            d, nt, S, k[0], k[1], sbf, sd, tau, int(final))
    return beta, x


def cx_step(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd: float,
            tau: float):
    """beta' = beta + tau (x - beta - BF_d q') and the next carried x' =
    Pi_K(BF_d q' - beta') + beta'. Returns (beta', x'); on CUDA both are
    the input buffers, updated in place."""
    return _cx("cx_step", False, ops, beta, x, q, sbf, sd, tau)


def cx_final(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd: float,
             tau: float):
    """beta' as in :func:`cx_step`, and the stale z = x - beta that the
    iteration's q-step consumed: the segment-boundary state of the plain
    path. Returns (beta', z)."""
    return _cx("cx_final", True, ops, beta, x, q, sbf, sd, tau)
