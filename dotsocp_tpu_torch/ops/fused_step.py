"""The post-DCT step kernels of the inPALM / ALG2 step, each beside its
plain PyTorch version: the x-carry segment's three, the single step's three
(which sGS-inPALM's step runs after its sweep), and the cone projection
that closes every acc-ADMM step; the phi-step's right-hand side, which
every method forms before its DCT solve or sweep; and the KKT battery's
sums, which every check forms.

Inside a segment the z slot of the state carries x = z + beta: the q-step
only consumes z + beta, so one cone read replaces two, and the CA kernel
(beta multiplier fused with the next cone projection) forms x' = z' + beta'
in registers. The single step (``run_one``, the sGS-inPALM step, the
profiler's full step) keeps z and beta apart, as the JAX ``_step_fused``
does. Eight wrappers over the kernels of ``csrc/fused_step.cu``, and a
ninth before the DCT, the phi-step's right-hand side:

=================  ============================================  ==========
wrapper            replaces (dotsocp_tpu/ops/pallas_kernels.py)  bytes at
                                                                 513^2 x 65
=================  ============================================  ==========
x_step             ``make_fused_flat_step.x_step`` / x_kernel    1.55 GB
qx_step            ``make_fused_flat_step.qx_step`` / qx_kernel  1.35 GB
                   (unweighted); weighted (``WeightedDinv``)     1.56 GB
cx_step            ``make_fused_flat_step.cx_step`` /            2.90 GB
                   ``make_cx_kernel(final=False)``
cx_final           ``make_fused_flat_step.cx_final`` /           2.90 GB
                   ``make_cx_kernel(final=True)``
z_step             ``make_fused_flat_step.z_step`` / z_kernel    1.55 GB
q_step             ``make_fused_flat_step.q_step`` / q_kernel    2.03 GB
                   (unweighted); weighted (``WeightedDinv``)     2.23 GB
beta_step          ``make_fused_flat_step.beta_step`` / b_kernel 2.23 GB
cone_project_diff  ``cone_project_diff_pallas`` / its kernel     2.02 GB
phi_rhs            none: XLA fuses it; PyTorch ran ~20 kernels   0.545 GB
                   (pads, differences, scalings); weighted       0.750 GB
kkt_sums           none: XLA fuses the battery; PyTorch ran      1.89 GB
                   ~300 kernels a check; weighted                2.11 GB
=================  ============================================  ==========

Each kernel is one streaming pass over HBM, so bytes moved bound it on the
card; the design is one thread per element with coalesced loads (see the
source). Every kernel takes one, two or three space axes (C = 6, 10, 14),
each with its own stride, size and spacing (``_dims``). The q-step
diagonal enters as its two distinct values (interior, boundary time slab)
instead of two diagonal arrays, which saves ~0.2 GB of reads per q pass
at 513^2 x 65. The weighted q-step (obstacles,
``solver_wsocp_inPALM.m:198-222``) is the same kernel with the weight w
read once: it forms 1/(base + w*w) in registers from w and base's two
values, and reads no diagonal array (0.41 GB less than carrying one); its
plain version multiplies by the inverse diagonal that
:func:`weighted_dinv` computes once a level, and the kernel rounds every
operation as that plain version does. So do the 3D q-steps, weighted or
not, and the cone projection, whose plain version sums the squares left
to right. Shared-memory tiling, TMA and merging passes are left for later
work.

Dispatch (``_use_kernel``): a wrapper runs the plain version only because
the tensors it was given lie on the CPU, or are float64 (on the card too:
the route by dtype, as the JAX package's float64 runs jnp). On float32
CUDA tensors it checks device, shape, contiguity and aliasing, launches
the kernel, and raises on any error; there is no fallback. Mixed dtypes
and any other dtype on the card raise. Every launch adds one to
``LAUNCHES[name]``; the weighted q-steps count under ``qx_step_w`` and
``q_step_w``, the weighted rhs under ``phi_rhs_w``. The scalars that
change with the problem or the iterate are Python floats (the host
driver's), or one-element float32 tensors on the card (the device
driver's state), which the ``*_dev`` entry of the same kernel reads from
memory, so that a captured CUDA graph replays with the values the tensors
hold then (``_scalar_args``): sd = E / dScale and
sbf = E / D of ``x_step``, ``cx_step``, ``cx_final``, ``z_step`` and
``beta_step``; sbf, the diagonal values and ``sv`` = sbf / sqrt2 as the
host rounds it of the q-steps. ``sv`` is a keyword of every wrapper and
plain version: with tensor scalars the plain versions take it instead of
forming sbf / sqrt2 in the tensors' dtype, so both forms round alike.

The phi-step's right-hand side (``phi_rhs``, D A^T (w q - alpha) + c) is
also routed by the engine: on the flat layout as above, while the shaped
and halo engines keep their own ``grad_T`` composition (the plain version
on their operators). Its scalars, D and the grid spacings, are the
level's and the geometry's, fixed for a captured graph, so they go by
value; the kernel rounds every operation as its plain version does on the
card, the divisions by h as PyTorch's multiplications by the float32
reciprocal, and is bit-equal to it there. It takes any leading instance
axes (the lockstep fleet's stack) in one launch.

The KKT battery's sums (``kkt_sums``: the 17 + 3 d sums of squares and
inner products of ``Kernels._kkt_parts_plain``, under its keys,
:func:`kkt_keys`) are one pass over the state and a one-block reduction,
routed as the rhs is (:func:`kkt_sums_on_kernel`: the flat engine's
float32 CUDA tensors). Every element is rounded as the plain version
rounds it; the sums are taken in float64 in a fixed order, so they repeat
bit for bit and differ from PyTorch's float32 sums only in rounding. The
state's scalars sigma, cScale and dScale are floats or one-element float32
tensors, each read by value or from memory on its own, and the device
driver's E-derived vector is read from memory (``_kkt_scalars``), so a
captured check graph serves every rescale and problem. ``LAUNCHES`` keys
``kkt_sums`` and ``kkt_sums_w`` (weighted) count a battery (two kernels).

Batched forms (the lockstep fleet, ``parallel/batch.py``):
``x_step_batched``, ``qx_step_batched``, ``cx_step_batched`` and
``cx_final_batched`` take B instances stacked on a leading axis (phi
``(B, nt, S)``, q and alpha ``(B, nt-1, S)`` / ``(B, d, nt, S)``, cone
arrays ``(B, C, nt-1, S)``), sd as a ``(B,)`` tensor (each instance's own
E / dScale) and a ``(B,)`` bool mask ``active``, and run as one launch for
the fleet (``LAUNCHES`` keys ``x_step_b``, ``qx_step_b``, ``cx_step_b``,
``cx_final_b``). Where ``active`` is False an instance's slots are left
as they were: the kernels skip its blocks, the plain versions (the
per-instance plain versions over the leading axis) select the old values.
Every output goes to the caller's buffers: x into ``x``, q' into ``q``
(which the q-step does not read), alpha, beta and x in place as below.

In-place outputs: ``qx_step`` updates alpha, and ``cx_step`` / ``cx_final``
update beta and x, in the buffers they were given (each thread reads those
arrays only at its own position, so concurrent blocks cannot race). Callers
use the returned tensors and treat the inputs as consumed; the plain
versions return new tensors. ``z_step``, ``q_step``, ``beta_step`` and
``cone_project_diff`` write only fresh outputs and leave every input as it
was: ``Kernels.run_one`` promises its caller the state survives, and the
acc-ADMM anchors hold the very tensors of the state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .cone import proj_soc
from .engine import _INV_SQRT2, OpsFlat, base_values
from .staggered import Staggered, _map

LAUNCHES = {"x_step": 0, "qx_step": 0, "qx_step_w": 0, "cx_step": 0,
            "cx_final": 0, "z_step": 0, "q_step": 0, "q_step_w": 0,
            "beta_step": 0, "cone_project_diff": 0, "x_step_b": 0,
            "qx_step_b": 0, "cx_step_b": 0, "cx_final_b": 0, "phi_rhs": 0,
            "phi_rhs_w": 0, "kkt_sums": 0, "kkt_sums_w": 0}


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
                        inv=diag.map(lambda b: 1.0 / b))


# -- plain versions (the composition the JAX _step computes) ----------------

def times_dinv(ops: OpsFlat, st: Staggered, dinv) -> Staggered:
    """st * diag^-1: from its (interior, boundary-slab) values, or the
    weighted inverse diagonal of a :class:`WeightedDinv`."""
    if isinstance(dinv, WeightedDinv):
        return st * dinv.inv
    d_in, d_bd = dinv
    row = ops.t_edge_row(d_in, d_bd, st.q0)
    return Staggered(st.q0 * d_in, _map(lambda b: b * row, st.bs))


def x_step_plain(ops: OpsFlat, q: Staggered, beta, sbf, sd, sv=None):
    return proj_soc(ops.bfd(q, sbf, sd, sv) - beta, ops.cone_dim) + beta


def qx_step_plain(ops: OpsFlat, phi, x, alpha: Staggered, dinv, D, sbf, tau,
                  sv=None):
    tmp = D * ops.grad(phi)
    if isinstance(dinv, WeightedDinv):
        w = dinv.w
        q = times_dinv(ops, w * (tmp + alpha) + ops.bfd_T(x, sbf, sv), dinv)
        return q, alpha + tau * (tmp - w * q)
    q = times_dinv(ops, tmp + alpha + ops.bfd_T(x, sbf, sv), dinv)
    return q, alpha + tau * (tmp - q)


def cx_step_plain(ops: OpsFlat, beta, x, q: Staggered, sbf, sd, tau,
                  final: bool = False, sv=None):
    z = x - beta
    z2 = ops.bfd(q, sbf, sd, sv)
    beta = beta + tau * (z - z2)
    if final:
        return beta, z
    return beta, proj_soc(z2 - beta, ops.cone_dim) + beta


def z_step_plain(ops: OpsFlat, q: Staggered, beta, sbf, sd, sv=None):
    return proj_soc(ops.bfd(q, sbf, sd, sv) - beta, ops.cone_dim)


def q_step_plain(ops: OpsFlat, phi, z, beta, alpha: Staggered, dinv, D, sbf,
                 tau, sv=None):
    return qx_step_plain(ops, phi, z + beta, alpha, dinv, D, sbf, tau, sv)


def beta_step_plain(ops: OpsFlat, beta, z, q: Staggered, sbf, sd, tau,
                    sv=None):
    return beta + tau * (z - ops.bfd(q, sbf, sd, sv))


def cone_project_diff_plain(z2, beta):
    """Pi_K(z2 - beta), as :func:`~.cone.proj_soc` computes it but with the
    squares of the tail summed left to right, each operation rounded on its
    own: the order the kernel (and the Pallas z_kernel) sums in, so the two
    are bit-equal on the card, where ``torch.sum`` takes another order."""
    v = z2 - beta
    z0, w = v[0], v[1:]
    nrm2 = w[0] * w[0]
    for c in range(1, w.shape[0]):
        nrm2 = nrm2 + w[c] * w[c]
    nrm = torch.sqrt(nrm2)
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    coef = torch.clamp(0.5 * (1.0 + z0 / safe), 0.0, 1.0)
    head = torch.maximum(z0, coef * nrm)
    return torch.cat([head[None], coef[None] * w], dim=0)


# -- kernel launch plumbing --------------------------------------------------

def _use_kernel(*tensors: torch.Tensor) -> bool:
    """Which version a wrapper runs, by device and dtype alone.

    False (the plain version) for CPU tensors, and for CUDA tensors that
    are all float64: the kernels are float32, and float64 on the card takes
    the plain PyTorch route, as the JAX package's float64 takes jnp where
    its Pallas kernels are gated to float32. This is a route, not a
    fallback: True for float32 CUDA tensors on one device, and the wrapper
    then launches its kernel or raises. Raises for tensors on several
    devices, for mixed dtypes, for any other dtype on the card, and for
    non-contiguous float32 CUDA tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dtypes = {t.dtype for t in tensors}
    if dtypes == {torch.float64}:
        return False
    if dtypes != {torch.float32}:
        raise TypeError(f"CUDA kernels take float32 (float64 runs the plain "
                        f"version), got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
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
    """(d, nt, S) and the stride, size and spacing of the three axes the
    kernels take; an axis a d < 3 grid lacks gets 0, 1 and 1."""
    g = ops.geom
    d = g.ndim_space
    k = list(ops.strides) + [0] * (3 - d)
    n = list(g.space) + [1] * (3 - d)
    hs = [g.hs(a) for a in range(d)] + [1.0] * (3 - d)
    return d, g.nt, ops.S, k, n, hs


def _scalar_args(lib, entry: str, like: torch.Tensor, **scalars):
    """The C entry point and its scalar arguments, in the order given:
    Python floats go by value to ``entry``; one-element float32 tensors on
    ``like``'s device (the device driver's state, see
    ``algorithms/device_driver.py``) go by address to ``entry + "_dev"``,
    which reads the same floats from memory, so a captured CUDA graph
    replays with the values the tensors hold then. Raises for a mix of the
    two and for any other tensor."""
    if not any(isinstance(v, torch.Tensor) for v in scalars.values()):
        return getattr(lib, entry), [float(v) for v in scalars.values()]
    ptrs = []
    for what, v in scalars.items():
        if not isinstance(v, torch.Tensor) or v.device != like.device \
                or v.dtype != torch.float32 or v.numel() != 1:
            got = (f"{v.dtype} {tuple(v.shape)} on {v.device}"
                   if isinstance(v, torch.Tensor) else repr(v))
            raise ValueError(f"{entry}: {what} must be a one-element float32 "
                             f"tensor on {like.device}, as the other scalars "
                             f"are; got {got}")
        ptrs.append(v.data_ptr())
    return getattr(lib, entry + "_dev"), ptrs


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

def x_step(ops: OpsFlat, q: Staggered, beta, sbf: float, sd: float,
           sv=None):
    """x = Pi_K(BF_d q - beta) + beta: the segment prologue."""
    if not _use_kernel(q.q0, q.bs, beta):
        return x_step_plain(ops, q, beta, sbf, sd, sv)
    _check_stag(ops, q)
    _check_cone(ops, beta)
    x = torch.empty_like(beta)
    d, nt, S, k, _, _ = _dims(ops)
    fn, scal = _scalar_args(_build.library(), "dotsocp_x_step", beta,
                            sbf=sbf, sd=sd)
    _launch(LAUNCHES, "x_step", fn, beta.device, q.q0.data_ptr(),
            q.bs.data_ptr(), beta.data_ptr(), x.data_ptr(), d, nt, S, *k,
            *scal)
    return x


def _check_q_operands(ops: OpsFlat, phi, alpha: Staggered, dinv) -> None:
    _check_shape(phi, (ops.geom.nt, ops.S), "phi")
    _check_stag(ops, alpha)
    if isinstance(dinv, WeightedDinv):
        _check_stag(ops, dinv.w)


def _weight_operands(dinv) -> tuple:
    if isinstance(dinv, WeightedDinv):
        return dinv.w.q0, dinv.w.bs
    return ()


def _launch_q(kind: str, ops: OpsFlat, operands: list, dinv, D: float,
              sbf: float, tau: float, sv) -> None:
    """Launch the q-step kernel ``kind`` (``qx_step`` or ``q_step``; its
    weighted entry for a :class:`WeightedDinv`) on the tensor operands
    ``operands``, followed by the weight and the scalars (by value, or
    from memory: see ``_scalar_args``)."""
    g = ops.geom
    d, nt, S, k, n, hs = _dims(ops)
    if isinstance(dinv, WeightedDinv):
        kind += "_w"
        operands = operands + [dinv.w.q0, dinv.w.bs]
        diag = list(dinv.base)
    else:
        diag = list(dinv)
    if sv is None and not isinstance(sbf, torch.Tensor):
        # s_bf / sqrt2 as the plain version's bfd_T rounds it: the weighted
        # and the 3D kernels round as their plain versions do
        sv = sbf * _INV_SQRT2
    like = operands[0]
    fn, (sbf_a, din_a, dbd_a, sv_a) = _scalar_args(
        _build.library(), "dotsocp_" + kind, like, sbf=sbf, diag_in=diag[0],
        diag_bd=diag[1], sv=sv)
    if isinstance(sbf, torch.Tensor):
        # the _dev entry takes the four addresses after hs0..hs2
        args = [D, tau, g.ht, *hs, sbf_a, sv_a, din_a, dbd_a]
    else:
        args = [D, sbf_a, tau, g.ht, *hs, din_a, dbd_a, sv_a]
    _launch(LAUNCHES, kind, fn, like.device, *[t.data_ptr() for t in operands],
            d, nt, S, *k, *n, *args)


def qx_step(ops: OpsFlat, phi, x, alpha: Staggered, dinv, D: float,
            sbf: float, tau: float, sv=None):
    """q' = (D grad phi + alpha + sbf BF^T x) * diag^-1 and alpha' = alpha +
    tau (D grad phi - q'); with a :class:`WeightedDinv`, q' = (w (D grad phi
    + alpha) + sbf BF^T x) * diag^-1 and alpha' = alpha + tau (D grad phi -
    w q'). Returns (q', alpha'); on CUDA alpha' is alpha's own buffers,
    updated in place."""
    operands = (phi, x, alpha.q0, alpha.bs) + _weight_operands(dinv)
    if not _use_kernel(*operands):
        return qx_step_plain(ops, phi, x, alpha, dinv, D, sbf, tau, sv)
    _check_q_operands(ops, phi, alpha, dinv)
    _check_cone(ops, x)
    _check_distinct(*operands)
    q = Staggered(torch.empty_like(alpha.q0), torch.empty_like(alpha.bs))
    _launch_q("qx_step", ops, [phi, x, alpha.q0, alpha.bs, q.q0, q.bs], dinv,
              D, sbf, tau, sv)
    return q, alpha


def _cx(name: str, final: bool, ops: OpsFlat, beta, x, q: Staggered, sbf,
        sd, tau, sv):
    if not _use_kernel(beta, x, q.q0, q.bs):
        return cx_step_plain(ops, beta, x, q, sbf, sd, tau, final, sv)
    _check_cone(ops, beta, x)
    _check_stag(ops, q)
    _check_distinct(beta, x, q.q0, q.bs)
    d, nt, S, k, _, _ = _dims(ops)
    fn, scal = _scalar_args(_build.library(), "dotsocp_cx_step", beta,
                            sbf=sbf, sd=sd)
    _launch(LAUNCHES, name, fn, beta.device, q.q0.data_ptr(),
            q.bs.data_ptr(), beta.data_ptr(), x.data_ptr(), d, nt, S, *k,
            *scal, tau, int(final))
    return beta, x


def cx_step(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd: float,
            tau: float, sv=None):
    """beta' = beta + tau (x - beta - BF_d q') and the next carried x' =
    Pi_K(BF_d q' - beta') + beta'. Returns (beta', x'); on CUDA both are
    the input buffers, updated in place."""
    return _cx("cx_step", False, ops, beta, x, q, sbf, sd, tau, sv)


def cx_final(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd: float,
             tau: float, sv=None):
    """beta' as in :func:`cx_step`, and the stale z = x - beta that the
    iteration's q-step consumed: the segment-boundary state of the plain
    path. Returns (beta', z)."""
    return _cx("cx_final", True, ops, beta, x, q, sbf, sd, tau, sv)


# -- the single step: fresh outputs, inputs left as they were ----------------

def z_step(ops: OpsFlat, q: Staggered, beta, sbf: float, sd: float,
           sv=None):
    """z = Pi_K(BF_d q - beta): the z-step."""
    if not _use_kernel(q.q0, q.bs, beta):
        return z_step_plain(ops, q, beta, sbf, sd, sv)
    _check_stag(ops, q)
    _check_cone(ops, beta)
    z = torch.empty_like(beta)
    d, nt, S, k, _, _ = _dims(ops)
    fn, scal = _scalar_args(_build.library(), "dotsocp_z_step", beta,
                            sbf=sbf, sd=sd)
    _launch(LAUNCHES, "z_step", fn, beta.device, q.q0.data_ptr(),
            q.bs.data_ptr(), beta.data_ptr(), z.data_ptr(), d, nt, S, *k,
            *scal)
    return z


def q_step(ops: OpsFlat, phi, z, beta, alpha: Staggered, dinv, D: float,
           sbf: float, tau: float, sv=None):
    """The q-step and alpha multiplier of :func:`qx_step` from z and beta
    read apart (x = z + beta formed per element). Returns fresh (q',
    alpha')."""
    operands = (phi, z, beta, alpha.q0, alpha.bs) + _weight_operands(dinv)
    if not _use_kernel(*operands):
        return q_step_plain(ops, phi, z, beta, alpha, dinv, D, sbf, tau,
                            sv)
    _check_q_operands(ops, phi, alpha, dinv)
    _check_cone(ops, z, beta)
    q = Staggered(torch.empty_like(alpha.q0), torch.empty_like(alpha.bs))
    a = Staggered(torch.empty_like(alpha.q0), torch.empty_like(alpha.bs))
    _launch_q("q_step", ops, [phi, z, beta, alpha.q0, alpha.bs, a.q0, a.bs,
                              q.q0, q.bs], dinv, D, sbf, tau, sv)
    return q, a


def beta_step(ops: OpsFlat, beta, z, q: Staggered, sbf: float, sd: float,
              tau: float, sv=None):
    """beta' = beta + tau (z - BF_d q'), fresh."""
    if not _use_kernel(beta, z, q.q0, q.bs):
        return beta_step_plain(ops, beta, z, q, sbf, sd, tau, sv)
    _check_cone(ops, beta, z)
    _check_stag(ops, q)
    out = torch.empty_like(beta)
    d, nt, S, k, _, _ = _dims(ops)
    fn, scal = _scalar_args(_build.library(), "dotsocp_beta_step", beta,
                            sbf=sbf, sd=sd)
    _launch(LAUNCHES, "beta_step", fn, beta.device, q.q0.data_ptr(),
            q.bs.data_ptr(), beta.data_ptr(), z.data_ptr(), out.data_ptr(), d,
            nt, S, *k, *scal, tau)
    return out


def cone_project_diff(z2, beta):
    """z = Pi_K(z2 - beta) over the leading (cone) axis, fresh; any shape
    (C, ...) with C >= 2, both operands alike."""
    if not _use_kernel(z2, beta):
        return cone_project_diff_plain(z2, beta)
    _check_shape(beta, z2.shape, "beta")
    C = z2.shape[0]
    M = z2.numel() // max(C, 1)
    if C < 2 or M < 1 or M >= 2 ** 31:
        raise ValueError(f"cone_project_diff: shape {tuple(z2.shape)} is not "
                         f"a cone array (C >= 2 and 1 <= M < 2^31 columns)")
    z = torch.empty_like(z2)
    _launch(LAUNCHES, "cone_project_diff",
            _build.library().dotsocp_cone_project_diff, z2.device,
            z2.data_ptr(), beta.data_ptr(), z.data_ptr(), C, M)
    return z


# -- the phi-step's right-hand side -------------------------------------------

def phi_rhs_plain(ops, q: Staggered, alpha: Staggered, c, D,
                  weight: Staggered = None):
    """D A^T (w q - alpha) + c composed from the engine's operators (w = 1
    without a weight): the ~20 PyTorch kernels that ``rhs_kernel``
    replaces, and the kernel's reference."""
    wq = q if weight is None else weight * q
    return D * ops.grad_T(wq - alpha) + c


def _reciprocal_f32(h: float) -> float:
    """1/h as PyTorch forms it to divide a float32 CUDA tensor by the
    Python float h: both rounded to float32, divided in float32."""
    return float(np.float32(1.0) / np.float32(h))


def phi_rhs(ops, q: Staggered, alpha: Staggered, c, D: float,
            weight: Staggered = None):
    """The phi-step's right-hand side D A^T (w q - alpha) + c, fresh; any
    leading instance axes (q0 ``(..., nt-1, S)``, face blocks ``(..., d,
    nt, S)``, c ``(..., nt, S)``), one weight shared by the instances. On
    the flat engine's float32 CUDA tensors one launch of ``rhs_kernel``
    (bit-equal to :func:`phi_rhs_plain` there); on any other engine, and
    on the CPU or in float64, the plain version."""
    if ops.layout != "flat":
        return phi_rhs_plain(ops, q, alpha, c, D, weight)
    arrays = [q.q0, q.bs, alpha.q0, alpha.bs, c]
    if weight is not None:
        arrays += [weight.q0, weight.bs]
    if not _use_kernel(*arrays):
        return phi_rhs_plain(ops, q, alpha, c, D, weight)
    if isinstance(D, torch.Tensor):
        raise ValueError("phi_rhs: D goes to the kernel by value, a Python "
                         "float (the level's, fixed for a captured graph)")
    g = ops.geom
    d, nt, S, k, _, hs = _dims(ops)
    lead = tuple(c.shape[:-2])
    B = int(np.prod(lead))
    _check_shape(c, lead + (nt, S), "c")
    for st in (q, alpha):
        _check_shape(st.q0, lead + (nt - 1, S), "q0 block")
        _check_shape(st.bs, lead + (d, nt, S), "face blocks")
    if weight is not None:
        _check_stag(ops, weight)
    if not 1 <= B <= 65535:
        raise ValueError(f"phi_rhs: {B} instances, the kernel takes 1 to "
                         f"65535")
    out = torch.empty_like(c)
    w0, wb = (None, None) if weight is None else (weight.q0.data_ptr(),
                                                  weight.bs.data_ptr())
    inv = [_reciprocal_f32(h) for h in [g.ht] + hs]
    _launch(LAUNCHES, "phi_rhs" if weight is None else "phi_rhs_w",
            _build.library().dotsocp_phi_rhs, c.device, q.q0.data_ptr(),
            q.bs.data_ptr(), alpha.q0.data_ptr(), alpha.bs.data_ptr(),
            c.data_ptr(), w0, wb, out.data_ptr(), B, d, nt, S, *k, float(D),
            *inv)
    return out


# -- the KKT battery's sums ----------------------------------------------------

# the sums of ``Kernels._kkt_parts_plain`` (``algorithms/core.py``) in its
# order; then m, rb and diff of each space axis (:func:`kkt_keys`)
KKT_KEYS = ("q", "z", "aphi", "alpha", "beta", "fbbeta", "prim1", "prim2",
            "dual1", "dual2", "complem", "phi", "pri", "dual", "dotcomplem",
            "rho", "rhoFq")


def kkt_keys(d: int) -> tuple:
    """The battery's sums, in order, on a grid of ``d`` space axes."""
    return KKT_KEYS + tuple(f"{k}{a}" for a in range(d)
                            for k in ("m", "rb", "diff"))


def kkt_sums_on_kernel(ops, *tensors) -> bool:
    """Whether :func:`kkt_sums` takes a state of these tensors: the flat
    engine's float32 CUDA tensors (``_use_kernel``, which raises for mixed
    dtypes and the like). The CPU, float64 (the refine tail) and the "3d"
    and halo engines keep the plain sums (``Kernels._kkt_parts_plain``)."""
    return ops.layout == "flat" and _use_kernel(*tensors)


def _state_scalar(what: str, v, like: torch.Tensor):
    """(value, address) of one of the state's scalars: a Python float by
    value, a one-element float32 tensor on ``like``'s device (the device
    driver's, or an instance of a fleet's) by address."""
    if not isinstance(v, torch.Tensor):
        return float(v), None
    if v.device != like.device or v.dtype != torch.float32 or v.numel() != 1:
        raise ValueError(f"kkt_sums: {what} must be a float or a one-element "
                         f"float32 tensor on {like.device}; got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return 0.0, v.data_ptr()


def _kkt_scalars(like, D: float, sigma, cScale, dScale, E, ev) -> list:
    """The kernel's scalar arguments (``KktScalars``): values, then the
    addresses of the tensors among sigma, cScale, dScale and ``ev``. The
    products the battery scales by (E / dScale, sigma cScale D, dScale / D,
    dScale / E) are formed here in double where their operands are floats,
    as the plain version forms them, and by the kernel from the tensors
    where they are not."""
    sig, sig_at = _state_scalar("sigma", sigma, like)
    csc, csc_at = _state_scalar("cScale", cScale, like)
    dsc, dsc_at = _state_scalar("dScale", dScale, like)
    if ev is None:
        if isinstance(E, torch.Tensor):
            raise ValueError("kkt_sums: a tensor E comes with its ev vector")
        sbf = E / D
        e_vals, ev_at = [E, sbf, sbf * _INV_SQRT2, _reciprocal_f32(E)], None
    else:
        if ev.device != like.device or ev.dtype != torch.float32 \
                or ev.numel() < 6 or not ev.is_contiguous() or dsc_at is None:
            raise ValueError("kkt_sums: ev must be the device driver's "
                             "contiguous float32 E-derived vector on the "
                             "fields' device, beside a tensor dScale")
        e_vals, ev_at = [0.0] * 4, ev.data_ptr()
    rs = sig * csc * D if sig_at is None and csc_at is None else 0.0
    if dsc_at is None:
        derived = [E / dsc, rs, dsc / D, dsc / E]
    else:
        derived = [0.0, rs, 0.0, 0.0]
    return [sig, csc, *e_vals, *derived, sig_at, csc_at, dsc_at, ev_at]


def kkt_sums(ops, phi, q: Staggered, z, alpha: Staggered, beta, c,
             weight: Staggered, D: float, sigma, cScale, dScale, E,
             ev=None) -> dict:
    """The KKT battery's sums over the field (``Kernels._kkt_parts_plain``'s
    dict, the same keys in the same order, 0-d float32 tensors) in one
    launch of ``kkt_kernel`` and its one-block ``kkt_finish``, on the flat
    engine's float32 CUDA tensors (:func:`kkt_sums_on_kernel`). Each
    element is rounded as the plain version rounds it; the squares and
    products are summed in float64, in a fixed order, so the sums differ
    from PyTorch's float32 ones only in rounding and repeat bit for bit.
    sigma, cScale and dScale are floats or one-element tensors; ``ev`` is
    the device driver's E-derived vector (``core.EScalars.vec``: E, E/D,
    E/D/sqrt2 at 0, 1, 2 and 1/E at 5) read from memory, or None for the
    float E."""
    g = ops.geom
    d, nt, S, k, n, hs = _dims(ops)
    _check_shape(phi, (nt, S), "phi")
    _check_shape(c, (nt, S), "c")
    _check_stag(ops, q)
    _check_stag(ops, alpha)
    _check_cone(ops, z, beta)
    if weight is not None:
        _check_stag(ops, weight)
    if isinstance(D, torch.Tensor):
        raise ValueError("kkt_sums: D goes to the kernel by value, a Python "
                         "float (the level's, fixed for a captured graph)")
    scal = _kkt_scalars(phi, D, sigma, cScale, dScale, E, ev)
    lib = _build.library()
    rows = lib.dotsocp_kkt_blocks(nt, S)
    keys = kkt_keys(d)
    partial = torch.empty((rows, len(keys)), dtype=torch.float64,
                          device=phi.device)
    out = torch.empty(len(keys), dtype=torch.float32, device=phi.device)
    w0, wb = (None, None) if weight is None else (weight.q0.data_ptr(),
                                                  weight.bs.data_ptr())
    inv = [_reciprocal_f32(h) for h in hs + [g.ht, D]]
    _launch(LAUNCHES, "kkt_sums" if weight is None else "kkt_sums_w",
            lib.dotsocp_kkt_sums, phi.device, phi.data_ptr(),
            q.q0.data_ptr(), q.bs.data_ptr(), z.data_ptr(),
            alpha.q0.data_ptr(), alpha.bs.data_ptr(), beta.data_ptr(),
            c.data_ptr(), w0, wb, partial.data_ptr(), rows, out.data_ptr(),
            d, nt, S, *k, *n, *inv[:4], float(D), inv[4], *scal)
    return dict(zip(keys, out.unbind(0)))


# -- batched forms: B instances in one launch --------------------------------

def select_instance(active, b: int, new, old):
    """Instance b's ``new`` where ``active[b]``, else ``old`` (tensors or
    Staggered): the mask as a select, on the card with no host read."""
    if isinstance(new, Staggered):
        return new.map(lambda n, o: torch.where(active[b], n, o), old)
    return torch.where(active[b], new, old)


def x_step_batched_plain(ops: OpsFlat, q: Staggered, beta, sbf, sd, active,
                         x):
    return torch.stack([
        select_instance(active, b, x_step_plain(ops, q.at(b), beta[b],
                                                sbf, sd[b]), x[b])
        for b in range(beta.shape[0])])


def qx_step_batched_plain(ops: OpsFlat, phi, x, alpha: Staggered,
                          q: Staggered, dinv, D, sbf, tau, active):
    qs, alphas = [], []
    for b in range(phi.shape[0]):
        al = alpha.at(b)
        qn, an = qx_step_plain(ops, phi[b], x[b], al, dinv, D, sbf, tau)
        qs.append(select_instance(active, b, qn, q.at(b)))
        alphas.append(select_instance(active, b, an, al))
    return Staggered.stack(qs), Staggered.stack(alphas)


def cx_step_batched_plain(ops: OpsFlat, beta, x, q: Staggered, sbf, sd, tau,
                          active, final: bool = False):
    betas, xs = [], []
    for b in range(beta.shape[0]):
        bn, xn = cx_step_plain(ops, beta[b], x[b], q.at(b), sbf,
                               sd[b], tau, final)
        betas.append(select_instance(active, b, bn, beta[b]))
        xs.append(select_instance(active, b, xn, x[b]))
    return torch.stack(betas), torch.stack(xs)


def _check_batch(ops: OpsFlat, B: int, sd=None, active=None, phi=None,
                 cones=(), stags=()) -> None:
    """Shapes of the batched operands: every field (B, ...) as one
    instance's with B in 1..65535 (gridDim.z), sd a (B,) float32 tensor,
    active a (B,) bool tensor, both contiguous on the fields' device."""
    g = ops.geom
    if not 1 <= B <= 65535:
        raise ValueError(f"batch of {B} instances: the kernels take 1 to "
                         f"65535")
    for c in cones:
        _check_shape(c, (B, g.cone_cols, g.nt - 1, ops.S), "cone array")
    for st in stags:
        _check_shape(st.q0, (B, g.nt - 1, ops.S), "q0 block")
        _check_shape(st.bs, (B, g.ndim_space, g.nt, ops.S), "face blocks")
    if phi is not None:
        _check_shape(phi, (B, g.nt, ops.S), "phi")
    for t, what, dtype in ((sd, "sd", torch.float32),
                           (active, "active", torch.bool)):
        if t is None:
            continue
        _check_shape(t, (B,), what)
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: a contiguous {dtype} tensor, got "
                             f"{t.dtype}")


def _active_operand(active, device) -> torch.Tensor:
    if not isinstance(active, torch.Tensor) or active.device != device:
        raise ValueError(f"active must be a (B,) bool tensor on {device}")
    return active


def x_step_batched(ops: OpsFlat, q: Staggered, beta, sbf: float, sd, active,
                   x):
    """x = Pi_K(BF_d q - beta) + beta for each active instance, into ``x``
    (``(B, C, nt-1, S)``; an inactive instance's slots keep their values);
    ``sd`` (B,). On CUDA ``x`` itself, written in place (no thread reads
    it); the plain version returns a new tensor."""
    if not _use_kernel(q.q0, q.bs, beta, x, sd):
        return x_step_batched_plain(ops, q, beta, sbf, sd, active, x)
    B = beta.shape[0]
    _check_batch(ops, B, sd, _active_operand(active, beta.device),
                 cones=(beta, x), stags=(q,))
    _check_distinct(q.q0, q.bs, beta, x)
    d, nt, S, k, _, _ = _dims(ops)
    _launch(LAUNCHES, "x_step_b", _build.library().dotsocp_x_step_b,
            beta.device, q.q0.data_ptr(), q.bs.data_ptr(), beta.data_ptr(),
            x.data_ptr(), sd.data_ptr(), active.data_ptr(), B, d, nt, S, *k,
            sbf)
    return x


def qx_step_batched(ops: OpsFlat, phi, x, alpha: Staggered, q: Staggered,
                    dinv, D: float, sbf: float, tau: float, active):
    """:func:`qx_step` (unweighted) for each active instance: q' into
    ``q``, which the step does not read, alpha' into alpha. Returns (q',
    alpha'); on CUDA they are ``q`` and ``alpha``, written in place, an
    inactive instance's slots untouched."""
    if isinstance(dinv, WeightedDinv):
        raise ValueError("qx_step_batched: the lockstep fleet is "
                         "unweighted")
    operands = (phi, x, alpha.q0, alpha.bs, q.q0, q.bs)
    if not _use_kernel(*operands):
        return qx_step_batched_plain(ops, phi, x, alpha, q, dinv, D, sbf,
                                     tau, active)
    B = phi.shape[0]
    _check_batch(ops, B, active=_active_operand(active, phi.device), phi=phi,
                 cones=(x,), stags=(alpha, q))
    _check_distinct(*operands)
    g = ops.geom
    d, nt, S, k, n, hs = _dims(ops)
    _launch(LAUNCHES, "qx_step_b", _build.library().dotsocp_qx_step_b,
            phi.device, phi.data_ptr(), x.data_ptr(), alpha.q0.data_ptr(),
            alpha.bs.data_ptr(), q.q0.data_ptr(), q.bs.data_ptr(),
            active.data_ptr(), B, d, nt, S, *k, *n, D, sbf, tau, g.ht, *hs,
            *dinv, sbf * _INV_SQRT2)
    return q, alpha


def _cx_batched(name: str, final: bool, ops: OpsFlat, beta, x, q: Staggered,
                sbf, sd, tau, active):
    if not _use_kernel(beta, x, q.q0, q.bs, sd):
        return cx_step_batched_plain(ops, beta, x, q, sbf, sd, tau, active,
                                     final)
    B = beta.shape[0]
    _check_batch(ops, B, sd, _active_operand(active, beta.device),
                 cones=(beta, x), stags=(q,))
    _check_distinct(beta, x, q.q0, q.bs)
    d, nt, S, k, _, _ = _dims(ops)
    _launch(LAUNCHES, name, _build.library().dotsocp_cx_step_b, beta.device,
            q.q0.data_ptr(), q.bs.data_ptr(), beta.data_ptr(), x.data_ptr(),
            sd.data_ptr(), active.data_ptr(), B, d, nt, S, *k, sbf, tau,
            int(final))
    return beta, x


def cx_step_batched(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd,
                    tau: float, active):
    """:func:`cx_step` for each active instance; on CUDA beta and x in
    place, an inactive instance's slots untouched."""
    return _cx_batched("cx_step_b", False, ops, beta, x, q, sbf, sd, tau,
                       active)


def cx_final_batched(ops: OpsFlat, beta, x, q: Staggered, sbf: float, sd,
                     tau: float, active):
    """:func:`cx_final` for each active instance: (beta', z)."""
    return _cx_batched("cx_final_b", True, ops, beta, x, q, sbf, sd, tau,
                       active)
