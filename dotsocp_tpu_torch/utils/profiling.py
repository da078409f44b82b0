"""Per-phase timing and bandwidth report of one level's algorithm; port of
``dotsocp_tpu/utils/profiling.py:51-202``.

The reference wraps every algorithm step in tic/toc and prints a named
table (Step_1_1_FFT, Step_1_2_ProjSOC, Step_2_Q_Step, Step_3_Multiplier,
KKT, Total_Time, Iters: ``solver_socp_inPALM.m:124-128,339-341``). Here each
phase runs ``iters`` times chained through its own output (so every call
consumes the last one's result), timed with CUDA events on a card and with
the host clock on the CPU. Each row has the phase's milliseconds a call
and, where the phase's bytes are counted, its achieved GB/s; on a card
whose full name ``hbm_peak_for`` knows (the H100 SXM, PCIe and NVL parts)
also its share of that card's HBM peak. No roofline is reported for any
other device.

The phase bodies are the port's counterparts of the JAX bodies:
``phi_dct_solve`` the DCT solve, ``phi_sgs_sweep`` the sweep kernel
(``ops/sgs_sweep.rb_sweep``), ``cone_projection`` the ``cone_project_diff``
kernel (the JAX phase's very function and bytes), ``full_step_fused`` the
level's ``_step`` (for inPALM / ALG2, weighted or not, the single-step
kernels); ``q_step``, ``multiplier``, ``kkt_battery`` and
``halpern_averaging`` stay PyTorch compositions, as the JAX bodies are jnp
compositions. ``halpern_averaging`` is the averaging after a step: Halpern's
for acc-ADMM and acc-sGS-ADMM, the extrapolation of acc-ADMM's Nesterov
branch for theta != 2. A phase that fails raises.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..algorithms.variants import AccState, NesterovState
from ..ops.fused_step import cone_project_diff

# HBM bandwidth (bytes/s) of the cards this module reports a share for, by
# the full name torch.cuda.get_device_name gives (NVIDIA's data sheets)
HBM_PEAKS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def hbm_peak_for(name: str):
    """The HBM peak in bytes/s of the card named ``name`` (exactly as
    ``torch.cuda.get_device_name`` gives it), or None for a card this
    module does not know: no share is reported against a guessed peak."""
    return HBM_PEAKS.get(name)


def _nbytes(*tensors) -> int:
    """Bytes of tensors and Staggered fields."""
    total = 0
    for t in tensors:
        for b in (t.blocks() if hasattr(t, "blocks") else [t]):
            total += b.numel() * b.element_size()
    return total


def _time_ms(fn: Callable, x, iters: int, device: torch.device) -> float:
    """Milliseconds per call of ``iters`` chained calls x = fn(x), after one
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    x = fn(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            x = fn(x)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    return (time.perf_counter() - t0) * 1e3 / iters


def _hbm_peak(device: torch.device):
    """The card's HBM bandwidth in bytes/s where this module holds it,
    else None (and None off the card)."""
    if device.type != "cuda":
        return None
    return hbm_peak_for(torch.cuda.get_device_name(device))


def profile_phases(kernels, state, iters: int = 30) -> Dict[str, dict]:
    """Time each phase of ``kernels``' algorithm from ``state`` (a
    SolverState, or an acc state). Returns {phase: {ms[, gbps,
    pct_roofline]}}; phase bytes are the least HBM traffic (each operand
    read once, each result written once), as the JAX package counts them.
    ``state`` is left as it was."""
    acc_state = state if isinstance(state, (AccState, NesterovState)) else None
    if acc_state is not None:
        state = state.s
    cfg = kernels.cfg
    ops = kernels.ops
    device = state.phi.device
    sgs = getattr(kernels, "sgs", None)
    z2 = ops.bfd(state.q, state.E / state.D, state.E / state.dScale)

    def q_step(s):
        tmp_q = s.D * ops.grad(s.phi)
        q2 = ops.bfd_T(s.z + s.beta, s.E / s.D)
        return kernels._q_solve(s, tmp_q, q2)

    def mult_chain(s):
        tmp_q = s.D * ops.grad(s.phi)
        z2 = ops.bfd(s.q, s.E / s.D, s.E / s.dScale)
        return s.replace(alpha=s.alpha + cfg.tau * (tmp_q - kernels._w(s.q)),
                         beta=s.beta + cfg.tau * (s.z - z2))

    def kkt_chain(s):
        kernels._kkt(s)
        return s

    q_bytes = _nbytes(state.q)
    phi_bytes = _nbytes(state.phi)
    z_bytes = _nbytes(state.z)
    c_bytes = _nbytes(state.c)
    phase_bytes = {
        # rhs build: read q, alpha, c; write/read rhs through the DCT
        # matmul chain (6 transforms, each read + write) + write phi
        "phi_dct_solve": q_bytes * 2 + c_bytes * (1 + 12 + 1),
        # rhs build (q, alpha, c read; rhs write) + one sweep (phi, rhs
        # read; the new phi written)
        "phi_sgs_sweep": q_bytes * 2 + c_bytes + phi_bytes * (1 + 3),
        # read z2, beta; write z
        "cone_projection": z_bytes * 3,
        # read phi, z, beta, alpha, diag; write q
        "q_step": phi_bytes + z_bytes * 2 + q_bytes * 3,
        # read phi, q, z, alpha, beta; write alpha, beta, z2
        "multiplier": phi_bytes + q_bytes * 3 + z_bytes * 4,
        # read anchor, old, cur; write the new iterate (+ anchor select)
        "halpern_averaging": (phi_bytes + q_bytes * 2 + z_bytes * 2) * 4,
    }

    # each phase chained through its own output: (body, its first input)
    chained = {}
    if sgs is not None:
        chained["phi_sgs_sweep"] = (
            lambda s: s.replace(phi=kernels._sweep(s, kernels._rhs(s))), state)
    else:
        chained["phi_dct_solve"] = (
            lambda s: s.replace(c=kernels._poisson_solve(s, kernels._rhs(s))),
            state)
    chained.update({
        "cone_projection": (lambda z: cone_project_diff(z, state.beta), z2),
        "q_step": (lambda s: s.replace(alpha=q_step(s)), state),
        "multiplier": (mult_chain, state),
        "kkt_battery": (kkt_chain, state),
        "full_step_fused": (kernels._step, state),
    })
    if acc_state is not None:
        chained["halpern_averaging"] = (kernels.post_check, acc_state)

    peak = _hbm_peak(device)
    out = {}
    for name, (fn, x) in chained.items():
        ms = _time_ms(fn, x, iters, device)
        row = {"ms": ms}
        nb = phase_bytes.get(name)
        if nb:
            row["gbps"] = nb / (ms * 1e-3) / 1e9
            if peak is not None:
                row["pct_roofline"] = 100.0 * row["gbps"] * 1e9 / peak
        out[name] = row
    return out


def format_table(prof: Dict[str, dict]) -> str:
    lines = [f"{'phase':<18} {'ms':>9} {'GB/s':>9} {'%roof':>7}"]
    for name, row in prof.items():
        gb = f"{row['gbps']:.1f}" if "gbps" in row else "-"
        pr = f"{row['pct_roofline']:.1f}" if "pct_roofline" in row else "-"
        lines.append(f"{name:<18} {row['ms']:>9.3f} {gb:>9} {pr:>7}")
    return "\n".join(lines)
