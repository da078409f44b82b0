"""Host-side orchestration of one level's solve; port of
``dotsocp_tpu/algorithms/driver.py:35-364``.

The math runs as device segments (:mod:`.core`, :mod:`.variants`); this
module replicates the reference's *scheduling* exactly:

- KKT cadence: ``IfAdjustSigma`` tables (``solver_socp_inPALM.m:361-379``;
  sGS variant with the n^(1/3)/33 scale, ``solver_socp_sGSinPALM.m:431-456``).
  KKT checks happen only at cadence points / maxit / time limit, so checking
  at segment boundaries equals the reference's per-iteration test.
- sigma update: stepped multiplier table on resiPri/resiDual with the
  [1e-3, 1e3] clamp (``utils/adjust_lagrangianParam.m``).
- dynamic rescaling state machine: 1st at it>=10 & feas<2e-2 & gap<5e-2,
  2nd at it>=50 & feas<5e-3 & gap<1e-2, then every ``check_every`` iters
  when the primal/dual norm ratio exceeds 1.2
  (``solver_socp_inPALM.m:70-77,139-190``). The driver splits segments at
  exactly those iteration numbers.

Iteration accounting: ``it`` counts *completed* iterations and equals the
reference's bottom-of-loop ``it``; a top-of-loop event of reference
iteration ``e`` fires after ``e - 1`` completed iterations.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from ..parallel import comm
from .core import Kernels

# sigma update table for inPALM / PALM / acc-ADMM
# (``solver_socp_inPALM.m:39-51``)
UPDATE_RULE = [
    (1.1, 1.10), (1.2, 1.15), (1.5, 1.20), (2.0, 1.26), (2.5, 1.28),
    (3.33, 1.32), (5.0, 1.35), (10.0, 1.40), (20.0, 1.60), (40.0, 1.80),
    (50.0, 2.00),
]
# sGS variants use a shorter table (``solver_socp_sGSinPALM.m:40-47``)
UPDATE_RULE_SGS = [
    (1.5, 1.20), (2.0, 1.26), (2.5, 1.28), (3.33, 1.32), (5.0, 1.35),
    (10.0, 1.40),
]

SIGMA_BOUNDS = (1e-3, 1e3)


def get_factor(xi: float, rule) -> float:
    """Largest table factor whose threshold xi exceeds; symmetric via 1/xi
    (``adjust_lagrangianParam.m:30-38,49-60``)."""
    if xi < 1.0:
        return 1.0 / get_factor(1.0 / xi, rule)
    factor = 1.0
    for thr, f in rule:
        if xi >= thr:
            factor = f
        else:
            break
    return factor


def adjust_sigma(sigma: float, xi: float, rule) -> tuple[float, float]:
    """Returns (new_sigma, applied_factor) with the [1e-3,1e3] clamp."""
    factor = get_factor(xi, rule)
    if factor != 1.0:
        new = min(max(sigma * factor, SIGMA_BOUNDS[0]), SIGMA_BOUNDS[1])
        return new, new / sigma
    return sigma, 1.0


def _cadence_threshold(it: float) -> int:
    if it < 20:
        return 3
    if it < 50:
        return 6
    if it < 100:
        return 10
    if it < 200:
        return 15
    if it < 500:
        return 25
    return 40


def _cadence_threshold_sgs(it: float) -> int:
    if it < 20:
        return 5
    if it < 50:
        return 10
    if it < 100:
        return 20
    if it < 200:
        return 35
    if it < 500:
        return 50
    return 100


def is_cadence_point(it: int, last_sigma_it: float,
                     sgs_scale: Optional[float] = None) -> bool:
    """IfAdjustSigma(it, last): the inPALM table, or the sGS table on
    iterations divided by ``sgs_scale``."""
    if sgs_scale is None:
        return it - last_sigma_it >= _cadence_threshold(it)
    return ((it - last_sigma_it) / sgs_scale
            >= _cadence_threshold_sgs(it / sgs_scale))


def next_check_iter(it: int, last_sigma_it: float,
                    sgs_scale: Optional[float] = None) -> int:
    """Smallest reference-iteration e > it with IfAdjustSigma(e, last) true."""
    e = it + 1
    while not is_cadence_point(e, last_sigma_it, sgs_scale):
        e += 1
    return e


@dataclasses.dataclass
class SolveOptions:
    tol: float = 1e-4
    maxit: int = 3000
    sigma: float = 1.0
    tau: float = 1.9
    time_limit: float = 3600.0
    scaling: bool = True
    check_step_by_step: bool = False
    check_prim_dual_feas: bool = True
    # acc-ADMM extras (``solver_socp_accADMM.m:12-34``); the port runs the
    # Halpern branch only (theta = 2), so it keeps no theta
    restart: int = 100
    rho: float = 2.0
    # NaN tripwire: a KKT check that reads a residual that is not finite
    # raises FloatingPointError naming ``label`` (the level), the iteration
    # and the residual. It reads the residuals the check fetches anyway.
    debug_nans: bool = False
    label: str = "level 1"


@dataclasses.dataclass
class RunHistory:
    """Per-check records (``runHist``: kkt 7-vector, time, iter, pdGap)."""

    kkt: list = dataclasses.field(default_factory=list)
    time: list = dataclasses.field(default_factory=list)
    iter: list = dataclasses.field(default_factory=list)
    pd_gap: list = dataclasses.field(default_factory=list)
    method: str = ""

    def append(self, kkt7, t, it, gap):
        self.kkt.append(np.asarray(kkt7))
        self.time.append(t)
        self.iter.append(it)
        self.pd_gap.append(gap)

    def as_arrays(self):
        return {
            "kkt": np.array(self.kkt) if self.kkt else np.zeros((0, 7)),
            "time": np.array(self.time),
            "iter": np.array(self.iter),
            "pdGap": np.array(self.pd_gap),
            "len": len(self.iter),
            "method": self.method,
        }


class RescaleMachine:
    """The 1st/2nd/periodic rescale trigger logic."""

    FIRST_ITER = 10
    SECOND_ITER = 50
    RATIO_THRESHOLD = 1.2

    def __init__(self, enabled: bool, check_every: int):
        self.stage = 1 if enabled else 0
        self.check_every = check_every
        self.max_feas = math.inf
        self.rel_gap = math.inf

    def next_trigger(self, it: int) -> float:
        """Reference iteration whose top-of-loop will rescale (inf if none
        is scheduled). For stage>=3 this is the *norm check* iteration;
        whether it rescales depends on the ratio test."""
        if self.stage == 1 and self.max_feas < 2e-2 and self.rel_gap < 5e-2:
            return max(it + 1, self.FIRST_ITER)
        if self.stage == 2 and self.max_feas < 5e-3 and self.rel_gap < 1e-2:
            return max(it + 1, self.SECOND_ITER)
        if self.stage >= 3:
            return ((it // self.check_every) + 1) * self.check_every
        return math.inf

    def update_from_check(self, kkt5_max: float, pd_gap: float):
        if self.stage > 0:
            self.max_feas = kkt5_max
            self.rel_gap = pd_gap


class SegmentSolver:
    """Level solver: segments of event-free iterations between the
    driver's events (KKT checks, sigma updates, rescales). The algorithm
    comes from the ``Kernels`` subclass and the hooks below."""

    name = "Inexact Proximal ALM"
    sgs = False

    def __init__(self, kernels: Kernels, opts: SolveOptions):
        self.k = kernels
        self.opts = opts
        self.rule = UPDATE_RULE_SGS if self.sgs else UPDATE_RULE
        self.rescale_check_every = 100

    # -- hooks -----------------------------------------------------------
    def on_sigma_change(self, state, factor: float):
        return self.k.sigma_mult(state, factor)

    def on_rescale(self, state, d2: float, c2: float):
        return self.k.rescale(state, d2, c2)

    def post_check(self, state):
        """Finish the iteration after a KKT / norms checkpoint (acc-ADMM's
        Halpern averaging lives here). Identity for ALM-type methods."""
        return state

    def sgs_scale(self) -> Optional[float]:
        return None

    def _run_segment(self, state, steps: int):
        """Advance ``steps`` iterations; the sGS solvers override it to
        keep their per-iteration FeasRatio history."""
        state = self.k.run_segment(state, steps)
        self._it += steps
        return state

    def solve(self, var) -> tuple[dict, dict]:
        opts = self.opts
        k = self.k
        state = k.prep(var, opts.sigma)
        hist = RunHistory(method=self.name)
        rescale = RescaleMachine(opts.scaling, self.rescale_check_every)

        self._it = 0
        last_sigma_it = -math.inf
        use_feas_org = False
        tol_feas_org = 5.0 * opts.tol
        stop_idx = [0, 2, 5, 6] if opts.check_prim_dual_feas else [0, 2, 5]
        t0 = time.monotonic()

        while self._it < opts.maxit:
            it = self._it
            e_kkt = (it + 1 if opts.check_step_by_step
                     else next_check_iter(it, last_sigma_it,
                                          self.sgs_scale()))
            e_kkt = min(e_kkt, opts.maxit)
            e_rescale = rescale.next_trigger(it)

            if e_rescale <= e_kkt:
                # run to just before the rescale iteration, then rescale
                steps = int(e_rescale) - 1 - it
                if steps > 0:
                    state = self._run_segment(state, steps)
                    # the reference takes the rescale norms at the top of
                    # an iteration, after the previous one completed
                    # (acc-ADMM's averaging included)
                    state = self.post_check(state)
                norms = k.norms(state)
                norm_phis = max(norms["normPhi"], norms["normQ"],
                                norms["normZ"])
                norm_alps = max(norms["normAlpha"], norms["normBeta"])
                do_it = True
                if rescale.stage >= 3:
                    ratio = max(norm_alps, norm_phis) / max(
                        min(norm_alps, norm_phis), 1e-300)
                    do_it = ratio > rescale.RATIO_THRESHOLD
                if do_it:
                    state = self.on_rescale(state, norm_phis, norm_alps)
                    rescale.stage += 1
                else:
                    # periodic norm check declined; run the checked
                    # iteration so next_trigger advances
                    state = self._run_segment(state, 1)
                    state = self.post_check(state)
                continue

            state = self._run_segment(state, e_kkt - it)
            it = self._it
            res = k.kkt(state)
            elapsed = time.monotonic() - t0

            kkt_org = res["kkt_org"]
            kkt5 = res["kkt"]
            hist.append(kkt_org, elapsed, it, float(res["pdGap"]))
            if opts.debug_nans and not np.isfinite(kkt_org).all():
                bad = int(np.flatnonzero(~np.isfinite(kkt_org))[0])
                raise FloatingPointError(
                    f"{opts.label}: KKT residual {bad + 1} is "
                    f"{kkt_org[bad]} at iteration {it}")

            late = elapsed > opts.time_limit
            if k.ops.mesh is not None:
                # every rank of a mesh stops at the same check
                late = comm.any_true(late, k.ops.mesh)
            if max(kkt_org[i] for i in stop_idx) < opts.tol or late:
                break

            if max(kkt5) < tol_feas_org:
                use_feas_org = True

            if is_cadence_point(it, last_sigma_it, self.sgs_scale()):
                last_sigma_it = it
                state = self._sigma_update(state, kkt_org, kkt5, use_feas_org,
                                           res)

            rescale.update_from_check(float(max(kkt5)), float(res["pdGap"]))
            # complete the iteration (acc-ADMM's averaging; no-op otherwise)
            state = self.post_check(state)

        var = k.finalize(state, var)
        var["name"] = self.name
        var["iters"] = self._it
        var["solve_time"] = time.monotonic() - t0
        return hist.as_arrays(), var

    def _sigma_update(self, state, kkt_org, kkt5, use_feas_org, res):
        """Default sigma strategy (``solver_socp_inPALM.m:297-316``);
        ``res`` is the whole KKT result, which the sGS strategy reads."""
        if use_feas_org:
            resi_pri = max(kkt_org[0], kkt_org[1])
            resi_dual = max(kkt_org[2], kkt_org[4])
        else:
            resi_pri = max(kkt5[0], kkt5[1])
            resi_dual = max(kkt5[2], kkt5[4])
        _, factor = adjust_sigma(self.k.get_sigma(state),
                                 resi_pri / max(resi_dual, 1e-300), self.rule)
        if factor != 1.0:
            state = self.on_sigma_change(state, factor)
        return state
