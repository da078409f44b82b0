"""The device driver of the sGS variants (sGS-inPALM, acc-sGS-ADMM); port
of ``dotsocp_tpu/algorithms/device_sgs.py``.

It extends :class:`.device_driver.DeviceDriver` with the sGS sigma
machinery (``solver_socp_sGSinPALM.m:76-80,321-393``): a per-iteration
FeasRatio history in a ring of 32 on the card, the 19-history /
12-victory win count, the superiority gate resi_sGS < 0.95 kkt_sGS, the
between-check cheap feasibility update while superior (else the previous
entry carried), the 1.10 warm-up factor before the stable phase
(it > 2500), and the cadence on it / (n^(1/3) / 33), in float32 as the JAX
driver computes it.

The loop runs iteration by iteration, as the JAX ``body`` does: the
top-of-iteration rescale where one is due, the instrumented step (the sGS
block residual after every sweep), then the check or the between-check
update, then (acc-sGS-ADMM) the Halpern averaging. ``superior`` changes
only at a check, so the host learns it from the check's record and picks
the between-check graph (superior entry or carried entry) of the
iterations up to the next check; this replaces the host driver's per-check
read of the feasibility history (``algorithms/solvers.py``). The
between-check iterations up to a check, with their rescales, are one
segment of the loop's stats and spans.
"""
from __future__ import annotations

import time

import torch

from ..utils.trace import span
from .device_driver import (DeviceDriver, HalpernMixin, _f32, _pick,
                            _step_lookup, _table_factor)
from .driver import UPDATE_RULE_SGS, SolveOptions
from .variants import ITERATE

RING = 32   # >= the 20-entry window, a power of two
_CADENCE_EDGES = (20, 50, 100, 200, 500)
# sGS cadence (``solver_socp_sGSinPALM.m:431-456``), applied on it / scale
_CADENCE_GAPS_SGS = (5, 10, 20, 35, 50, 100)


def _cadence_check_sgs(it: int, last: int, scale: float) -> bool:
    """IfAdjustSigma of the sGS variants with the n^(1/3)/33 slowdown, in
    float32 as the JAX ``_cadence_check_sgs`` (host integers in)."""
    sc = _f32(scale)
    it_s = _f32(it) / sc
    passed = _f32(it - last) / sc
    idx = sum(bool(it_s >= _f32(e)) for e in _CADENCE_EDGES)
    return bool(passed >= _f32(_CADENCE_GAPS_SGS[idx]))


class SgsDeviceDriver(DeviceDriver):
    """sGS-inPALM on the device loop."""

    name = "Symmetric Gauss-Seidel based inPALM (device loop)"
    HIST = 19
    VICTORY = 12
    INITIAL_SIGMA_SCALE = 1.10
    VAL_GAP = 0.95
    RULE = UPDATE_RULE_SGS

    def __init__(self, kernels, opts: SolveOptions, chunk_iters: int = 600,
                 **kw):
        self._scale = max(1.0,
                          kernels.cfg.geom.n_centered ** (1.0 / 3.0) / 33.0)
        super().__init__(kernels, opts, chunk_iters=chunk_iters, **kw)
        self._offs = torch.arange(self.HIST + 1, dtype=torch.int32,
                                  device=self.device)

    BUFFERS = DeviceDriver.BUFFERS + ("ring", "superior", "stable", "stale",
                                      "resi_sgs")

    def _init_loop(self) -> None:
        super()._init_loop()
        f32 = torch.float32
        self.ring = torch.full((RING,), float("inf"), dtype=f32,
                               device=self.device)
        self.superior = self._scalar(False, torch.bool)
        self.stable = self._scalar(False, torch.bool)
        self.stale = torch.zeros(5, dtype=f32, device=self.device)
        self.resi_sgs = self._scalar(float("inf"), f32)

    def _all_tensors(self) -> list:
        return super()._all_tensors() + [self.ring, self.superior,
                                         self.stable, self.stale,
                                         self.resi_sgs]

    # -- the pieces that run as graphs ------------------------------------
    def _ring_set(self, it, value) -> None:
        at = torch.remainder(it, RING).reshape(1).long()
        self.ring.index_copy_(0, at, value.reshape(1).to(torch.float32))

    def _step(self) -> None:
        """The instrumented step: the iterate and the sGS block residual
        right after its sweep (``solver_socp_sGSinPALM.m:208-218``)."""
        new, resi = self.k._step_instrumented(self.s)
        self._store(new, ITERATE)
        self.resi_sgs.copy_(resi.to(torch.float32))
        self._tick()

    def _between(self, superior: bool, state) -> None:
        """Non-check FeasRatio bookkeeping on the stepped ``state``
        (``solver_socp_sGSinPALM.m:373-393``)."""
        it = self.ls.it
        if not superior:
            self._ring_set(it, _pick(self.ring,
                                     torch.remainder(it - 1, RING)))
            return
        feas = self.k._feas_pair(state).to(torch.float32)
        denom1, denom3, k1, k2, k5 = self.stale.unbind()
        rel = feas[0] / torch.clamp(denom1 * k1, min=1e-30)
        r3 = feas[1] / torch.clamp(denom3, min=1e-30)
        ratio = (torch.maximum(k1 * rel, k2 * rel)
                 / torch.clamp(torch.maximum(r3, k5), min=1e-30))
        self._ring_set(it, ratio)

    def _iteration(self, superior: bool) -> None:
        """A between-check iteration: the step and the FeasRatio entry."""
        self._step()
        self._between(superior, self.s)

    def _window(self):
        """Mean and win counts over iterations max(1, it-19)..it
        (``solver_socp_sGSinPALM.m:332-335``)."""
        its = self.ls.it - self._offs
        valid = its >= 1
        vals = self.ring.index_select(0, torch.remainder(its, RING).long())
        count = torch.clamp(valid.sum(), min=1)
        mean = torch.where(valid, vals, torch.zeros_like(vals)).sum() / count
        # MATLAB's mean over a window holding Inf is Inf
        has_inf = (valid & torch.isinf(vals)).any()
        mean = torch.where(has_inf, torch.full_like(mean, float("inf")), mean)
        prim = (valid & (vals < 1.0)).sum()
        dual = (valid & (vals > 1.0)).sum()
        return mean, prim, dual

    def _check_block(self) -> None:
        """The sGS check (the JAX ``SgsDeviceDriver.check_block``)."""
        ls = self.ls
        res = self._kkt()
        kkt_org, kkt5 = res["kkt_org"], res["kkt"]
        error, done, use_org = self._decide_common(res)
        fresh = (torch.maximum(kkt5[0], kkt5[1])
                 / torch.clamp(torch.maximum(kkt5[2], kkt5[4]), min=1e-30))
        self._ring_set(ls.it, fresh)

        s = self.s
        kc = 1.0
        denom1 = torch.where(use_org,
                             kc * s.D / s.dScale + res["normAphi"]
                             + res["normQ"],
                             kc + res["normAphi"] + res["normQ"])
        denom3 = torch.where(use_org, kc / s.cScale + s.norm_c,
                             kc + s.norm_c)
        self.stale.copy_(torch.stack([denom1, denom3, kkt5[0], kkt5[1],
                                      kkt5[4]]).to(torch.float32))
        superior = self.resi_sgs < self.VAL_GAP * res["kkt_sgs_blocks"]
        self.superior.copy_(superior)

        sc = self._scale
        it_s = ls.it.to(torch.float32) / sc
        passed = (ls.it - ls.last_sigma_it).to(torch.float32) / sc
        adjust = passed >= _step_lookup(it_s, _CADENCE_EDGES,
                                        _CADENCE_GAPS_SGS[1:],
                                        _CADENCE_GAPS_SGS[0])
        mean, prim_w, dual_w = self._window()
        dual_win = (dual_w >= self.VICTORY) & (mean > 1)
        adjust2 = superior | (error < 5.0 * ls.tol) | dual_win
        stable = self.stable | (adjust & adjust2 & (ls.it > 2500))
        self.stable.copy_(stable)
        win = ((prim_w >= self.VICTORY) & (mean < 1)) | dual_win

        sigma = s.sigma
        ones = torch.ones_like(sigma)
        warm = torch.where(mean < 1, ones * (1.0 / self.INITIAL_SIGMA_SCALE),
                           ones * self.INITIAL_SIGMA_SCALE)
        table = self._sigma_factor(sigma, _table_factor(mean, self.RULE))
        factor = torch.where(stable, table, warm)
        update = adjust & ~done & adjust2 & win
        ls.factor.copy_(torch.where(update, factor, ones))
        # lastSigmaIt moves at every cadence point
        ls.last_sigma_it.copy_(torch.where(adjust, ls.it, ls.last_sigma_it))
        self._finish_check(res, done, use_org, superior=superior)

    def _segment_pieces(self) -> dict:
        return {"sgs_superior": lambda: self._iteration(True),
                "sgs_carry": lambda: self._iteration(False),
                "sgs_step": self._step}

    # -- the host's loop ---------------------------------------------------
    def _top_rescale(self) -> None:
        """The top-of-iteration rescale of iteration it + 1 (the sGS
        ``rescale_trigger``: periodic on multiples of the period)."""
        h = self.h
        it1 = h.it + 1
        periodic = h.stage >= 3 and it1 % self.rescale_check_every == 0
        if it1 >= self._stage_due() or periodic:
            self._fire_rescale()

    def _segment(self, k: int) -> None:
        """k between-check iterations, each with the FeasRatio entry of the
        mode the last check set (superior or carried)."""
        sup = self.h.superior
        for _ in range(k):
            self.graphs.run("sgs_superior" if sup else "sgs_carry",
                            lambda: self._iteration(sup))
            self.h.it += 1

    def _chunk(self, it_end: int) -> None:
        h = self.h
        while not h.done and h.it < it_end:
            checked = False
            with span("driver.segment"):
                # the segment's rescales count in its seconds
                launch_s, t0 = self.stats["launch_s"], time.perf_counter()
                while h.it < it_end:
                    self._top_rescale()
                    it1 = h.it + 1
                    if (_cadence_check_sgs(it1, h.last, self._scale)
                            or it1 >= self.opts.maxit):
                        checked = True
                        break
                    self._segment(1)
                self.stats["launch_s"] = launch_s + time.perf_counter() - t0
            if checked:
                self._launch("sgs_step", self._step)
                h.it = it1
                self._check()
                self._post_check()


class AccSgsDeviceDriver(HalpernMixin, SgsDeviceDriver):
    """acc-sGS-ADMM on the device loop: the sGS sigma machinery on the base
    iterate, and the Halpern averaging after every iteration with anchor
    restarts on sigma changes and rescales (``solver_socp_accsGSADMM.m``).
    A between-check iteration averages its step at once against the
    iterate before it; a checked one keeps that iterate as ``old`` for the
    averaging after the check."""

    name = "Accelerated sGS based ADMM (device loop)"
    BUFFERS = SgsDeviceDriver.BUFFERS + ("anchor", "old", "kc")

    def __init__(self, kernels, opts: SolveOptions, chunk_iters: int = 600,
                 **kw):
        super().__init__(kernels, opts, chunk_iters=chunk_iters, **kw)
        self.rescale_check_every = 200

    def _step(self) -> None:
        self._keep_old()
        super()._step()

    def _iteration(self, superior: bool) -> None:
        stepped, resi = self.k._step_instrumented(self.s)
        self.resi_sgs.copy_(resi.to(torch.float32))
        self._tick()
        self._between(superior, stepped)
        self._halpern(self._iterate(),
                      tuple(getattr(stepped, f) for f in ITERATE), False)
