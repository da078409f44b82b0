"""Concrete level solvers: one class per reference algorithm, binding a
``Kernels`` variant to the host driver and, for the sGS variants, the
win-count sigma strategy (``solver_socp_sGSinPALM.m:76-80,321-366``); port
of ``dotsocp_tpu/algorithms/solvers.py``."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .driver import SegmentSolver, SolveOptions, UPDATE_RULE_SGS, adjust_sigma


class InPALMSolver(SegmentSolver):
    name = "Inexact Proximal ALM"


class ALG2Solver(SegmentSolver):
    """inPALM with unit dual step (tau = 1): the reference's "ALG2"."""

    name = "ALG2"


class PALMSolver(SegmentSolver):
    name = "Proximal ALM"


class AccADMMSolver(SegmentSolver):
    """Halpern-accelerated ADMM; periodic rescale checks every 200 its
    (``solver_socp_accADMM.m:96``)."""

    name = "Accelerated ADMM"

    def __init__(self, kernels, opts: SolveOptions):
        super().__init__(kernels, opts)
        self.rescale_check_every = 200

    def post_check(self, state):
        return self.k.post_check(state)


class SgsSolverMixin:
    """sGS sigma machinery: 19-history primal-vs-dual win count with a
    12-victory threshold, gated by the sGS block-residual superiority test
    resi_sGS < 0.95 * kkt_sGS, with a slower cadence scaled by n^(1/3)/33."""

    sgs = True
    HIST = 19
    VICTORY = 12
    INITIAL_SIGMA_SCALE = 1.10
    VAL_GAP = 0.95

    def _init_sgs(self):
        self.feas_ratio: dict[int, float] = {}
        self.stable_phase = False
        self.superior = False
        self._stale = None
        self._scale = max(
            1.0, self.k.cfg.geom.n_centered ** (1.0 / 3.0) / 33.0
        )

    def sgs_scale(self) -> Optional[float]:
        return self._scale

    def _run_segment(self, state, steps):
        """Maintain the per-iteration FeasRatio history
        (``solver_socp_sGSinPALM.m:373-393``): between checks, entries are
        either cheap per-iteration updates (sGS-superior mode, computed on
        the device inside the segment and fetched in one transfer) or
        carried forward."""
        it0 = self._it
        with_feas = bool(self.superior and self._stale is not None
                         and steps > 1)
        self.k.with_feas = with_feas
        state = self.k.run_segment(state, steps)
        self._it += steps
        if with_feas:
            feas = self.k.last_aux["feas_hist"].cpu().numpy()
            st = self._stale
            for j in range(steps - 1):
                prim, dual = float(feas[j, 0]), float(feas[j, 1])
                rel_dec = prim / max(st["denom1"] * st["kkt1"], 1e-300)
                k1 = st["kkt1"] * rel_dec
                k2 = st["kkt2"] * rel_dec
                k3 = dual / st["denom3"]
                self.feas_ratio[it0 + 1 + j] = max(k1, k2) / max(
                    k3, st["kkt5"], 1e-300
                )
        else:
            carry = self.feas_ratio.get(it0, math.inf)
            for j in range(steps - 1):
                self.feas_ratio[it0 + 1 + j] = carry
        return state

    def _sigma_update(self, state, kkt_org, kkt5, use_feas_org, res):
        it = self._it
        tol = self.opts.tol
        self.feas_ratio[it] = float(max(kkt5[0], kkt5[1])) / max(
            float(max(kkt5[2], kkt5[4])), 1e-300
        )
        # stale denominators for between-check updates
        kkt_const = 1.0
        if use_feas_org:
            denom1 = (
                kkt_const * float(res["D"]) / float(res["dScale"])
                + float(res["normAphi"])
                + float(res["normQ"])
            )
            denom3 = (kkt_const / float(res["cScale"])
                      + float(res["norm_c_state"]))
        else:
            denom1 = kkt_const + float(res["normAphi"]) + float(res["normQ"])
            denom3 = kkt_const + float(res["norm_c_state"])
        self._stale = {
            "denom1": denom1,
            "denom3": denom3,
            "kkt1": float(kkt5[0]),
            "kkt2": float(kkt5[1]),
            "kkt5": float(kkt5[4]),
        }
        resi_sgs = float(self.k.last_aux["resi_sgs"])
        kkt_sgs = float(res["kkt_sgs_blocks"])
        self.superior = resi_sgs < self.VAL_GAP * kkt_sgs

        stop_idx = ([0, 2, 5, 6] if self.opts.check_prim_dual_feas
                    else [0, 2, 5])
        error = float(max(kkt_org[i] for i in stop_idx))

        window = [
            self.feas_ratio.get(j, math.inf)
            for j in range(max(1, it - self.HIST), it + 1)
        ]
        mean_ratio = float(np.mean(window))
        prim_wins = sum(1 for v in window if v < 1)
        dual_wins = sum(1 for v in window if v > 1)

        adjust2 = (
            self.superior
            or (error < 5.0 * tol)
            or (dual_wins >= self.VICTORY and mean_ratio > 1)
        )
        if adjust2:
            if it > 2500:
                self.stable_phase = True
            if (prim_wins >= self.VICTORY and mean_ratio < 1) or (
                dual_wins >= self.VICTORY and mean_ratio > 1
            ):
                sigma = self.k.get_sigma(state)
                if self.stable_phase:
                    _, factor = adjust_sigma(sigma, mean_ratio,
                                             UPDATE_RULE_SGS)
                else:
                    factor = (
                        1.0 / self.INITIAL_SIGMA_SCALE
                        if mean_ratio < 1
                        else self.INITIAL_SIGMA_SCALE
                    )
                if factor != 1.0:
                    state = self.on_sigma_change(state, factor)
        return state


class SgsInPALMSolver(SgsSolverMixin, SegmentSolver):
    """sGS-based inexact proximal ALM (``solver_socp_sGSinPALM.m``)."""

    name = "Symmetric Gauss-Seidel based inPALM"

    def __init__(self, kernels, opts: SolveOptions):
        super().__init__(kernels, opts)
        self._init_sgs()


class AccSgsADMMSolver(SgsSolverMixin, SegmentSolver):
    """Accelerated sGS-based ADMM (``solver_socp_accsGSADMM.m``)."""

    name = "Accelerated sGS based ADMM"

    def __init__(self, kernels, opts: SolveOptions):
        super().__init__(kernels, opts)
        self._init_sgs()
        self.rescale_check_every = 200

    def post_check(self, state):
        return self.k.post_check(state)
