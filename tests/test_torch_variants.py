"""The algorithm variants of the PyTorch port (PALM, acc-ADMM, sGS-inPALM,
acc-sGS-ADMM: ``algorithms/variants.py``, ``solvers.py``) and the host
driver's sGS tables, against the JAX package on the CPU in float64.

- Driver tables (the sGS cadence, ``next_check_iter`` with its scale, the
  sGS sigma table, the cadence test): equal values over a grid.
- Single steps: both packages start from one state (the JAX state after
  four iterations, converted with ``utils/interop.py``; the JAX sGS kernels
  run on its shaped layout, the port's on the flat one) and take one step
  of each variant, one Halpern averaging and one restart of acc-ADMM, one
  sigma change and one rescale: rtol 1e-12, with an absolute floor of
  1e-12 times the largest magnitude (the reductions sum in another order).
- ``solve_dot`` with PALM and acc-ADMM against the JAX host driver: the same
  iteration count on every level and check schedule; KKT histories within
  rtol 1e-7 / atol 1e-12 (residual 5 is rounding noise near 1e-16).
- (slow) the golden acc-ADMM fixture replayed on the port.
"""
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms import driver as jdriver
from dotsocp_tpu.algorithms import variants as jvariants
from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.multilevel import level as jlevel

from dotsocp_tpu_torch.algorithms import driver as tdriver
from dotsocp_tpu_torch.algorithms import variants as tvariants
from dotsocp_tpu_torch.algorithms.core import LevelConfig
from dotsocp_tpu_torch.models import examples as texamples
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.utils.interop import (acc_state_from_numpy,
                                             level_var_from_numpy,
                                             state_from_numpy)

from .test_torch_sgs import _solve_pair, assert_same_run, close

torch.set_num_threads(2)

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ITERATE = ("phi", "z", "q", "alpha", "beta")
SCALARS = ("sigma", "cScale", "dScale", "norm_c", "norm_d", "sigmaScale")

# name: (JAX kernels class, port kernels class, tau, acc state)
VARIANTS = {
    "PALM": (jvariants.PALMKernels, tvariants.PALMKernels, 1.9, False),
    "acc-ADMM": (jvariants.AccADMMKernels, tvariants.AccADMMKernels, 1.0,
                 True),
    "sGS-inPALM": (jvariants.SgsKernels, tvariants.SgsKernels, 1.9, False),
    "acc-sGS-ADMM": (jvariants.AccSgsADMMKernels,
                     tvariants.AccSgsADMMKernels, 1.0, True),
}


# -- driver tables ---------------------------------------------------------------

def test_sgs_driver_tables_match():
    assert tdriver.UPDATE_RULE_SGS == jdriver.UPDATE_RULE_SGS
    for it in np.linspace(0.0, 700.0, 141):
        assert (tdriver._cadence_threshold_sgs(it)
                == jdriver._cadence_threshold_sgs(it))
    for scale in (None, 1.0, 1.37, 2.9):
        fake = types.SimpleNamespace(sgs_scale=lambda s=scale: s)
        for it in range(0, 3000, 11):
            for last in (-math.inf, 0, it - 7, it - 60):
                assert (tdriver.next_check_iter(it, last, scale)
                        == jdriver.next_check_iter(it, last, scale))
                assert (tdriver.is_cadence_point(it, last, scale)
                        == jdriver.SegmentSolver._is_cadence_point(
                            fake, it, last))
    for xi in np.geomspace(1e-3, 1e3, 97):
        assert (tdriver.get_factor(xi, tdriver.UPDATE_RULE_SGS)
                == jdriver.get_factor(xi, jdriver.UPDATE_RULE_SGS))
        for sigma in (1e-3, 0.1, 999.0):
            assert (tdriver.adjust_sigma(sigma, xi, tdriver.UPDATE_RULE_SGS)
                    == jdriver.adjust_sigma(sigma, xi,
                                            jdriver.UPDATE_RULE_SGS))


# -- single steps from one state ------------------------------------------------

class Pair:
    """One variant's kernels in both packages, and the state after four
    iterations of the JAX kernels, converted to the port."""

    def __init__(self, name, n=17, nt=7, restart=100):
        jcls, tcls, tau, self.acc = VARIANTS[name]
        r0, r1 = jexamples.get_example_2d("example2", n, n)
        lv = jlevel.initialize(r0, r1, nt, dtype=jnp.float64)
        jlevel.initial_scaling(lv, scaling=True)
        jcfg = JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=tau,
                            dtype=jnp.float64, layout="flat")
        tcfg = LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space), D=lv.D,
                           E=lv.E, tau=tau, dtype=F64, device="cpu")
        kw = {"restart": restart} if self.acc else {}
        self.jk = jcls(jcfg, **kw)
        self.tk = tcls(tcfg, **kw)
        self.lv = lv
        self.js = self.jk.run_segment(self.jk.prep(lv.as_dict(), sigma=0.8),
                                      4)
        self.ts = self.port(self.js)

    def port(self, js):
        fields = jax.device_get(js)._asdict()
        if self.acc:
            return acc_state_from_numpy(fields, device="cpu", dtype=F64)
        return state_from_numpy(fields, device="cpu", dtype=F64)


def assert_state_close(got, want):
    """Port SolverState against a port-converted JAX SolverState."""
    for name in ("phi", "z", "beta", "c"):
        close(getattr(got, name), getattr(want, name))
    for name in ("q", "alpha"):
        for a, b in zip(getattr(got, name).blocks(),
                        getattr(want, name).blocks()):
            close(a, b)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-14, err_msg=name)


def assert_iterate_close(got, want):
    for name, a, b in zip(ITERATE, got, want):
        if name in ("q", "alpha"):
            for x, y in zip(a.blocks(), b.blocks()):
                close(x, y)
        else:
            close(a, b)


def assert_acc_close(got, want):
    assert_state_close(got.s, want.s)
    assert_iterate_close(got.old, want.old)
    assert_iterate_close(got.anchor, want.anchor)
    assert got.k == want.k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prep_matches(name):
    """PALM builds its own initial z, the sGS methods de-mean phi."""
    p = Pair(name)
    tv = level_var_from_numpy(jax.device_get(p.lv.as_dict()), p.lv.rho0,
                              p.lv.rho1, device="cpu", dtype=F64)
    want = p.port(p.jk.prep(p.lv.as_dict(), sigma=0.8))
    got = p.tk.prep(tv.as_dict(), 0.8)
    if p.acc:
        assert_acc_close(got, want)
    else:
        assert_state_close(got, want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_one_step_matches(name):
    p = Pair(name)
    if p.acc:
        want = p.port(p.js._replace(s=jax.jit(p.jk._step)(p.js.s)))
        assert_state_close(p.tk._step(p.ts.s), want.s)
    else:
        want = p.port(jax.jit(p.jk._step)(p.js))
        assert_state_close(p.tk._step(p.ts), want)


@pytest.mark.parametrize("name", ["acc-ADMM", "acc-sGS-ADMM"])
@pytest.mark.parametrize("restart", [100, 4])
def test_halpern_and_restart_match(name, restart):
    """One averaging at k = 3; with restart = 4 it restarts the anchor."""
    p = Pair(name, restart=restart)
    assert p.ts.k == 3
    want = p.port(jax.jit(p.jk._halpern)(p.js))
    got = p.tk._halpern(p.ts)
    assert_acc_close(got, want)
    assert got.k == (0 if restart == 4 else 4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sigma_mult_and_rescale_match(name):
    """Each variant rescales its own blocks; acc restarts its anchors."""
    p = Pair(name)
    want = p.port(p.jk.rescale(p.jk.sigma_mult(p.js, 1.26), 1.7, 0.6))
    got = p.tk.rescale(p.tk.sigma_mult(p.ts, 1.26), 1.7, 0.6)
    if p.acc:
        assert_acc_close(got, want)
    else:
        assert_state_close(got, want)
    for k, v in jax.device_get(p.jk.norms(p.js)).items():
        np.testing.assert_allclose(p.tk.norms(p.ts)[k], v, rtol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_segment_aux_and_kkt_match(name):
    """A 3-iteration segment with the feasibility history on: the same
    state, the same sGS block residual, the first two (primFea1, dualFea1)
    pairs; and the KKT battery's sGS-block error."""
    p = Pair(name)
    want_kkt = jax.device_get(p.jk.kkt(p.js))
    got_kkt = p.tk.kkt(p.ts)
    close(got_kkt["kkt_sgs_blocks"], want_kkt["kkt_sgs_blocks"], rtol=1e-10)
    close(got_kkt["kkt_org"], want_kkt["kkt_org"], rtol=1e-10, atol=1e-14)
    p.jk.with_feas = True
    p.tk.with_feas = True
    # the JAX sGS-inPALM segment donates its input state
    want = p.port(p.jk.run_segment(p.js, 3))
    got = p.tk.run_segment(p.ts, 3)
    if p.acc:
        assert_acc_close(got, want)
    else:
        assert_state_close(got, want)
    jaux = jax.device_get(p.jk.last_aux)
    close(p.tk.last_aux["resi_sgs"], jaux["resi_sgs"])
    feas = p.tk.last_aux["feas_hist"]
    assert tuple(feas.shape) == (2, 2)
    close(feas[:, 0], jaux["feas_hist"]["primFea1"][:2])
    close(feas[:, 1], jaux["feas_hist"]["dualFea1"][:2])


# -- PALM and acc-ADMM end to end -----------------------------------------------

@pytest.mark.parametrize("method", ["PALM", "acc-ADMM"])
def test_solve_matches_jax(method):
    """example2 17^2 x 7, 2 levels, cut at 150 iterations a level."""
    assert_same_run(*_solve_pair(method, {"tol": 1e-3, "maxit": 150}))


def test_acc_admm_restart_option_matches_jax():
    """A short restart period: the anchor restarts inside segments."""
    assert_same_run(*_solve_pair("acc-ADMM", {"tol": 1e-3, "maxit": 120,
                                              "restart": 7, "rho": 1.8}))


@pytest.mark.slow
def test_golden_acc_admm():
    """``tests/golden/dot2d_example2_65x17_l2_accadmm.npz`` (the JAX host
    driver in float64: 1049 + 609 iterations) replayed on the port, with
    the tolerances of ``tests/test_golden.py``."""
    ref = np.load(os.path.join(GOLDEN, "dot2d_example2_65x17_l2_accadmm.npz"))
    r0, r1 = texamples.get_example_2d("example2", 65, 65)
    out, hml, _ = tsolve.solve_dot(r0, r1, 17, 2,
                                   {"tol": 1e-4, "driver": "host"},
                                   "acc-ADMM", device="cpu", dtype=F64,
                                   verbose=False)
    assert [lv["iters"] for lv in out["levels"]] == ref["level_iters"].tolist()
    assert hml["iter"].tolist() == ref["iter"].tolist()
    assert bool(out["mass_ok"]) == bool(ref["mass_ok"])
    np.testing.assert_allclose(hml["kkt"], ref["kkt"], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(hml["pdGap"], ref["pdGap"], rtol=1e-6,
                               atol=1e-10)
