"""The port's device driver (``algorithms/device_driver.py``,
``algorithms/device_sgs.py``) against the JAX package's, on the CPU in
float64, where the port runs its segments eagerly (no CUDA graphs).

Both drivers decide in the JAX device driver's types (float32 max_feas,
rel_gap, tol, sigma table, history rows), so the port takes the JAX
device driver's iteration counts and check iterations exactly; the KKT rows
agree to rtol 1e-6 (atol 1e-12 for the residuals near zero):

- ``example2`` 33^2 x 9, one level, tol 1e-4: inPALM, ALG2, PALM and
  acc-ADMM;
- the sGS drivers in ``tests/test_torch_device_sgs.py``;
- weighted inPALM on love-heart 17^2 x 9 and 3D gaussian 9^3 x 5 inPALM;
- the driver rule: the port's ``driver="auto"`` (and "device", "host")
  picks the driver the JAX package's picks, for each method, theta and
  ``ifCheckStepByStep``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models import wdot2d as JW
from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.models.examples import get_example_3d as jget_example_3d
from dotsocp_tpu.algorithms.driver import SolveOptions as JSolveOptions
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.multilevel import solve as jsolve

from dotsocp_tpu_torch.algorithms.driver import SolveOptions
from dotsocp_tpu_torch.models import wdot2d as TW
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.utils.interop import weight_from_numpy

torch.set_num_threads(2)

F64 = torch.float64
JAX_DEVICE = {"driver": "device", "layout": "flat", "use_pallas": False,
              "reuse_solvers": False}


def _pair(r0, r1, nt, opts, method, jkw=None, tkw=None):
    jout, _, jh = jsolve.solve_dot(r0, r1, nt, 1, dict(opts, **JAX_DEVICE),
                                   method, dtype=jnp.float64, verbose=False,
                                   **(jkw or {}))
    tout, _, th = tsolve.solve_dot(r0, r1, nt, 1,
                                   dict(opts, driver="device"), method,
                                   device="cpu", dtype=F64, verbose=False,
                                   **(tkw or {}))
    return jout, jh, tout, th


def _assert_same(jout, jh, tout, th, capped_at=None, atol=1e-12):
    """Equal iterations, check iterations and method; KKT rows close."""
    assert tout["levels"][0]["iters"] == int(jout["levels"][0]["iters"])
    assert tout["levels"][0]["method"] == jout["levels"][0]["method"]
    assert len(th["iter"]) == len(jh["iter"])
    if capped_at is not None:
        assert int(th["iter"][-1]) <= capped_at
    np.testing.assert_array_equal(th["iter"], np.asarray(jh["iter"]))
    np.testing.assert_allclose(th["kkt"], np.asarray(jh["kkt"]), rtol=1e-6,
                               atol=atol)


@pytest.mark.parametrize("method", ["inPALM", "ALG2", "PALM", "acc-ADMM"])
def test_device_driver_matches_jax(method):
    r0, r1 = jget_example_2d("example2", 33, 33)
    _assert_same(*_pair(r0, r1, 9, {"tol": 1e-4, "maxit": 3000}, method))


def test_weighted_device_driver_matches_jax():
    """love-heart 17^2 x 9, one level, inPALM, tol 1e-3 (the weighted
    q-step; stop on residuals 1, 3, 6). Residual 5 sits near 1e-11 here,
    where the 1e6 walls of the weight leave the last bits to the order of
    the sums: atol 1e-10, as ``tests/test_torch_weighted.py``."""
    n, nt = 17, 9
    jb, tb = JW.barrier_love_heart(), TW.barrier_love_heart()
    r0, r1 = JW.get_example_w2d("love-heart", n, n)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jw = JW.get_weight_by_barrier(n, n, nt, jb, dtype=jnp.float64)
    tw = weight_from_numpy(jax.device_get(jw), device="cpu", dtype=F64)
    _assert_same(*_pair(r0, r1, nt, {"tol": 1e-3}, "inPALM",
                        jkw=dict(weight=jw, barrier=jb),
                        tkw=dict(weight=tw, barrier=tb)), atol=1e-10)


def test_3d_device_driver_matches_jax():
    r0, r1 = jget_example_3d("gaussian", 9, 9, 9)
    _assert_same(*_pair(r0, r1, 5, {"tol": 1e-4}, "inPALM"))


METHODS = ("PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM",
           "acc-sGS-ADMM")


@pytest.fixture(scope="module")
def levels():
    r0, r1 = jget_example_2d("example2", 9, 9)
    jl = jlevel.initialize(r0, r1, 5, dtype=jnp.float64)
    jlevel.initial_scaling(jl, True)
    tl = tlevel.initialize(r0, r1, 5, dtype=F64, device="cpu")
    tlevel.initial_scaling(tl, True)
    return jl, tl


@pytest.mark.parametrize("driver", ["auto", "device", "host"])
@pytest.mark.parametrize("method", METHODS)
def test_driver_rule_matches_jax(levels, method, driver):
    jl, tl = levels
    for theta in (2.0, 3.0):
        for sbs in (False, True):
            jo = JSolveOptions(check_step_by_step=sbs, theta=theta)
            js = jsolve._make_solver(method, jl, jo, jnp.float64,
                                     driver=driver)
            to = SolveOptions(check_step_by_step=sbs)
            ts = tsolve._make_solver(method, tl, to, "cpu", F64, theta,
                                     driver=driver)
            want = "DeviceDriver" in type(js).__name__
            assert ("DeviceDriver" in type(ts).__name__) == want, (theta,
                                                                   sbs)
            assert tsolve.uses_device_driver(method, driver, to,
                                             theta) == want
