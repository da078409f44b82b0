"""The port's sGS device drivers (``algorithms/device_sgs.py``) against the
JAX package's, on the CPU in float64 (the port's segments eager):
sGS-inPALM and acc-sGS-ADMM on ``example2`` 33^2 x 9, one level, tol
1e-4, capped at maxit 1200 (which still crosses the win-count sigma
machinery, the scaled cadence and several rescales), as
``tests/test_device_driver.py`` holds the JAX pair; the full runs are
``slow``. Equal iterations and check iterations, KKT rows within rtol 1e-6
(atol 1e-12), as in ``tests/test_torch_device_driver.py``.
"""
import pytest
import torch

from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d

from .test_torch_device_driver import _assert_same, _pair

torch.set_num_threads(2)


def _sgs(method, maxit):
    r0, r1 = jget_example_2d("example2", 33, 33)
    _assert_same(*_pair(r0, r1, 9, {"tol": 1e-4, "maxit": maxit}, method),
                 capped_at=maxit)


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_device_driver_matches_jax_capped(method):
    _sgs(method, 1200)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_device_driver_matches_jax(method):
    _sgs(method, 6000)
