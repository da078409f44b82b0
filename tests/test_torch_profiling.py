"""The PyTorch port's per-phase profile (``utils/profiling.py``,
``solve_dot(..., opts={"profile": True})``) on the CPU.

The phases are those ``tests/test_profiling.py`` asserts for the JAX
package, for all six methods, the weighted family and acc-ADMM's Nesterov
branch (theta = 3), on every level; each row has a finite, non-negative
time (host clock on the CPU) and, where its bytes are counted, GB/s, but no
roofline share: the port holds the H100's HBM bandwidth only. The phase
names of the JAX package's own profile of the same solve are the port's.
A phase that fails raises out of ``solve_dot``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot

from dotsocp_tpu_torch.algorithms.core import Kernels
from dotsocp_tpu_torch.models import wdot2d as W
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.solve import solve_dot
from dotsocp_tpu_torch.utils.profiling import format_table

torch.set_num_threads(2)

ALGS = ["inPALM", "ALG2", "PALM", "acc-ADMM", "sGS-inPALM", "acc-sGS-ADMM"]
OPTS = {"tol": 1e-2, "maxit": 30, "profile": True}


def assert_phases(phases, sgs, acc):
    assert ("phi_sgs_sweep" if sgs else "phi_dct_solve") in phases
    for key in ("cone_projection", "q_step", "multiplier", "kkt_battery",
                "full_step_fused"):
        assert key in phases
    assert ("halpern_averaging" in phases) == acc
    for name, row in phases.items():
        assert np.isfinite(row["ms"]) and row["ms"] >= 0.0, (name, row)
        assert "pct_roofline" not in row
        if name not in ("kkt_battery", "full_step_fused"):
            assert np.isfinite(row["gbps"]) and row["gbps"] > 0.0
    assert len(format_table(phases).splitlines()) == len(phases) + 1


@pytest.mark.parametrize("method", ALGS)
def test_profile_phases_all_algorithms(method):
    rho0, rho1 = get_example_2d("example2", 17, 17)
    out, _, _ = solve_dot(rho0, rho1, 5, 1, dict(OPTS), method,
                          device="cpu", verbose=False)
    assert_phases(out["levels"][-1]["phases"], "sGS" in method,
                  method.startswith("acc"))


def test_profile_every_level_and_the_jax_phase_names():
    """Two levels of sGS-inPALM: level 1 runs inPALM (the DCT solve),
    level 2 the sweep; the JAX package's profile names the same phases."""
    rho0, rho1 = get_example_2d("example2", 17, 17)
    out, _, _ = solve_dot(rho0, rho1, 9, 2, dict(OPTS), "sGS-inPALM",
                          device="cpu", verbose=False)
    assert [("phi_sgs_sweep" in lv["phases"]) for lv in out["levels"]] \
        == [False, True]
    for lv in out["levels"]:
        assert_phases(lv["phases"], "phi_sgs_sweep" in lv["phases"], False)
    j0, j1 = jget_example_2d("example2", 17, 17)
    jout, _, _ = jsolve_dot(j0, j1, 9, 2, dict(OPTS, driver="host"),
                            "sGS-inPALM", dtype=jnp.float32, verbose=False)
    for lv, jlv in zip(out["levels"], jout["levels"]):
        assert set(lv["phases"]) == set(jlv["phases"])


def test_profile_weighted():
    n, nt = 17, 5
    rho0, rho1 = W.get_example_w2d("example1", n, n)
    barrier = W.barrier_circle_pillar()
    weight = W.get_weight_by_barrier(n, n, nt, barrier)
    rho0, rho1, _ = W.ensure_barrier_validity(rho0, rho1, barrier)
    for method in ("inPALM", "acc-ADMM"):
        out, _, _ = solve_dot(rho0, rho1, nt, 1, dict(OPTS), method, weight,
                              barrier, device="cpu", verbose=False)
        assert_phases(out["levels"][-1]["phases"], False,
                      method == "acc-ADMM")


def test_profile_nesterov():
    """acc-ADMM with theta = 3: its averaging phase is the extrapolation."""
    rho0, rho1 = get_example_2d("example2", 17, 17)
    out, _, _ = solve_dot(rho0, rho1, 5, 1, dict(OPTS, theta=3.0),
                          "acc-ADMM", device="cpu", verbose=False)
    assert_phases(out["levels"][-1]["phases"], False, True)


def test_profile_failure_raises(monkeypatch):
    """inPALM's solve runs the CA segment, never ``_step``; the profile's
    full-step phase does, and its failure reaches the caller."""
    def broken(self, s):
        raise RuntimeError("full step failed")

    monkeypatch.setattr(Kernels, "_step", broken)
    rho0, rho1 = get_example_2d("example2", 9, 9)
    out, _, _ = solve_dot(rho0, rho1, 5, 1, {"tol": 1e-2, "maxit": 10},
                          "inPALM", device="cpu", verbose=False)
    assert "phases" not in out["levels"][-1]
    with pytest.raises(RuntimeError, match="full step failed"):
        solve_dot(rho0, rho1, 5, 1, {"tol": 1e-2, "maxit": 10,
                                     "profile": True},
                  "inPALM", device="cpu", verbose=False)
