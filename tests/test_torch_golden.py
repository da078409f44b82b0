"""The port held to the committed golden trajectories of ``tests/golden/``
(the JAX host driver in float64, ``tests/golden/generate.py``), on both of
its single-process layouts, "flat" and "3d".

Each fixture whose densities the port generates itself is replayed with
the port's host driver in float64 on the CPU, with the exactness of
``tests/test_golden.py:52-68``: the per-level iteration counts and the
check schedule exactly, the KKT rows and pdGap within rtol 1e-6 / atol
1e-10, and the mass check. The heavy ones carry the ``slow`` marks of
``tests/test_golden.py:33-46``.

``dot2d_dotmark_65x17_l2_inpalm`` is left out: its fixture was made from
the JAX package's procedural DOTmark stand-in (``DOTSOCP_RESOURCES=
procedural``), and the port carries the committed DOTmark images instead
(``dotsocp_tpu_torch/resources``), so the densities differ.
"""
import os

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.models.examples import get_example_1d, get_example_2d
from dotsocp_tpu_torch.multilevel.solve import solve_dot

torch.set_num_threads(2)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden")
# name: (family, problem, space_n, nt, levels, tol, method), as
# tests/golden/generate.py's CONFIGS
CONFIGS = {
    "dot1d_gaussian_129x9_l2_inpalm": ("1d", "gaussian", 129, 9, 2, 1e-5,
                                       "inPALM"),
    "dot2d_example1_65x17_l2_inpalm": ("2d", "example1", 65, 17, 2, 1e-4,
                                       "inPALM"),
    "dot2d_example2_65x17_l2_accadmm": ("2d", "example2", 65, 17, 2, 1e-4,
                                        "acc-ADMM"),
    "dot2d_example2_65x17_l2_sgsinpalm": ("2d", "example2", 65, 17, 2, 1e-4,
                                          "sGS-inPALM"),
    "wdot2d_loveheart_65x17_l2_inpalm": ("w2d", "love-heart", 65, 17, 2,
                                         1e-3, "inPALM"),
}
# tests/test_golden.py's heavyweights
SLOW = {"dot2d_example2_65x17_l2_sgsinpalm",
        "dot2d_example2_65x17_l2_accadmm",
        "wdot2d_loveheart_65x17_l2_inpalm"}


def run_config(name: str, layout: str) -> dict:
    family, problem, n, nt, levels, tol, method = CONFIGS[name]
    kw = {}
    if family == "1d":
        r0, r1 = get_example_1d(problem, n)
    elif family == "2d":
        r0, r1 = get_example_2d(problem, n, n)
    else:
        r0, r1 = wdot2d.get_example_w2d(problem, n, n)
        barrier = wdot2d.barrier_love_heart()
        r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
        kw = {"weight": wdot2d.get_weight_by_barrier(n, n, nt, barrier,
                                                     dtype=torch.float64),
              "barrier": barrier}
    out, hml, _ = solve_dot(r0, r1, nt, levels,
                            {"tol": tol, "driver": "host", "layout": layout},
                            method, device="cpu", dtype=torch.float64,
                            verbose=False, **kw)
    return {"kkt": hml["kkt"], "iter": hml["iter"], "pdGap": hml["pdGap"],
            "level_iters": [lv["iters"] for lv in out["levels"]],
            "mass_ok": bool(out["mass_ok"])}


@pytest.mark.parametrize("layout", ["flat", "3d"])
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n in CONFIGS])
def test_golden_trajectory(name, layout):
    ref = np.load(os.path.join(FIXTURE_DIR, name + ".npz"))
    got = run_config(name, layout)
    assert got["level_iters"] == ref["level_iters"].tolist(), \
        "per-level iteration counts drifted"
    assert np.asarray(got["iter"]).tolist() == ref["iter"].tolist(), \
        "KKT-check schedule drifted"
    assert got["mass_ok"] == bool(ref["mass_ok"])
    np.testing.assert_allclose(got["kkt"], ref["kkt"], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(got["pdGap"], ref["pdGap"], rtol=1e-6,
                               atol=1e-10)
