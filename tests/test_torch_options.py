"""How the port's ``solve_dot`` takes the JAX package's options, and the
card's HBM peak by name, on the CPU.

The JAX package's compile and cache knobs (prewarm, reuse_solvers,
chunk_iters, max_chunks) are accepted and change nothing; ``use_pallas``,
``layout`` and ``driver`` take the values the port runs and refuse the
others with a message that says why; the refine, NaN-tripwire and trace
options raise, naming the ROADMAP.md queue where each waits. A solve with
every accepted option takes the JAX package's iteration counts with the same
options (both float64 on the CPU, the JAX host driver on the flat layout).
``utils.profiling.hbm_peak_for`` maps a card's full name to its HBM peak,
and knows no other card.
"""
import numpy as np
import pytest
import torch

from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot

from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.utils.profiling import hbm_peak_for

torch.set_num_threads(2)

N, NT, TOL = 9, 5, 1e-3
ACCEPTED = {"prewarm": True, "reuse_solvers": False, "chunk_iters": 100,
            "max_chunks": 4, "use_pallas": "auto", "layout": "flat",
            "driver": "host"}


def _solve(opts):
    r0, r1 = get_example_2d("example2", N, N)
    out, hist, _ = tsolve.solve_dot(r0, r1, NT, 1, dict(opts, tol=TOL),
                                    "inPALM", device="cpu",
                                    dtype=torch.float64, verbose=False)
    return out, hist


@pytest.fixture(scope="module")
def baseline():
    return _solve({})


@pytest.mark.parametrize("key,value", [
    ("prewarm", True), ("prewarm", False), ("reuse_solvers", False),
    ("chunk_iters", 100), ("max_chunks", 4), ("use_pallas", "auto"),
    ("use_pallas", True), ("layout", "auto"), ("layout", "flat"),
    ("driver", "auto"), ("driver", "host")])
def test_accepted_option_changes_nothing(baseline, key, value):
    out, hist = _solve({key: value})
    want, want_hist = baseline
    assert [lv["iters"] for lv in out["levels"]] == \
        [lv["iters"] for lv in want["levels"]]
    assert torch.equal(out["rho"], want["rho"])
    assert np.array_equal(hist["kkt"], want_hist["kkt"])


@pytest.mark.parametrize("key,value,error,match", [
    ("use_pallas", False, ValueError, "always run on the card"),
    ("layout", "shaped", ValueError, "TPU-only"),
    ("layout", "tiled", ValueError, "not one of"),
    ("driver", "device", NotImplementedError, "queue 1 item 3"),
    ("driver", "graph", ValueError, "not one of")])
def test_refused_option_says_why(key, value, error, match):
    with pytest.raises(error, match=match):
        _solve({key: value})


@pytest.mark.parametrize("key,item", [
    ("refine_tol", 1), ("refine_dtype", 1), ("refine_method", 1),
    ("refine_dct_split", 1), ("refine_sigma_scale", 1), ("refine_tau", 1),
    ("debug_nans", 5), ("trace_dir", 5), ("checkpoint_dir", 5), ("mesh", 7)])
def test_queued_option_names_its_queue(key, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1 item {item} "):
        _solve({key: 1})


def test_unknown_option_is_refused():
    with pytest.raises(ValueError, match="unknown option 'prewarm_all'"):
        _solve({"prewarm_all": True})


def test_accepted_options_match_jax():
    """Every accepted option at once (the JAX run without prewarm, which
    only compiles ahead): the JAX package's iteration counts, level by
    level, and its density to 1e-7."""
    out, _ = _solve(ACCEPTED)
    jopts = {k: v for k, v in ACCEPTED.items() if k != "prewarm"}
    r0, r1 = jget_example_2d("example2", N, N)
    jout, _, _ = jsolve_dot(r0, r1, NT, 1, dict(jopts, tol=TOL), "inPALM",
                            dtype=np.float64, verbose=False)
    assert [lv["iters"] for lv in out["levels"]] == \
        [int(lv["iters"]) for lv in jout["levels"]]
    np.testing.assert_allclose(out["rho"].numpy(), np.asarray(jout["rho"]),
                               rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100", None), ("NVIDIA H200", None)])
def test_hbm_peak_by_full_name(name, peak):
    assert hbm_peak_for(name) == peak
