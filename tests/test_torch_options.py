"""How the port's ``solve_dot`` takes the JAX package's options, and the
card's HBM peak by name, on the CPU.

The JAX package's cache knobs (prewarm, reuse_solvers) are taken and
change no result (what they keep is ``tests/test_torch_cache.py``'s);
``use_pallas``, ``layout`` and ``driver`` take the values the port runs and
refuse the others with a message that says why; the device driver's
``chunk_iters``, ``max_chunks`` and ``checkpoint_dir`` change nothing in a
run that ends inside one chunk;
``layout="halo"`` without a mesh warns and runs the flat solve, as the JAX
package does, and so does ``layout="3d"`` (bit-equal to the flat solve,
``use_pallas=True`` beside it too), which is refused under a mesh, naming
GSPMD and the halo engine (no option waits in a ROADMAP.md queue any
more: ``mesh`` runs, in ``tests/test_torch_parallel.py``, and takes only a
port mesh). The solves
here hold the host driver, unless a case asks for the device driver (as
"auto" does). The refine options,
the NaN tripwire (``debug_nans``) and the profiler trace (``trace_dir``)
are taken, each changing what it should; the trace is written even when
the solve raises. A solve with every accepted option takes the JAX
package's iteration counts with the same options (both float64 on the CPU,
the JAX host driver on the flat layout), and ``w2_distance`` the JAX
function's value. ``utils.profiling.hbm_peak_for`` maps a card's full name
to its HBM peak, and knows no other card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu import w2_distance as jw2_distance
from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot

from dotsocp_tpu_torch import w2_distance
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.algorithms.driver import SolveOptions
from dotsocp_tpu_torch.algorithms.solvers import InPALMSolver
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.utils.profiling import hbm_peak_for

torch.set_num_threads(2)

N, NT, TOL = 9, 5, 1e-3
# the JAX host driver on the flat layout without Pallas
ACCEPTED_JAX = {"driver": "host", "layout": "flat", "use_pallas": False,
                "reuse_solvers": False}
ACCEPTED = {"prewarm": True, "reuse_solvers": False, "chunk_iters": 100,
            "max_chunks": 4, "use_pallas": "auto", "layout": "flat",
            "driver": "host"}


def _solve(opts):
    r0, r1 = get_example_2d("example2", N, N)
    out, hist, _ = tsolve.solve_dot(r0, r1, NT, 1,
                                    dict({"driver": "host"}, **opts,
                                         tol=TOL),
                                    "inPALM", device="cpu",
                                    dtype=torch.float64, verbose=False)
    return out, hist


@pytest.fixture(scope="module")
def baseline():
    return {"host": _solve({}), "device": _solve({"driver": "device"})}


# the device driver's options, each run under it
DEVICE_OPTS = ("chunk_iters", "max_chunks", "checkpoint_dir")


@pytest.mark.parametrize("key,value", [
    ("prewarm", True), ("prewarm", False), ("reuse_solvers", False),
    ("chunk_iters", 100), ("chunk_iters", 7), ("max_chunks", 4),
    ("checkpoint_dir", "ck"), ("use_pallas", "auto"), ("use_pallas", True),
    ("layout", "auto"), ("layout", "flat"), ("layout", "3d"),
    ("driver", "auto"), ("driver", "host"), ("driver", "device")])
def test_accepted_option_changes_nothing(baseline, key, value, tmp_path):
    """Against the run of its driver without the option ("auto" is the
    device driver here); the 79 iterations end inside one chunk of 100,
    and a chunk of 7 splits segments where the check cadence does not.
    The "3d" layout warns and runs the flat engine, bit-equal."""
    if key == "checkpoint_dir":
        value = str(tmp_path / value)
    opts = {key: value}
    if key in DEVICE_OPTS:
        opts["driver"] = "device"
    if value == "3d":
        with pytest.warns(UserWarning, match="layout='3d'.*'flat' layout"):
            out, hist = _solve(opts)
    else:
        out, hist = _solve(opts)
    want, want_hist = baseline[
        "host" if opts.get("driver", "host") == "host" else "device"]
    assert [lv["iters"] for lv in out["levels"]] == \
        [lv["iters"] for lv in want["levels"]]
    assert torch.equal(out["rho"], want["rho"])
    assert np.array_equal(hist["kkt"], want_hist["kkt"])


@pytest.mark.parametrize("key,value,error,match", [
    ("use_pallas", False, ValueError, "always run on the card"),
    ("layout", "shaped", ValueError, "TPU-only"),
    ("layout", "tiled", ValueError, "not one of"),
    ("mesh", 1, TypeError, "not a dotsocp_tpu_torch mesh"),
    ("chunk_iters", 0, ValueError, "chunk_iters=0"),
    ("driver", "graph", ValueError, "not one of")])
def test_refused_option_says_why(key, value, error, match):
    with pytest.raises(error, match=match):
        _solve(dict({"driver": "device"}, **{key: value}))


def test_use_pallas_true_under_a_mesh_is_refused():
    """Under a mesh the kernels that read neighbouring cells run plain, so
    an explicit use_pallas=True is refused, not ignored."""
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=("y", "x"), device="cpu")
    with pytest.raises(NotImplementedError, match="use_pallas=True under a "
                                                  "mesh.*'auto'"):
        _solve({"driver": "device", "mesh": mesh, "use_pallas": True})


def test_halo_without_a_mesh_warns_and_runs_flat(baseline):
    """The JAX package's rule (``multilevel/solve.py:170-178``): 'halo'
    needs a mesh; without one it warns and runs the flat layout."""
    with pytest.warns(UserWarning, match="requires a mesh"):
        out, hist = _solve({"layout": "halo"})
    want, want_hist = baseline["host"]
    assert [lv["iters"] for lv in out["levels"]] == \
        [lv["iters"] for lv in want["levels"]]
    assert torch.equal(out["rho"], want["rho"])
    assert np.array_equal(hist["kkt"], want_hist["kkt"])


@pytest.mark.parametrize("key,item", [("layout", "3d")])
def test_queued_option_names_its_queue(key, item):
    """No option waits in a ROADMAP.md queue now (the mesh runs, and '3d'
    runs flat on one process); what has no counterpart is '3d' under a
    mesh, where the JAX package lets GSPMD partition its shaped engine: it
    is refused by its name, saying what the port runs there."""
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=("y", "x"), device="cpu")
    with pytest.raises(ValueError, match=f"layout='{item}'.*GSPMD.*halo"):
        _solve({key: item, "mesh": mesh})


@pytest.mark.parametrize("method,levels", [
    ("inPALM", 1), ("ALG2", 1), ("sGS-inPALM", 1), ("acc-sGS-ADMM", 2),
    ("acc-sGS-ADMM", 1), ("acc-ADMM", 1), ("PALM", 1)])
def test_use_pallas_true_with_3d(method, levels):
    """use_pallas=True with "3d": the solve warns and runs the flat engine,
    where every kernel the method has runs, so True is kept: bit-equal to
    the flat solve with the same options (an sGS method's levels before
    the last run inPALM)."""
    r0, r1 = get_example_2d("example2", N, N)
    opts = {"use_pallas": True, "maxit": 5}
    kw = dict(device="cpu", dtype=torch.float64, verbose=False)
    with pytest.warns(UserWarning, match="layout='3d'.*'flat' layout"):
        out, _, _ = tsolve.solve_dot(r0, r1, NT, levels,
                                     dict(opts, layout="3d"), method, **kw)
    want, _, _ = tsolve.solve_dot(r0, r1, NT, levels,
                                  dict(opts, layout="flat"), method, **kw)
    assert out["levels"][-1]["iters"] == 5
    assert [lv["iters"] for lv in out["levels"]] == \
        [lv["iters"] for lv in want["levels"]]
    assert torch.equal(out["rho"], want["rho"])


REFINE = {"refine_tol": 1e-4}


@pytest.fixture(scope="module")
def refined():
    return _solve(REFINE)


def _tail_kkt(out, hist):
    """The KKT rows of the refine tail (after the level's checks)."""
    n_level = np.searchsorted(hist["iter"], out["levels"][0]["iters"],
                              side="right")
    return hist["kkt"][n_level:]


@pytest.mark.parametrize("key", [
    "refine_tol", "refine_dtype", "refine_method", "refine_dct_split",
    "refine_sigma_scale", "refine_tau", "debug_nans", "trace_dir"])
def test_option_is_taken(refined, key, tmp_path):
    """Each option the port used to refuse as queued is now taken: it
    changes what it should, and nothing else."""
    r_out, r_hist = refined
    if key == "refine_tol":
        out, hist = _solve({key: 1e-6})
        assert out["levels"][-1]["refine"] is True
        assert max(hist["kkt"][-1][[0, 2, 5, 6]]) < 1e-6
    elif key == "refine_dtype":
        # a JAX user's dtype (the default's), and a name
        out, hist = _solve(dict(REFINE, refine_dtype=jnp.float64))
        assert np.array_equal(hist["kkt"], r_hist["kkt"])
        out, hist = _solve(dict(REFINE, refine_dtype="float32"))
        assert not np.array_equal(_tail_kkt(out, hist),
                                  _tail_kkt(r_out, r_hist))
        with pytest.raises(ValueError, match="not float64 or float32"):
            _solve(dict(REFINE, refine_dtype="float16"))
    elif key == "refine_method":
        out, hist = _solve(dict(REFINE, refine_method="ALG2"))
        assert out["levels"][-1]["method"] == "ALG2 (f64 refine)"
    elif key == "refine_dct_split":
        out, hist = _solve(dict(REFINE, refine_dct_split="ir1"))
        assert out["levels"][-1]["method"].endswith("(f64 refine, IR-DCT)")
    elif key in ("refine_sigma_scale", "refine_tau"):
        value = 10.0 if key == "refine_sigma_scale" else 1.0
        out, hist = _solve(dict(REFINE, **{key: value}))
        assert out["levels"][0]["iters"] == r_out["levels"][0]["iters"]
        assert not np.array_equal(_tail_kkt(out, hist),
                                  _tail_kkt(r_out, r_hist))
    elif key == "debug_nans":
        out, hist = _solve(dict(REFINE, debug_nans=True))
        assert np.array_equal(hist["kkt"], r_hist["kkt"])
        r0, r1 = get_example_2d("example2", N, N)
        r0[4, 4] = np.nan
        with pytest.raises(FloatingPointError, match="level 1: KKT residual"):
            tsolve.solve_dot(r0, r1, NT, 1, {"debug_nans": True}, "inPALM",
                             device="cpu", dtype=torch.float64,
                             verbose=False)
    else:
        out, hist = _solve(dict(REFINE, trace_dir=str(tmp_path)))
        assert np.array_equal(hist["kkt"], r_hist["kkt"])
        assert len(list(tmp_path.glob("solve_dot_*.pt.trace.json"))) == 1


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


def test_nan_tripwire_names_level_iteration_and_residual():
    """A state seeded with a NaN: with ``debug_nans`` the first KKT check
    raises; without, the solve runs to maxit as before."""
    r0, r1 = get_example_2d("example2", N, N)
    lv = tlevel.initialize(r0, r1, NT, dtype=torch.float64, device="cpu")
    tlevel.initial_scaling(lv, True)
    lv.q.q0[2, 3, 3] = float("nan")
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu",
                               dtype=torch.float64))
    with pytest.raises(FloatingPointError,
                       match=r"^level 2: KKT residual \d is nan at "
                             r"iteration 1$"):
        InPALMSolver(kern, SolveOptions(maxit=20, debug_nans=True,
                                        label="level 2")).solve(lv.as_dict())
    _, out = InPALMSolver(kern, SolveOptions(maxit=20)).solve(lv.as_dict())
    assert out["iters"] == 20


def test_trace_written_when_the_solve_raises(tmp_path):
    with pytest.raises(ValueError, match="refine_method"):
        _solve({"trace_dir": str(tmp_path / "t"), "refine_tol": 1e-4,
                "refine_method": "nonsense"})
    traces = list((tmp_path / "t").glob("solve_dot_*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_w2_distance_matches_jax():
    """example2 17^2, nt 9, 2 levels, both in float64 on the CPU (the JAX
    host driver on the flat layout)."""
    r0, r1 = get_example_2d("example2", 17, 17)
    want = jw2_distance(r0, r1, 9, 2, dict(ACCEPTED_JAX), dtype=jnp.float64)
    got, out = w2_distance(r0, r1, 9, 2, {"driver": "host"},
                           dtype=torch.float64, return_solution=True,
                           device="cpu")
    assert got == pytest.approx(want, rel=1e-9)
    assert out["mass_ok"] and out["rho"].dtype == torch.float64


@pytest.mark.parametrize("rho0,match", [
    (np.zeros((9, 9)), "rho0 has mean 0.0"),
    (np.full((9, 9), np.nan), "rho0 has mean nan"),
    (np.ones((5, 5, 5)), "1-D or 2-D densities")])
def test_w2_distance_refuses(rho0, match):
    with pytest.raises(ValueError, match=match):
        w2_distance(rho0, np.ones(rho0.shape), 5, 1, device="cpu")
