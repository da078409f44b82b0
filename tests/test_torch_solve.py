"""The PyTorch port's solve path against the JAX package on the CPU: the
level setup, the KKT battery, the host driver's tables, the level jump and
solution recovery, and ``solve_dot`` end to end; plus the port's own
guarantees (no JAX import, TF32 off, a clear error without ``nvcc``, the
committed DOTmark data).

End-to-end parity runs both packages in float64 with the JAX host driver on
the flat layout without Pallas, and requires the same iteration count on
every level. KKT histories and the final density agree to rtol 1e-7; the
absolute floor of 1e-12 covers residual 5 (||F*B*beta + alpha||), which is
rounding noise near 1e-16 on both sides because the level jump sets
alpha = -(BF)^T beta.
"""
import inspect
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms import driver as jdriver
from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.algorithms.variants import InPALMKernels
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.multilevel import solve as jsolve

from dotsocp_tpu_torch.algorithms import driver as tdriver
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.models import examples as texamples
from dotsocp_tpu_torch.models import wdot2d as twdot2d
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.ops import _build
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.poisson import make_dct_poisson
from dotsocp_tpu_torch.utils.interop import (level_var_from_numpy,
                                             state_from_numpy)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=1e-12, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jax_level(problem="example2", n=17, nt=7):
    r0, r1 = jexamples.get_example_2d(problem, n, n)
    lv = jlevel.initialize(r0, r1, nt, dtype=jnp.float64)
    jlevel.initial_scaling(lv, scaling=True)
    return lv, r0, r1


# -- level setup ---------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 2])
def test_initialize_and_scaling_match(dim):
    if dim == 1:
        r0, r1 = jexamples.get_example_1d("gaussian", 33)
    else:
        r0, r1 = jexamples.get_example_2d("example2", 17, 17)
    jl = jlevel.initialize(r0, r1, 9, dtype=jnp.float64)
    tl = tlevel.initialize(r0, r1, 9, dtype=F64, device="cpu")
    assert tl.geom == Geometry(jl.geom.nt, jl.geom.space)
    close(tl.c, jl.c)
    close(tl.phi, jl.phi)
    kkt = np.array([2e-4, 1e-4, 3e-5, 1e-5, 2e-5, 4e-5, 6e-5])
    jlevel.initial_scaling(jl, True, kkt, 1.3)
    tlevel.initial_scaling(tl, True, kkt, 1.3)
    for k in ("D", "E", "cScale", "dScale", "E2", "norm_c", "norm_d"):
        np.testing.assert_allclose(getattr(tl, k), getattr(jl, k),
                                   rtol=1e-14, err_msg=k)
    close(tl.c, jl.c)
    close(tl.phi, jl.phi)


@pytest.mark.parametrize("ratio", [0.5, 0.9, 3.0])
def test_update_e2_matches(ratio):
    kkt = [ratio ** 2 * 1e-4, 1e-4]
    assert tlevel.update_e2(1.2, kkt) == jlevel.update_e2(1.2, kkt, False)
    assert tlevel.update_e2(None, None) == jlevel.update_e2(None, None, False)


# -- the host driver's tables --------------------------------------------------

def test_driver_tables_match():
    for it in range(0, 700, 7):
        for last in (-math.inf, 0, it - 3, it - 30):
            assert (tdriver.next_check_iter(it, last)
                    == jdriver.next_check_iter(it, last))
    for xi in np.geomspace(1e-3, 1e3, 97):
        assert (tdriver.get_factor(xi, tdriver.UPDATE_RULE)
                == jdriver.get_factor(xi, jdriver.UPDATE_RULE))
        for sigma in (1e-3, 0.7, 999.0):
            assert (tdriver.adjust_sigma(sigma, xi, tdriver.UPDATE_RULE)
                    == jdriver.adjust_sigma(sigma, xi, jdriver.UPDATE_RULE))


def test_rescale_machine_matches():
    jm = jdriver.RescaleMachine(True, 100)
    tm = tdriver.RescaleMachine(True, 100)
    for it, feas, gap in ((3, 0.5, 0.5), (8, 1e-2, 1e-2), (20, 1e-3, 1e-3),
                          (70, 1e-3, 1e-3), (130, 1e-4, 1e-4)):
        assert tm.next_trigger(it) == jm.next_trigger(it)
        jm.update_from_check(feas, gap)
        tm.update_from_check(feas, gap)
        assert tm.next_trigger(it) == jm.next_trigger(it)
        jm.stage += 1
        tm.stage += 1


# -- kernels: KKT battery and state transforms ---------------------------------

def _pair_states(steps=4):
    lv, _, _ = _jax_level()
    cfg = JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                       dtype=jnp.float64, layout="flat")
    jk = InPALMKernels(cfg)
    js = jk.prep(lv.as_dict(), sigma=0.8)
    js = jk.run_segment(js, steps)
    tk = Kernels(LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space),
                             D=lv.D, E=lv.E, tau=1.9, dtype=F64,
                             device="cpu"))
    ts = state_from_numpy(jax.device_get(js._asdict()), device="cpu",
                          dtype=F64)
    return jk, js, tk, ts, lv


def test_kkt_battery_matches():
    jk, js, tk, ts, _ = _pair_states()
    want = jax.device_get(jk.kkt(js))
    got = tk.kkt(ts)
    # residual 5 is rounding noise (~1e-16) right after the warm start
    close(got["kkt_org"], want["kkt_org"], rtol=1e-10, atol=1e-14)
    close(got["kkt"], want["kkt"], rtol=1e-10, atol=1e-14)
    for k in ("priVal", "dualVal", "pdGap", "normPhi", "normQ", "normZ",
              "normAlpha", "normBeta", "normAphi"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)
    norms = tk.norms(ts)
    jn = jax.device_get(jk.norms(js))
    for k, v in jn.items():
        np.testing.assert_allclose(norms[k], v, rtol=1e-12, err_msg=k)


def test_sigma_mult_and_rescale_match():
    jk, js, tk, ts, _ = _pair_states()
    j2 = jax.device_get(jk.rescale(jk.sigma_mult(js, 1.26), 1.7, 0.6)._asdict())
    t2 = tk.rescale(tk.sigma_mult(ts, 1.26), 1.7, 0.6)
    for k in ("sigma", "cScale", "dScale", "norm_c", "norm_d", "sigmaScale"):
        np.testing.assert_allclose(getattr(t2, k), float(j2[k]), rtol=1e-14,
                                   err_msg=k)
    close(t2.beta, j2["beta"])
    close(t2.z, j2["z"])
    close(t2.c, j2["c"])
    close(t2.q.q0, j2["q"].q0)
    close(t2.alpha.bs[0], j2["alpha"].bs[0])


def test_prep_finalize_round_trip():
    jk, js, tk, ts, lv = _pair_states(steps=0)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F64)
    s = tk.prep(tv.as_dict(), 0.8)
    close(s.alpha.q0, ts.alpha.q0)
    close(s.beta, ts.beta)
    out = tk.finalize(s, tv.as_dict())
    jout = jk.finalize(js, lv.as_dict())
    for k in ("phi", "z", "beta", "c"):
        close(out[k], jout[k])
    for a, b in zip(out["alpha"].bs, jout["alpha"].bs):
        close(a, b)
    assert out["sigma_out"] == pytest.approx(jout["sigma_out"], rel=1e-15)


@pytest.mark.parametrize("dim", [1, 2])
def test_prep_after_level_jump_is_contiguous(dim):
    """The kernels take contiguous tensors only: the state built from a
    prolongated level (permuted strides out of the transfers) must be."""
    if dim == 1:
        r0, r1 = texamples.get_example_1d("gaussian", 17)
    else:
        r0, r1 = texamples.get_example_2d("example2", 9, 9)
    coarse = tlevel.initialize(r0, r1, 5, dtype=F64, device="cpu")
    coarse.beta = torch.randn(coarse.geom.z_shape, dtype=F64)
    fine_r0 = np.interp(np.linspace(0, 1, 33), np.linspace(0, 1, 17), r0) \
        if dim == 1 else texamples.get_example_2d("example2", 17, 17)[0]
    fine = tsolve._jump_next_level(coarse, torch.tensor(fine_r0),
                                   torch.tensor(fine_r0), 9, F64)
    tlevel.initial_scaling(fine, True)
    tk = Kernels(LevelConfig(geom=fine.geom, D=fine.D, E=fine.E,
                             device="cpu", dtype=F64))
    s = tk.prep(fine.as_dict(), 0.8)
    for t in (s.phi, s.z, s.beta, s.c, *s.q.blocks(), *s.alpha.blocks()):
        assert t.is_contiguous()


# -- level jump and recovery ---------------------------------------------------

def test_jump_next_level_matches():
    lv, _, _ = _jax_level(nt=5, n=9)
    rng = np.random.default_rng(7)
    lv.phi = jnp.asarray(rng.standard_normal(lv.geom.phi_shape))
    lv.beta = jnp.asarray(rng.standard_normal(lv.geom.z_shape))
    r0, r1 = jexamples.get_example_2d("example2", 17, 17)
    jf = jsolve._jump_next_level(lv, r0, r1, 9, jnp.float64)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F64)
    tf = tsolve._jump_next_level(tv, torch.tensor(r0), torch.tensor(r1), 9,
                                 F64)
    for k in ("phi", "beta", "c", "z"):
        close(getattr(tf, k), getattr(jf, k), rtol=1e-13,
              atol=1e-13 * float(np.abs(getattr(jf, k)).max() or 1.0))
    for k in ("q", "alpha"):
        want = getattr(jf, k)
        got = getattr(tf, k)
        close(got.q0, want.q0, rtol=1e-13, atol=1e-12)
        for a, b in zip(got.bs, want.bs):
            close(a, b, rtol=1e-13, atol=1e-12)


def test_recover_solution_matches():
    lv, r0, r1 = _jax_level()
    rng = np.random.default_rng(3)
    g = lv.geom
    lv.alpha = jax.tree.map(
        lambda x: jnp.asarray(1.0 + 0.01 * rng.standard_normal(x.shape)),
        lv.alpha)
    lv.q = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape)),
                        lv.q)
    want = jlevel.recover_solution(lv)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F64)
    got = tlevel.recover_solution(tv)
    close(got[0], want[0])
    for i in (1, 3):
        for a, b in zip(got[i], want[i]):
            close(a, b)
    close(got[2], want[2])
    assert got[4] == want[4]
    rho = np.asarray(want[0])
    assert tlevel.check_mass_conservation(torch.tensor(rho)) == \
        jlevel.check_mass_conservation(rho)
    assert g.nt == rho.shape[0]


# -- solve_dot end to end ------------------------------------------------------

def _solve_pair(method, rho0, rho1, nt, levels, opts):
    jout, jh, _ = jsolve.solve_dot(
        rho0, rho1, nt, levels,
        dict(opts, driver="host", layout="flat", use_pallas=False,
             reuse_solvers=False),
        method, dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(rho0, rho1, nt, levels,
                                   dict(opts, driver="host"), method,
                                   device="cpu", dtype=F64, verbose=False)
    return jout, jh, tout, th


@pytest.mark.parametrize("method,dim", [("inPALM", 2), ("ALG2", 1)])
def test_solve_dot_matches_jax(method, dim):
    if dim == 2:
        r0, r1 = jexamples.get_example_2d("example2", 33, 33)
        nt, opts = 9, {"tol": 1e-4}
    else:
        r0, r1 = jexamples.get_example_1d("gaussian", 65)
        nt, opts = 9, {"tol": 1e-4, "maxit": 400}
    jout, jh, tout, th = _solve_pair(method, r0, r1, nt, 2, opts)
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    close(th["kkt"], jh["kkt"], rtol=1e-7, atol=1e-12)
    close(th["pdGap"], jh["pdGap"], rtol=1e-7, atol=1e-12)
    close(tout["rho"], jout["rho"], rtol=1e-7, atol=1e-12)
    for a, b in zip(tout["E"], jout["E"]):
        close(a, b, rtol=1e-7, atol=1e-9)
    assert tout["mass_ok"] == jout["mass_ok"]


@pytest.mark.slow
def test_headline_iterations_f64():
    """DOTmark-4stitch 129^2 x 33, 3 levels, inPALM, tol 1e-4, float64 on
    the CPU: 189 + 174 + 159 = 522 iterations, as the JAX package takes."""
    r0, r1 = texamples.get_example_2d("DOTmark_4stitch", 129, 129)
    out, _, hist = tsolve.solve_dot(r0, r1, 33, 3, {"tol": 1e-4}, "inPALM",
                                    device="cpu", dtype=F64, verbose=False)
    assert [lv["iters"] for lv in out["levels"]] == [189, 174, 159]
    assert out["mass_ok"]
    assert max(hist["kkt"][-1][[0, 2, 5, 6]]) < 1e-4


def test_solve_dot_refuses_what_waits():
    r0, r1 = texamples.get_example_2d("example2", 9, 9)
    run = lambda **kw: tsolve.solve_dot(
        r0, r1, 5, 1, kw.pop("opts", None), kw.pop("method", "inPALM"),
        kw.pop("weight", None), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="not in"):
        run(method="sGS-ADMM")
    # weighted: only WDOT_METHODS
    weight = twdot2d.get_weight_by_barrier(9, 9, 5,
                                           twdot2d.barrier_love_heart())
    with pytest.raises(ValueError, match="not in"):
        run(weight=weight, method="PALM")
    # a mesh that is not the port's and a checkpoint_dir that is not a path
    # are refused
    for key, error, match in (("mesh", TypeError, "not a dotsocp_tpu_torch"),
                              ("checkpoint_dir", TypeError, "a directory")):
        with pytest.raises(error, match=match):
            run(opts={key: 1e-6})
    with pytest.raises(ValueError, match="unknown option"):
        run(opts={"tolerance": 1e-6})
    # the device defaults to the card, and a call without one never falls
    # back to the CPU: torch cannot reach the device, so the call raises
    device = inspect.signature(tsolve.solve_dot).parameters["device"]
    assert device.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tsolve.solve_dot(r0, r1, 5, 1, verbose=False)


# -- the port's own guarantees -------------------------------------------------

def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import dotsocp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'dotsocp_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_dct_setup_leaves_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        make_dct_poisson(Geometry(nt=5, space=(9, 9)), dtype=torch.float32,
                         device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def test_build_compiles_sources_in_parallel(monkeypatch, tmp_path):
    """One nvcc per source, all started together; a second build reuses
    the libraries. A stand-in nvcc sleeps 1 s and writes its -o file."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; "
                    "shift; done\n"
                    "sleep 1; echo 'ptxas info: Used 8 registers' >&2; "
                    "touch \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    paths = _build.build()
    assert len(paths) == len(_build.SOURCES) >= 2
    assert all(os.path.isfile(p) for p in paths)
    assert _build.build_info["seconds"] < 1.0 + 0.8 * (len(paths) - 1)
    assert _build.build_info["log"].count("registers") == len(paths)
    assert _build.build() == paths and _build.build_info["cached"]


def test_dotmark_data_matches_jax_package():
    path = texamples.dotmark_npz_path(129)
    assert os.path.isfile(path)
    raw0, raw1 = jexamples.gene_example_dotmark_4stitch(129, 129)
    got0, got1 = texamples.gene_example_dotmark_4stitch(129, 129)
    np.testing.assert_array_equal(got0, raw0)
    np.testing.assert_array_equal(got1, raw1)
    assert jexamples.density_source("DOTmark_4stitch") != "procedural"
    want = jexamples.get_example_2d("DOTmark_4stitch", 129, 129)
    got = texamples.get_example_2d("DOTmark_4stitch", 129, 129)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="make_dotmark_npz"):
        texamples.get_example_2d("DOTmark_4stitch", 65, 65)


@pytest.mark.parametrize("problem", ["example1", "example2", "example3",
                                     "example4", "example7", "circle"])
def test_examples_match(problem):
    for a, b in zip(texamples.get_example_2d(problem, 17, 13, 0.1),
                    jexamples.get_example_2d(problem, 17, 13, 0.1)):
        np.testing.assert_array_equal(a, b)
    for p in ("gaussian", "box"):
        for a, b in zip(texamples.get_example_1d(p, 33),
                        jexamples.get_example_1d(p, 33)):
            np.testing.assert_array_equal(a, b)
