"""The port's mixed-precision refine tail and its IR-DCT Poisson solve
against the JAX package, on the CPU.

- ``neumann_ata_apply`` (the IR residual's stencil) equals the JAX function
  in 1D, 2D and 3D to 1e-14 of the largest entry.
- The IR solve against the exact float64 DCT solve (as
  ``tests/test_ops.py::test_ir_dct_precision``): two rounds within 1e-11 of
  the largest entry, one round within 1e-8, the Helmholtz branch within
  1e-11; and against the JAX ``DctPoisson._solve_ir`` on the same seeded
  rhs (the two f32 preconditioners round their matmuls differently; after
  refinement both land on the f64 solution).
- ``solve_dot`` with ``refine_tol`` against the JAX ``solve_dot`` (its host
  driver on the flat layout without Pallas), both in float64 on a random
  17^2 x 5 problem, 1 level: under ``refine_dct_split`` False, "ir" and
  "ir1" the same iteration counts per phase (239 + 849), the same check
  schedule, KKT within 1e-10 and the density within 1e-12; the same for
  dot1d's configuration cut to 129 x 9, 2 levels, and on a weighted
  problem (love-heart).
- The four behaviours of ``tests/test_refine.py`` on the port (float32
  levels, a float64 tail), and ``refine_dct_split`` values the port
  refuses, each with its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models import wdot2d as JW
from dotsocp_tpu.multilevel import solve as jsolve
from dotsocp_tpu.ops import poisson as jpoisson
from dotsocp_tpu.ops.geometry import Geometry as JGeometry

from dotsocp_tpu_torch.models import wdot2d as TW
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.multilevel.level import check_mass_conservation
from dotsocp_tpu_torch.ops import poisson as tpoisson
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.utils.interop import weight_from_numpy

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
JAX_OPTS = {"driver": "host", "layout": "flat", "use_pallas": False,
            "reuse_solvers": False}
STOP = [0, 2, 5, 6]


def _problem(n, seed=0):
    """Random unit-mean densities (``tests/test_refine.py``)."""
    rng = np.random.RandomState(seed)
    rho0 = rng.rand(n, n) + 0.5
    rho1 = rng.rand(n, n) + 0.5
    return rho0 / rho0.mean(), rho1 / rho1.mean()


def _solve(r0, r1, opts, dtype=F32, method="inPALM", **kw):
    """The port's solve on the host driver (the JAX oracle's)."""
    return tsolve.solve_dot(r0, r1, 5, 1, dict(opts, driver="host"), method,
                            device="cpu", dtype=dtype, verbose=False, **kw)


# -- the IR-DCT Poisson solve ----------------------------------------------------

@pytest.mark.parametrize("ns", [(9, 65), (5, 17, 33), (5, 9, 7, 11)])
def test_neumann_ata_apply_matches_jax(ns):
    rng = np.random.default_rng(len(ns))
    y = rng.standard_normal(ns)
    coeffs = tuple(float((n - 1) ** 2) for n in ns)
    want = np.asarray(jpoisson.neumann_ata_apply(jnp.asarray(y), coeffs))
    got = tpoisson.neumann_ata_apply(torch.from_numpy(y), coeffs).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


GEOM = (9, (33, 129))
SCALE = 1.0 / (0.37 ** 2)  # a use-time scale, as 1/D^2 in the solver


def _rhs(seed=7):
    nt, space = GEOM
    return np.random.default_rng(seed).standard_normal((nt,) + space)


@pytest.mark.parametrize("split,epsilon,scale,bound", [
    ("ir", None, SCALE, 1e-11), ("ir1", None, SCALE, 1e-8),
    ("ir", 2.5, None, 1e-11)])
def test_ir_solve_precision(split, epsilon, scale, bound):
    """Against the exact f64 solve, relative to its largest entry; two
    rounds also beat the plain float32 solve by 1e3."""
    geom = Geometry(*GEOM)
    rhs = torch.from_numpy(_rhs())
    exact = tpoisson.make_dct_poisson(geom, epsilon=epsilon, dtype=F64,
                                      device="cpu")
    want = exact.solve(rhs, scale=scale)
    span = float(want.abs().max())
    ir = tpoisson.make_dct_poisson(geom, epsilon=epsilon, split=split,
                                   device="cpu")
    assert ir.mats[0].dtype == F32 and ir.inv_kernel.dtype == F32
    got = ir.solve(rhs, scale=scale)
    assert got.dtype == F64
    err = float((got - want).abs().max()) / span
    assert err < bound, err
    plain32 = ir.solve(rhs.to(F32), scale=scale)  # an f32 rhs: no refinement
    assert plain32.dtype == F32
    err32 = float((plain32.to(F64) - want).abs().max()) / span
    assert err < err32 * (1e-3 if split == "ir" else 1.0), (err, err32)


@pytest.mark.parametrize("split,bound", [("ir", 1e-11), ("ir1", 1e-8)])
def test_solve_ir_matches_jax(split, bound):
    nt, space = GEOM
    rhs = _rhs(seed=3)
    jir = jpoisson.make_dct_poisson(JGeometry(nt, space), split="ir",
                                    ir_steps=1 if split == "ir1" else 2)
    want = np.asarray(jir._solve_ir(jnp.asarray(rhs), SCALE))
    tir = tpoisson.make_dct_poisson(Geometry(nt, space), split=split,
                                    device="cpu")
    got = tir._solve_ir(torch.from_numpy(rhs), SCALE).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


# -- solve_dot with the refine tail against the JAX package -----------------------

def _pair(r0, r1, opts, weight=None, barrier=None):
    """(JAX output, JAX history, port output, port history), both float64
    on the CPU."""
    jw = tw = None
    if weight is not None:
        jw, tw = weight
    jout, jh, _ = jsolve.solve_dot(r0, r1, 5, 1, dict(opts, **JAX_OPTS),
                                   "inPALM", weight=jw,
                                   barrier=None if barrier is None
                                   else barrier[0],
                                   dtype=jnp.float64, verbose=False)
    tout, th, _ = _solve(r0, r1, opts, dtype=F64, weight=tw,
                         barrier=None if barrier is None else barrier[1])
    return jout, jh, tout, th


def _assert_same_run(jout, jh, tout, th):
    assert ([lv["iters"] for lv in tout["levels"]]
            == [int(lv["iters"]) for lv in jout["levels"]])
    assert ([lv["method"] for lv in tout["levels"]]
            == [lv["method"] for lv in jout["levels"]])
    assert tout["levels"][-1]["refine"] is True
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    np.testing.assert_allclose(th["kkt"], jh["kkt"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(tout["rho"].numpy(), np.asarray(jout["rho"]),
                               rtol=0, atol=1e-12)
    assert tout["rho"].dtype == F64
    assert tout["mass_ok"] == jout["mass_ok"]


@pytest.mark.parametrize("split", [False, "ir", "ir1"])
def test_refine_matches_jax_f64(split):
    """"ir1" too takes the same counts and schedule: one round leaves the
    phi error near 1e-9 of its scale, far below the 1e-6 target."""
    r0, r1 = _problem(17)
    jout, jh, tout, th = _pair(r0, r1, {"tol": 1e-4, "maxit": 3000,
                                        "refine_tol": 1e-6,
                                        "refine_dct_split": split})
    _assert_same_run(jout, jh, tout, th)
    assert [lv["iters"] for lv in tout["levels"]] == [239, 849]
    assert th["method"].endswith("(f64 refine, IR-DCT)" if split
                                 else "(f64 refine)")
    assert max(th["kkt"][-1][STOP]) < 1e-6


def test_refine_1d_matches_jax_f64():
    """dot1d's configuration cut to 129 x 9, 2 levels (``bench.py:158-177``:
    gaussian, tol 1e-4, the tail to 1e-5), float64 levels in both packages:
    the same counts per level and check schedule."""
    from dotsocp_tpu_torch.models.examples import get_example_1d

    r0, r1 = get_example_1d("gaussian", 129)
    opts = {"tol": 1e-4, "refine_tol": 1e-5, "refine_dct_split": False}
    jout, jh, _ = jsolve.solve_dot(r0, r1, 9, 2, dict(opts, **JAX_OPTS),
                                   "inPALM", dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(r0, r1, 9, 2, dict(opts, driver="host"),
                                   "inPALM", device="cpu", dtype=F64,
                                   verbose=False)
    _assert_same_run(jout, jh, tout, th)
    assert tout["Ex"].dtype == F64
    assert max(th["kkt"][-1][STOP]) < 1e-5


def test_weighted_refine_matches_jax_f64():
    jb, tb = JW.barrier_love_heart(), TW.barrier_love_heart()
    r0, r1 = JW.get_example_w2d("love-heart", 17, 17)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jw = JW.get_weight_by_barrier(17, 17, 5, jb, dtype=jnp.float64)
    tw = weight_from_numpy(jax.device_get(jw), device="cpu", dtype=F64)
    # the JAX "auto" is "ir1" (its TPU's rule), the port's False: name one
    jout, jh, tout, th = _pair(r0, r1, {"tol": 1e-3, "refine_tol": 1e-5,
                                        "refine_dct_split": False},
                               weight=(jw, tw), barrier=(jb, tb))
    _assert_same_run(jout, jh, tout, th)
    assert max(th["kkt"][-1][[0, 2, 5]]) < 1e-5


# -- tests/test_refine.py on the port ---------------------------------------------

def test_refine_reaches_tight_tol_with_mass():
    r0, r1 = _problem(17)
    out, _, h = _solve(r0, r1, {"tol": 1e-4, "maxit": 3000,
                                "refine_tol": 1e-6})
    assert max(h["kkt"][-1][STOP]) < 1e-6
    assert out["rho"].dtype == F64
    assert out["mass_ok"]
    assert check_mass_conservation(out["rho"], tol=1e-4)
    assert out["levels"][-1].get("refine") is True


def test_refine_matches_pure_f64_solution():
    r0, r1 = _problem(17, seed=3)
    opts = {"tol": 1e-4, "maxit": 4000}
    out_r, _, _ = _solve(r0, r1, {**opts, "refine_tol": 1e-6})
    out_d, _, _ = _solve(r0, r1, {**opts, "tol": 1e-6}, dtype=F64)
    # both at KKT 1e-6: the recovered densities agree to solver accuracy
    np.testing.assert_allclose(out_r["rho"].numpy(), out_d["rho"].numpy(),
                               atol=5e-4)


def test_refine_method_override():
    r0, r1 = _problem(17, seed=1)
    out, _, h = _solve(r0, r1, {"tol": 1e-4, "maxit": 4000,
                                "refine_tol": 1e-6,
                                "refine_method": "acc-ADMM"})
    assert max(h["kkt"][-1][STOP]) < 1e-6
    assert out["mass_ok"]
    assert "ADMM" in h["method"]


def test_refine_method_invalid():
    r0, r1 = _problem(17)
    with pytest.raises(ValueError, match="refine_method"):
        _solve(r0, r1, {"tol": 1e-3, "maxit": 200, "refine_tol": 1e-4,
                        "refine_method": "nonsense"})


@pytest.mark.parametrize("value,match", [
    (True, "TPU's emulated f64"), ("IR", "not one of False, 'auto'"),
    (1, "not one of False, 'auto'")])
def test_refine_dct_split_refused(value, match):
    r0, r1 = _problem(9)
    with pytest.raises(ValueError, match=match):
        _solve(r0, r1, {"tol": 1e-3, "maxit": 50, "refine_tol": 1e-4,
                        "refine_dct_split": value})
