"""The red-black sGS smoother of the PyTorch port (``ops/sgs.py``) and the
sGS methods end to end, against the JAX package on the CPU.

- The plain sweep, its residual and the monitored colour-A residual norm
  against ``dotsocp_tpu.ops.sgs.make_sgs`` in float64 on seeded inputs,
  1D (9, 33) and 2D (7, 29, 17): rtol 1e-12 (the same elementwise
  arithmetic in the same order; the norm sums in another order), with an
  absolute floor of 1e-12 times the largest magnitude.
- The plain sweep in float32 against the JAX package's Pallas sweeps (TPU
  kernels 1 and 2, which the CUDA kernel of ``ops/sgs_sweep.py`` replaces)
  in interpret mode: atol 1e-5 for the whole-field kernel and 2e-6 for the
  tiled one, the tolerances ``tests/test_pallas.py`` holds them to against
  the jnp sweep. The port's sweep takes d2 = D^2 per call; the Pallas
  kernels bake D, so 1/diag differs by an ulp.
- ``solve_dot`` with ``sGS-inPALM`` and ``acc-sGS-ADMM`` against the JAX
  host driver in float64: the same iteration count on every level and the
  same check schedule; KKT histories within rtol 1e-7 / atol 1e-12.
- (slow) the golden sGS-inPALM fixture replayed on the port.

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.multilevel import solve as jsolve
from dotsocp_tpu.ops import sgs as jsgs
from dotsocp_tpu.ops.geometry import Geometry as JGeometry

from dotsocp_tpu_torch.models import examples as texamples
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.ops import sgs as tsgs
from dotsocp_tpu_torch.ops import sgs_sweep
from dotsocp_tpu_torch.ops.geometry import Geometry

torch.set_num_threads(2)

F64 = torch.float64
SHAPES = {"1d": (9, (33,)), "2d": (7, (29, 17))}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=1e-12, atol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if atol is None:
        atol = 1e-12 * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _inputs(name, seed=0, dtype=np.float64):
    nt, space = SHAPES[name]
    rng = np.random.default_rng(seed)
    shape = (nt,) + space
    return (Geometry(nt, space), JGeometry(nt, space),
            rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


# -- the plain smoother against JAX make_sgs, float64 ---------------------------

@pytest.mark.parametrize("name", list(SHAPES))
def test_checkerboard_matches(name):
    geom, jgeom, _, _ = _inputs(name)
    np.testing.assert_array_equal(tsgs.checkerboard(geom),
                                  jsgs.checkerboard(jgeom))


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("its", [1, 2])
def test_sweep_matches_jax(name, its):
    geom, jgeom, phi, rhs = _inputs(name)
    d2 = 0.37 ** 2
    ref = jsgs.make_sgs(jgeom, D=1.0, dtype=jnp.float64)
    sgs = tsgs.make_sgs(geom, dtype=F64)
    want = ref.sweep(jnp.asarray(phi), jnp.asarray(rhs), its, d2=d2)
    close(sgs.sweep(torch.tensor(phi), torch.tensor(rhs), its, d2=d2), want)
    # the wrapper takes the plain version on CPU tensors and counts nothing
    before = sgs_sweep.LAUNCHES["rb_sweep"]
    phi_t = torch.tensor(phi)
    got = sgs_sweep.rb_sweep(sgs, phi_t, torch.tensor(rhs), d2, its)
    close(got, want)
    assert sgs_sweep.LAUNCHES["rb_sweep"] == before
    np.testing.assert_array_equal(phi_t.numpy(), phi)


@pytest.mark.parametrize("name", list(SHAPES))
def test_residuals_match_jax(name):
    geom, jgeom, phi, rhs = _inputs(name, seed=1)
    d2 = 0.8 ** 2
    h = geom.h
    ref = jsgs.make_sgs(jgeom, D=1.0, dtype=jnp.float64)
    sgs = tsgs.make_sgs(geom, dtype=F64)
    close(sgs.residual(torch.tensor(phi), torch.tensor(rhs), d2=d2),
          ref.residual(jnp.asarray(phi), jnp.asarray(rhs), d2=d2))
    close(sgs.residual_color_a_norm(torch.tensor(phi), torch.tensor(rhs), h,
                                    d2=d2),
          ref.residual_color_a_norm(jnp.asarray(phi), jnp.asarray(rhs), h,
                                    d2=d2))


# -- the plain sweep against the Pallas sweeps, float32 -------------------------

@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def test_plain_sweep_matches_pallas_whole_field(interpret_mode):
    """TPU kernel 1 (``make_sgs_sweep_pallas``), two chained sweeps at
    5 x 9 x 17 as ``tests/test_pallas.py`` runs it."""
    from dotsocp_tpu.ops.pallas_kernels import make_sgs_sweep_pallas

    nt, space, D = 5, (9, 17), 0.8
    geom = Geometry(nt, space)
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((nt,) + space).astype(np.float32)
    rhs = rng.standard_normal((nt,) + space).astype(np.float32)
    pal = make_sgs_sweep_pallas(JGeometry(nt, space), D, jnp.float32)
    base = jsgs.make_sgs(JGeometry(nt, space), D, dtype=jnp.float32)
    want = jnp.asarray(phi)
    for _ in range(2):
        want = pal(want, jnp.asarray(rhs), base.inv_diag)
    sgs = tsgs.make_sgs(geom, dtype=torch.float32)
    got = sgs.sweep(torch.from_numpy(phi), torch.from_numpy(rhs), 2,
                    d2=D * D)
    close(got, want, rtol=0.0, atol=1e-5)


def test_plain_sweep_matches_pallas_tiled(interpret_mode):
    """TPU kernel 2 (``make_sgs_sweep_pallas_tiled``), row tiles of 4 with
    edge tiles, two chained sweeps at 7 x 29 x 17."""
    from dotsocp_tpu.ops.pallas_kernels import make_sgs_sweep_pallas_tiled

    geom, jgeom, phi, rhs = _inputs("2d", dtype=np.float32)
    D = 0.8
    tiled = make_sgs_sweep_pallas_tiled(jgeom, D, jnp.float32, tile_rows=4,
                                        interpret=True)
    assert tiled is not None
    sgs = tsgs.make_sgs(geom, dtype=torch.float32)
    want = jnp.asarray(phi)
    got = torch.from_numpy(phi)
    for _ in range(2):
        want = tiled(want, jnp.asarray(rhs))
        got = sgs.sweep(got, torch.from_numpy(rhs), d2=D * D)
    close(got, want, rtol=0.0, atol=2e-6)


# -- the sGS methods end to end ----------------------------------------------------

def _solve_pair(method, opts, n=17, nt=7, levels=2):
    r0, r1 = jexamples.get_example_2d("example2", n, n)
    jout, jh, _ = jsolve.solve_dot(
        r0, r1, nt, levels,
        dict(opts, driver="host", layout="flat", use_pallas=False,
             reuse_solvers=False),
        method, dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(r0, r1, nt, levels,
                                   dict(opts, driver="host"), method,
                                   device="cpu", dtype=F64, verbose=False)
    return jout, jh, tout, th


def assert_same_run(jout, jh, tout, th):
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    assert ([lv["method"] for lv in tout["levels"]]
            == [lv["method"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    close(th["kkt"], jh["kkt"], rtol=1e-7, atol=1e-12)
    close(th["pdGap"], jh["pdGap"], rtol=1e-7, atol=1e-12)
    close(tout["rho"], jout["rho"], rtol=1e-7, atol=1e-12)
    assert tout["mass_ok"] == jout["mass_ok"]


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_solve_matches_jax(method):
    """example2 17^2 x 7, 2 levels: level 1 runs inPALM (the x-carry
    path), level 2 the sGS method, cut at 150 iterations."""
    assert_same_run(*_solve_pair(method, {"tol": 1e-3, "maxit": 150}))


@pytest.mark.slow
def test_golden_sgs_inpalm():
    """``tests/golden/dot2d_example2_65x17_l2_sgsinpalm.npz`` (the JAX host
    driver in float64: 1049 + 2391 iterations) replayed on the port, with
    the tolerances of ``tests/test_golden.py``."""
    ref = np.load(os.path.join(GOLDEN,
                               "dot2d_example2_65x17_l2_sgsinpalm.npz"))
    r0, r1 = texamples.get_example_2d("example2", 65, 65)
    out, hml, _ = tsolve.solve_dot(r0, r1, 17, 2,
                                   {"tol": 1e-4, "driver": "host"},
                                   "sGS-inPALM", device="cpu", dtype=F64,
                                   verbose=False)
    assert [lv["iters"] for lv in out["levels"]] == ref["level_iters"].tolist()
    assert hml["iter"].tolist() == ref["iter"].tolist()
    assert bool(out["mass_ok"]) == bool(ref["mass_ok"])
    np.testing.assert_allclose(hml["kkt"], ref["kkt"], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(hml["pdGap"], ref["pdGap"], rtol=1e-6,
                               atol=1e-10)
