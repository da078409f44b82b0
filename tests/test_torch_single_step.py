"""The single step of the PyTorch port against the JAX package on the CPU:
the single-step kernels' plain versions (``ops/fused_step.py``: z_step,
q_step, beta_step, cone_project_diff), ``Kernels.run_one``, and acc-ADMM's
Nesterov branch (theta != 2, ``AccADMMNesterovKernels``).

- The plain z_step, q_step and beta_step in float32 against the Pallas
  kernels of ``make_fused_flat_step`` in interpret mode, on seeded inputs
  at 17^2 x 7 and 33 x 7: rtol 2e-5 / atol 2e-6, as ``tests/test_pallas.py``
  holds the Pallas kernels against the jnp ops (FMA contraction, the
  association of the face sum and the diagonal as floats or arrays differ
  by a few ulp). The weighted q-step, with love-heart weights in 2D and
  seeded weights with 1e6 walls in 1D: the same, except alpha' on the
  wall faces, held to rtol 2e-5 and an atol of 2e-6 + 4 tau eps32
  (|D grad phi| + |alpha|): there w q' cancels D grad phi + alpha down to
  alpha's size, and XLA's fused interpretation of the kernel body rounds
  otherwise than op-by-op evaluation (``tests/test_torch_weighted.py``).
- The plain cone projection against ``cone_project_diff_pallas``: atol
  1e-6 (``tests/test_pallas.py:36-43``).
- ``run_one``: 5 steps in float64 against the JAX ``InPALMKernels.run_one``
  on its jnp path at rtol 1e-12 (an absolute floor of 1e-12 times the
  largest magnitude: reductions sum in another order), and in float32
  against its Pallas path in interpret mode at rtol 2e-5 / atol 2e-6
  (``tests/test_pallas.py:91-114``): 5 steps in 2D, 2 in 1D, where the
  port's and the JAX package's float32 plain paths themselves drift apart
  past 2e-6 from the third step on (the 1D Gaussian's inverse Laplacian
  amplifies the DCT's rounding; the JAX jnp and Pallas paths stay within
  it); the state given to ``run_one`` comes back unchanged, exactly.
- Nesterov in float64: one extrapolation (at k = 3, and with restart = 4,
  where it restarts), a sigma change and a rescale, one step: rtol 1e-12
  with the floor above; ``solve_dot`` with theta = 3 against the JAX host
  driver, unweighted (also at the card's anchor size, 65^2 x 17) and
  weighted: the same iteration count on every level and the same check
  schedule, KKT histories within rtol 1e-7 / atol 1e-10.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.algorithms.variants import (AccADMMNesterovKernels as
                                             JNesterov)
from dotsocp_tpu.algorithms.variants import InPALMKernels
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.models import wdot2d as JW
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.ops.engine import OpsFlat as JOpsFlat
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.pallas_kernels import (cone_project_diff_pallas,
                                            make_fused_flat_step)
from dotsocp_tpu.ops.staggered import Staggered as JStaggered

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.algorithms.variants import (AccADMMNesterovKernels,
                                                   NesterovState)
from dotsocp_tpu_torch.models import wdot2d as TW
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import OpsFlat
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.utils.interop import (nesterov_state_from_numpy,
                                             state_from_numpy, state_to_numpy,
                                             weight_from_numpy)

from .test_torch_fused_step import GEOMS, TAU, D, E, Inputs, _t, close
from .test_torch_sgs import _solve_pair, assert_same_run
from .test_torch_sgs import close as close64
from .test_torch_variants import assert_iterate_close, assert_state_close
from .test_torch_weighted import _solve_pair as _weighted_solve_pair

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(params=list(GEOMS))
def inp(request, interpret_mode):
    return Inputs(request.param)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the plain versions against the Pallas kernels, float32 ---------------------

def test_z_step_matches_pallas(inp):
    want = inp.kern["z_step"](inp.jq.q0, list(inp.jq.bs),
                              jnp.asarray(inp.beta), inp.sbf, inp.sd)
    before = dict(fs.LAUNCHES)
    got = fs.z_step(inp.tops, inp.tq, _t(inp.beta), inp.sbf, inp.sd)
    close(got, want)
    assert fs.LAUNCHES == before  # CPU tensors take the plain version


def test_q_step_matches_pallas(inp):
    """z is the x of the inputs; both packages read z and beta apart."""
    q0n, bns, a0n, abns = inp.kern["q_step"](
        jnp.asarray(inp.phi), jnp.asarray(inp.x), jnp.asarray(inp.beta),
        inp.ja.q0, list(inp.ja.bs), inp.jdinv.q0, list(inp.jdinv.bs),
        jnp.float32(D), jnp.float32(inp.sbf), jnp.float32(TAU))
    alpha = inp.ta.clone()
    q, a = fs.q_step(inp.tops, _t(inp.phi), _t(inp.x), _t(inp.beta), alpha,
                     inp.tdinv, D, inp.sbf, TAU)
    close(q.q0, q0n)
    close(a.q0, a0n)
    for ax in range(inp.geom.ndim_space):
        close(q.bs[ax], bns[ax])
        close(a.bs[ax], abns[ax])
        assert torch.all(q.bs[ax] * (1.0 - inp.tops.masks[ax]) == 0.0)
    assert all(torch.equal(x, y) for x, y in zip(alpha.blocks(),
                                                 inp.ta.blocks()))


def test_beta_step_matches_pallas(inp):
    want = inp.kern["beta_step"](
        jnp.asarray(inp.beta), jnp.asarray(inp.x), inp.jq.q0,
        list(inp.jq.bs), jnp.float32(inp.sbf), jnp.float32(inp.sd),
        jnp.float32(TAU))
    got = fs.beta_step(inp.tops, _t(inp.beta), _t(inp.x), inp.tq, inp.sbf,
                       inp.sd, TAU)
    close(got, want)


def _weight_1d(rng, nt, n):
    """Weights in [0.5, 2] with about one face in eight at the wall
    weight, the time block seeded too."""
    b = rng.uniform(0.5, 2.0, (nt, n - 1))
    b[rng.random(b.shape) < 0.125] = TW.BARRIER_WEIGHT
    return JStaggered(q0=jnp.asarray(rng.uniform(0.5, 2.0, (nt - 1, n)),
                                     jnp.float32),
                      bs=(jnp.asarray(b, jnp.float32),))


@pytest.mark.parametrize("name", ["2d", "1d"])
def test_weighted_q_step_matches_pallas(interpret_mode, name):
    rng = np.random.default_rng(13)
    nt, space = GEOMS[name]
    if name == "2d":
        jw = JW.get_weight_by_barrier(space[1], space[0], nt,
                                      JW.barrier_love_heart(),
                                      dtype=jnp.float32)
    else:
        jw = _weight_1d(rng, nt, space[0])
    jgeom, g = JGeometry(nt, space), Geometry(nt, space)
    jops, tops = JOpsFlat(jgeom, jnp.float32), OpsFlat(g, F32, "cpu")
    jwi = jops.weight_to_internal(jw)
    assert float(jnp.max(jwi.bs[0])) == TW.BARRIER_WEIGHT
    kern = make_fused_flat_step(jgeom, jops.strides, jops.masks, TAU,
                                jnp.float32, interpret=True, weight=jwi)
    S, C = tops.S, g.cone_cols
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    phi, z, beta = f32(nt, S), f32(C, nt - 1, S), f32(C, nt - 1, S)
    a0 = f32(nt - 1, S)
    ab = f32(g.ndim_space, nt, S) * tops.masks.numpy()
    jdinv = jax.tree.map(lambda v: 1.0 / v, jops.oper_q_diag(D, E, jwi))
    q0n, bns, a0n, abns = kern["q_step"](
        jnp.asarray(phi), jnp.asarray(z), jnp.asarray(beta), jnp.asarray(a0),
        list(ab), jdinv.q0, list(jdinv.bs), jnp.float32(D),
        jnp.float32(E / D), jnp.float32(TAU))
    tw = tops.weight_to_internal(weight_from_numpy(jax.device_get(jw),
                                                   device="cpu", dtype=F32))
    q, alpha = fs.q_step(tops, torch.tensor(phi), torch.tensor(z),
                         torch.tensor(beta),
                         Staggered(torch.tensor(a0), torch.tensor(ab)),
                         fs.weighted_dinv(tops, tw, D, E), D, E / D, TAU)
    rtol, atol = 2e-5, 2e-6
    tmp = D * OpsFlat(g, F64, "cpu").grad(torch.tensor(phi, dtype=F64))
    scale = 4 * TAU * float(np.finfo(np.float32).eps)
    close(q.q0, q0n)
    for ax in range(g.ndim_space):
        close(q.bs[ax], bns[ax])
        assert torch.all(q.bs[ax] * (1.0 - tops.masks[ax]) == 0.0)
    for got, want, t_b, a_b, w_b in (
            [(alpha.q0, a0n, tmp.q0, a0, tw.q0)]
            + [(alpha.bs[ax], abns[ax], tmp.bs[ax], ab[ax], tw.bs[ax])
               for ax in range(g.ndim_space)]):
        wall = _np(w_b) > 1e5
        bound = (np.where(wall, atol + scale * (np.abs(_np(t_b))
                                                + np.abs(a_b)), atol)
                 + rtol * np.abs(np.asarray(want)))
        err = np.abs(_np(got) - np.asarray(want))
        assert np.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize("shape", [(10, 4, 9, 17), (6, 6, 33)])
def test_cone_project_diff_matches_pallas(interpret_mode, shape):
    rng = np.random.default_rng(5)
    z2 = rng.standard_normal(shape).astype(np.float32)
    beta = rng.standard_normal(shape).astype(np.float32)
    want = cone_project_diff_pallas(jnp.asarray(z2), jnp.asarray(beta))
    before = dict(fs.LAUNCHES)
    got = fs.cone_project_diff(torch.tensor(z2), torch.tensor(beta))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    assert fs.LAUNCHES == before


# -- run_one ---------------------------------------------------------------------

def _level(ndim, dtype):
    if ndim == 1:
        rho0, rho1 = jexamples.get_example_1d("gaussian", 33)
    else:
        rho0, rho1 = jexamples.get_example_2d("example2", 17, 17)
    lv = jlevel.initialize(rho0, rho1, 7, dtype=dtype)
    jlevel.initial_scaling(lv, scaling=True)
    return lv


def _kernels(lv, jdtype, tdtype, use_pallas):
    jk = InPALMKernels(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=TAU,
                                    dtype=jdtype, layout="flat",
                                    use_pallas=use_pallas))
    tk = Kernels(LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space),
                             D=lv.D, E=lv.E, tau=TAU, dtype=tdtype,
                             device="cpu"))
    return jk, tk


def _fields(state):
    return jax.device_get(state._asdict())


def _run_ones(jk, tk, lv, dtype, steps=5):
    """``steps`` run_one calls in both packages from the JAX prep state;
    the port's input to each call must come back unchanged."""
    js = jk.prep(lv.as_dict(), sigma=1.0)
    ts = state_from_numpy(_fields(js), device="cpu", dtype=dtype)
    for _ in range(steps):
        js = jk.run_one(js)
        before = state_to_numpy(ts)
        nxt = tk.run_one(ts)
        after = state_to_numpy(ts)
        for k in ("phi", "z", "beta", "c"):
            np.testing.assert_array_equal(after[k], before[k])
        for k in ("q", "alpha"):
            for x, y in zip((after[k][0],) + after[k][1],
                            (before[k][0],) + before[k][1]):
                np.testing.assert_array_equal(x, y)
        ts = nxt
    return state_to_numpy(ts), _fields(js)


def _assert_close(got, want, rtol, atol=None, closer=close):
    kw = {} if atol is None else {"atol": atol}
    for k in ("phi", "z", "beta", "c"):
        closer(got[k], want[k], rtol, **kw)
    for k in ("q", "alpha"):
        closer(got[k][0], want[k][0], rtol, **kw)
        for a, b in zip(got[k][1], want[k][1]):
            closer(a, b, rtol, **kw)


@pytest.mark.parametrize("ndim", [1, 2])
def test_run_one_matches_jax_f64(ndim):
    lv = _level(ndim, jnp.float64)
    jk, tk = _kernels(lv, jnp.float64, F64, use_pallas=False)
    got, want = _run_ones(jk, tk, lv, F64)
    _assert_close(got, want, 1e-12, closer=close64)


@pytest.mark.parametrize("ndim,steps", [(1, 2), (2, 5)])
def test_run_one_matches_jax_pallas_f32(interpret_mode, ndim, steps):
    lv = _level(ndim, jnp.float32)
    jk, tk = _kernels(lv, jnp.float32, F32, use_pallas=True)
    assert jk._fused is not None
    got, want = _run_ones(jk, tk, lv, F32, steps)
    _assert_close(got, want, 2e-5, 2e-6)


# -- acc-ADMM's Nesterov branch ----------------------------------------------------

class NesterovPair:
    """The Nesterov kernels of both packages and the JAX state after four
    iterations (three extrapolations: k = 3), converted to the port."""

    def __init__(self, restart=100):
        lv = _level(2, jnp.float64)
        self.jk = JNesterov(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                         tau=1.0, dtype=jnp.float64,
                                         layout="flat"),
                            restart=restart, theta=3.0)
        self.tk = AccADMMNesterovKernels(
            LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space), D=lv.D,
                        E=lv.E, tau=1.0, dtype=F64, device="cpu"),
            restart=restart, theta=3.0)
        self.js = self.jk.run_segment(self.jk.prep(lv.as_dict(), sigma=0.8),
                                      4)
        self.ts = self.port(self.js)

    @staticmethod
    def port(js) -> NesterovState:
        return nesterov_state_from_numpy(jax.device_get(js)._asdict(),
                                         device="cpu", dtype=F64)


def assert_nesterov_close(got, want):
    assert_state_close(got.s, want.s)
    assert_iterate_close(got.old, want.old)
    assert_iterate_close(got.hat_old, want.hat_old)
    assert got.k == want.k


@pytest.mark.parametrize("restart", [100, 4])
def test_nesterov_extrapolation_matches(restart):
    p = NesterovPair(restart)
    assert p.ts.k == 3
    got = p.tk.post_check(p.ts)
    assert_nesterov_close(got, p.port(jax.jit(p.jk._extrapolate)(p.js)))
    assert got.k == (0 if restart == 4 else 4)


def test_nesterov_sigma_rescale_and_step_match():
    p = NesterovPair()
    want = p.port(p.jk.rescale(p.jk.sigma_mult(p.js, 1.26), 1.7, 0.6))
    assert_nesterov_close(p.tk.rescale(p.tk.sigma_mult(p.ts, 1.26), 1.7, 0.6),
                          want)
    want = p.port(p.js._replace(s=jax.jit(p.jk._step)(p.js.s)))
    assert_state_close(p.tk._step(p.ts.s), want.s)


def test_nesterov_solve_matches_jax():
    """example2 17^2 x 7, 2 levels, cut at 150 iterations a level."""
    assert_same_run(*_solve_pair("acc-ADMM", {"tol": 1e-3, "maxit": 150,
                                              "theta": 3.0}))


def test_nesterov_anchor_matches_jax():
    """``chip_smoke.THETA3_ANCHOR``, the count the card is held to: theta = 3
    at example2 65^2 x 17, 2 levels, tol 1e-4, both packages in float64."""
    from chip_smoke import THETA3_ANCHOR

    jout, jh, tout, th = _solve_pair("acc-ADMM", {"tol": 1e-4, "theta": 3.0},
                                     n=65, nt=17)
    assert_same_run(jout, jh, tout, th)
    assert [lv["iters"] for lv in tout["levels"]] == list(THETA3_ANCHOR)


def test_weighted_nesterov_solve_matches_jax():
    """Love-heart 33^2 x 9, 1 level, tol 1e-3."""
    jout, jh, tout, th = _weighted_solve_pair(
        "acc-ADMM", 33, 9, 1, "love-heart", "love-heart",
        {"tol": 1e-3, "theta": 3.0})
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    close64(th["kkt"], jh["kkt"], rtol=1e-7, atol=1e-10)
    close64(tout["rho"], jout["rho"], rtol=1e-7, atol=1e-12)
    assert tout["mass_ok"] and jout["mass_ok"]
