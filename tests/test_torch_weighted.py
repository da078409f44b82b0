"""The weighted (obstacle) DOT family of the PyTorch port against the JAX
package on the CPU.

- Problem layer (``models/wdot2d.py``): densities, barrier masks, weights
  and the barrier validity helpers equal the JAX package's exactly (the same
  numpy arithmetic); the image barriers refuse.
- Level plumbing in float64 at 1e-12: ``restrict_staggered`` (log space and
  linear), the weighted ``initial_scaling`` and ``update_e2``,
  ``weight_to_internal`` and the weighted q-step diagonal, the level jump
  and the weight-folded recovery.
- Kernels in float64 at rtol 1e-12 (an absolute floor of 1e-12 times the
  largest magnitude, as the reductions sum in another order): five plain
  weighted steps and the weighted CA segment (k = 1, 4) against the JAX
  ``InPALMKernels(cfg, weight)`` on the flat layout at 17^2 x 7, the
  weighted KKT battery, and weighted acc-ADMM steps and averaging.
- The plain weighted q-step (the kernel's plain version) in float32 against
  the JAX Pallas weighted ``qx_step`` in interpret mode, in 2D with
  love-heart barrier weights and in 1D with seeded weights, some faces at
  the 1e6 wall weight: rtol 2e-5 / atol 2e-6, as ``tests/test_pallas.py``
  holds the Pallas kernels against the jnp ops; alpha' on the wall faces
  to rtol 2e-5 and an atol of 2e-6 + 4 tau eps32 (|D grad phi| + |alpha|).
  There alpha' = alpha + tau (D grad phi - w q') with w q' cancelling
  D grad phi + alpha down to alpha's size, so a rounding taken in another
  order moves alpha' by ulps of those terms. XLA compiles the interpreted
  kernel's body into fused loops that round otherwise than op-by-op
  evaluation: JAX's own jitted and eager jnp q-steps differ by 2.8e-6 at a
  wall face of the 2D case, and the port's plain version equals the eager
  one there. Off the walls, and for q' everywhere, the 2e-6 holds.
- ``solve_dot`` end to end against the JAX host driver in float64: weighted
  inPALM on love-heart 33^2 x 17 with 2 levels, ALG2 and acc-ADMM at the
  sizes of ``tests/test_solver.py``: the same iteration count on every level
  and the same check schedule; KKT histories within rtol 1e-7 / atol 1e-10
  (residual 5, ||F*B*beta + w alpha||, is rounding noise near 1e-11 here:
  the 1e6 walls multiply alpha's rounding; 1e-12 in the unweighted tests).

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.algorithms.variants import AccADMMKernels as JAccADMMKernels
from dotsocp_tpu.algorithms.variants import InPALMKernels
from dotsocp_tpu.models import wdot2d as JW
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.multilevel import solve as jsolve
from dotsocp_tpu.multilevel import transfer as jtransfer
from dotsocp_tpu.ops.engine import OpsFlat as JOpsFlat
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.pallas_kernels import make_fused_flat_step
from dotsocp_tpu.ops.staggered import Staggered as JStaggered

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.algorithms.variants import AccADMMKernels
from dotsocp_tpu_torch.models import wdot2d as TW
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.multilevel import transfer as ttransfer
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import OpsFlat
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.utils.interop import (acc_state_from_numpy,
                                             level_var_from_numpy,
                                             state_from_numpy, state_to_numpy,
                                             weight_from_numpy)

from .test_torch_sgs import close

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
PROBLEMS = ("example1", "example2", "example3", "example4", "circle",
            "circle2", "example6", "maze14", "love-heart")
BARRIERS = {"love-heart": "barrier_love_heart",
            "circle-pillar": "barrier_circle_pillar"}
TAU = 1.9


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def equal_stag(got: Staggered, want):
    np.testing.assert_array_equal(_np(got.q0), np.asarray(want.q0))
    assert len(got.bs) == len(want.bs)
    for a, b in zip(got.bs, want.bs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def close_stag(got: Staggered, want, **kw):
    close(got.q0, want.q0, **kw)
    for a, b in zip(got.bs, want.bs):
        close(a, b, **kw)


def _barriers(name):
    return getattr(JW, BARRIERS[name])(), getattr(TW, BARRIERS[name])()


def _tweight(jw, dtype=F64):
    return weight_from_numpy(jax.device_get(jw), device="cpu", dtype=dtype)


# -- the problem layer ----------------------------------------------------------

@pytest.mark.parametrize("problem", PROBLEMS)
def test_densities_match(problem):
    for a, b in zip(TW.get_example_w2d(problem, 17, 13, 0.1),
                    JW.get_example_w2d(problem, 17, 13, 0.1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("barrier", list(BARRIERS))
def test_barrier_masks_weights_and_validity_match(barrier):
    jb, tb = _barriers(barrier)
    x = np.linspace(0, 1, 23)[None, :]
    y = np.linspace(0, 1, 19)[:, None]
    np.testing.assert_array_equal(tb(x, y), jb(x, y))
    jw = JW.get_weight_by_barrier(23, 19, 5, jb, dtype=jnp.float64)
    tw = TW.get_weight_by_barrier(23, 19, 5, tb, dtype=F64)
    equal_stag(tw, jw)
    assert float(tw.bs[0].max()) == TW.BARRIER_WEIGHT
    for dtype in (F32, F64):
        assert TW.get_weight_by_barrier(9, 9, 3, tb, dtype=dtype).dtype == dtype
    r0, r1 = JW.get_example_w2d("love-heart", 23, 19)
    want = JW.ensure_barrier_validity(r0, r1, jb)
    got = TW.ensure_barrier_validity(torch.tensor(r0), r1, tb)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(TW.check_barrier_validity(*got[:2], tb),
                                  JW.check_barrier_validity(*want[:2], jb))
    with pytest.raises(ValueError, match="on barrier"):
        TW.check_barrier_validity(np.ones((19, 23)), np.ones((19, 23)), tb)


@pytest.mark.parametrize("name", ["gene_weight_circle",
                                  "gene_weight_circle_inv"])
def test_radial_weights_match(name):
    equal_stag(getattr(TW, name)(5, 13, 11, dtype=F64),
               getattr(JW, name)(5, 13, 11, dtype=jnp.float64))


@pytest.mark.parametrize("name", ["barrier_maze14", "barrier_example6"])
def test_image_barriers_refuse(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        getattr(TW, name)()


# -- level plumbing --------------------------------------------------------------

@pytest.mark.parametrize("log_space", [True, False], ids=["log", "linear"])
def test_restrict_staggered_matches(log_space):
    jb, _ = _barriers("love-heart")
    jw = JW.get_weight_by_barrier(33, 33, 17, jb, dtype=jnp.float64)
    if not log_space:  # a smooth field with no walls
        jw = jw * 0.5 + JW.gene_weight_circle(17, 33, 33, dtype=jnp.float64)
    want = jtransfer.restrict_staggered(jw, log_space=log_space)
    got = ttransfer.restrict_staggered(_tweight(jw), log_space=log_space)
    assert got.q0.shape == want.q0.shape == (8, 17, 17)
    close_stag(got, want, rtol=1e-12, atol=0)


def _weighted_level(n=17, nt=7, dtype=jnp.float64, barrier="love-heart"):
    jb, _ = _barriers(barrier)
    r0, r1 = JW.get_example_w2d("love-heart", n, n)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jw = JW.get_weight_by_barrier(n, n, nt, jb, dtype=dtype)
    lv = jlevel.initialize(r0, r1, nt, dtype=dtype, weight=jw)
    return lv, r0, r1, jw


@pytest.mark.parametrize("ratio", [0.1, 0.9, 3.0, 9.0])
def test_weighted_initial_scaling_and_e2_match(ratio):
    kkt = np.array([ratio ** 2 * 1e-4, 1e-4, 3e-5, 1e-5, 2e-5, 4e-5, 6e-5])
    assert (tlevel.update_e2(1.2, kkt, True)
            == jlevel.update_e2(1.2, kkt, True))
    jl, r0, r1, jw = _weighted_level()
    tl = tlevel.initialize(r0, r1, 7, dtype=F64, device="cpu",
                           weight=_tweight(jw))
    jlevel.initial_scaling(jl, True, kkt, 1.3)
    tlevel.initial_scaling(tl, True, kkt, 1.3)
    for k in ("D", "E", "cScale", "dScale", "E2", "norm_c", "norm_d"):
        assert getattr(tl, k) == getattr(jl, k), k
    close(tl.c, jl.c)
    close(tl.phi, jl.phi)


def test_weight_to_internal_and_weighted_diagonal_match():
    _, _, _, jw = _weighted_level()
    g = Geometry(7, (17, 17))
    jops = JOpsFlat(JGeometry(7, (17, 17)), jnp.float64)
    tops = OpsFlat(g, F64, "cpu")
    tw = tops.weight_to_internal(_tweight(jw))
    want = jops.weight_to_internal(jw)
    equal_stag(tw, want)
    assert torch.all(tw.bs * (1.0 - tops.masks) == 1.0 - tops.masks)
    close_stag(tops.oper_q_diag(0.27, 0.19, tw),
               jops.oper_q_diag(0.27, 0.19, want))
    dinv = fs.weighted_dinv(tops, tw, 0.27, 0.19)
    close_stag(dinv.inv, jax.tree.map(lambda v: 1.0 / v,
                                      jops.oper_q_diag(0.27, 0.19, want)))


def test_weighted_jump_and_recovery_match():
    jl, _, _, _ = _weighted_level(n=9, nt=5)
    rng = np.random.default_rng(7)
    jl.phi = jnp.asarray(rng.standard_normal(jl.geom.phi_shape))
    jl.beta = jnp.asarray(rng.standard_normal(jl.geom.z_shape))
    jb, tb = _barriers("love-heart")
    r0, r1 = JW.get_example_w2d("love-heart", 17, 17)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jwf = JW.get_weight_by_barrier(17, 17, 9, jb, dtype=jnp.float64)
    jf = jsolve._jump_next_level(jl, r0, r1, 9, jnp.float64, jwf)
    tv = level_var_from_numpy(jax.device_get(jl.as_dict()), jl.rho0, jl.rho1,
                              device="cpu", dtype=F64, weight=jl.weight)
    tf = tsolve._jump_next_level(tv, torch.tensor(r0), torch.tensor(r1), 9,
                                 F64, _tweight(jwf))
    for k in ("q", "alpha"):
        close_stag(getattr(tf, k), getattr(jf, k), rtol=1e-12, atol=1e-12)
    jf.alpha = jax.tree.map(
        lambda x: jnp.asarray(1.0 + 0.01 * rng.standard_normal(x.shape)),
        jf.alpha)
    tf.alpha = weight_from_numpy(jax.device_get(jf.alpha), device="cpu",
                                 dtype=F64)
    want = jlevel.recover_solution(jf)
    got = tlevel.recover_solution(tf)
    close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        close(a, b)
    assert got[4] == want[4]


# -- kernels: steps, the CA segment, the KKT battery ----------------------------

def _pair(cls_j=InPALMKernels, cls_t=Kernels, tau=TAU, steps=4, **kw):
    """One weighted level's kernels in both packages and the JAX state
    after ``steps`` plain iterations, converted to the port."""
    lv, _, _, jw = _weighted_level()
    jlevel.initial_scaling(lv, scaling=True)
    jk = cls_j(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=tau,
                            weighted=True, check_prim_dual_feas=False,
                            dtype=jnp.float64, layout="flat"), jw, **kw)
    tk = cls_t(LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space), D=lv.D,
                           E=lv.E, tau=tau, dtype=F64, device="cpu"),
               _tweight(jw), **kw)
    js = jk.run_segment(jk.prep(lv.as_dict(), sigma=0.8), steps)
    return jk, js, tk, lv, jw


def _fields(state):
    return jax.device_get(state._asdict())


def _assert_state_close(got: dict, want: dict):
    for k in ("phi", "z", "beta", "c"):
        close(got[k], want[k])
    for k in ("q", "alpha"):
        close(got[k][0], want[k][0])
        for a, b in zip(got[k][1], want[k][1]):
            close(a, b)


def test_weighted_prep_and_plain_steps_match_f64():
    jk, _, tk, lv, jw = _pair(steps=0)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F64, weight=jw)
    js = jk.prep(lv.as_dict(), sigma=0.8)
    ts = tk.prep(tv.as_dict(), 0.8)
    _assert_state_close(state_to_numpy(ts), _fields(js))
    for _ in range(5):
        js = jk.run_one(js)
        ts = tk._step_plain(ts)
    _assert_state_close(state_to_numpy(ts), _fields(js))


@pytest.mark.parametrize("k", [1, 4])
def test_weighted_ca_segment_matches_jax_f64(k):
    """The port's CA segment (x carried in the z slot, the weighted q-step)
    against k JAX weighted steps from the same state."""
    jk, js, tk, _, _ = _pair(steps=2)
    ts = state_from_numpy(_fields(js), device="cpu", dtype=F64)
    want = _fields(jk.run_segment(js, k))
    assert tk.segment_ca
    _assert_state_close(state_to_numpy(tk.run_segment(ts, k)), want)


def test_weighted_kkt_battery_matches():
    jk, js, tk, _, _ = _pair()
    ts = state_from_numpy(_fields(js), device="cpu", dtype=F64)
    want = jax.device_get(jk.kkt(js))
    got = tk.kkt(ts)
    close(got["kkt_org"], want["kkt_org"], rtol=1e-10, atol=1e-14)
    close(got["kkt"], want["kkt"], rtol=1e-10, atol=1e-14)
    for k in ("priVal", "dualVal", "pdGap", "normQ", "normZ", "normAlpha",
              "normBeta", "normAphi"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)


@pytest.mark.parametrize("restart", [100, 4])
def test_weighted_acc_admm_steps_match(restart):
    """One weighted acc-ADMM step, and one Halpern averaging at k = 3 (with
    restart = 4 it restarts the anchor)."""
    jk, js, tk, _, _ = _pair(JAccADMMKernels, AccADMMKernels, tau=1.0,
                             restart=restart)
    te = acc_state_from_numpy(_fields(js), device="cpu", dtype=F64)
    want = _fields(js._replace(s=jax.jit(jk._step)(js.s)).s)
    _assert_state_close(state_to_numpy(tk._step(te.s)), want)
    want = jax.device_get(jax.jit(jk._halpern)(js))
    got = tk._halpern(te)
    _assert_state_close(state_to_numpy(got.s), want.s._asdict())
    assert got.k == int(want.k) == (0 if restart == 4 else 4)


# -- the plain weighted q-step against the Pallas kernel -------------------------

@pytest.fixture
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _seeded_weight_1d(rng, nt, n):
    """Weights in [0.5, 2] with about one face in eight at the wall
    weight; the time block seeded too, so the kernel's w0 is exercised."""
    q0 = rng.uniform(0.5, 2.0, (nt - 1, n))
    b = rng.uniform(0.5, 2.0, (nt, n - 1))
    b[rng.random(b.shape) < 0.125] = TW.BARRIER_WEIGHT
    return JStaggered(q0=jnp.asarray(q0, jnp.float32),
                      bs=(jnp.asarray(b, jnp.float32),))


@pytest.mark.parametrize("name", ["2d", "1d"])
def test_weighted_qx_matches_pallas(_interpret_mode, name):
    rng = np.random.default_rng(11)
    if name == "2d":
        nt, space = 7, (17, 17)
        jw = JW.get_weight_by_barrier(17, 17, nt, JW.barrier_love_heart(),
                                      dtype=jnp.float32)
    else:
        nt, space = 7, (33,)
        jw = _seeded_weight_1d(rng, nt, 33)
    jgeom, g = JGeometry(nt, space), Geometry(nt, space)
    jops, tops = JOpsFlat(jgeom, jnp.float32), OpsFlat(g, F32, "cpu")
    jwi = jops.weight_to_internal(jw)
    assert float(jnp.max(jwi.bs[0])) == TW.BARRIER_WEIGHT
    kern = make_fused_flat_step(jgeom, jops.strides, jops.masks, TAU,
                                jnp.float32, interpret=True, weight=jwi)
    S, C = tops.S, g.cone_cols
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    phi, x = f32(nt, S), f32(C, nt - 1, S)
    a0 = f32(nt - 1, S)
    ab = f32(g.ndim_space, nt, S) * tops.masks.numpy()
    D, E = 0.2690, 0.1902
    jdinv = jax.tree.map(lambda v: 1.0 / v, jops.oper_q_diag(D, E, jwi))
    q0n, bns, a0n, abns = kern["qx_step"](
        jnp.asarray(phi), jnp.asarray(x), jnp.asarray(a0), list(ab),
        jdinv.q0, list(jdinv.bs), jnp.float32(D), jnp.float32(E / D),
        jnp.float32(TAU))
    tw = tops.weight_to_internal(weight_from_numpy(jax.device_get(jw),
                                                   device="cpu", dtype=F32))
    before = dict(fs.LAUNCHES)
    q, alpha = fs.qx_step(tops, torch.tensor(phi), torch.tensor(x),
                          Staggered(torch.tensor(a0), torch.tensor(ab)),
                          fs.weighted_dinv(tops, tw, D, E), D, E / D, TAU)
    assert fs.LAUNCHES == before  # CPU tensors take the plain version
    rtol, atol = 2e-5, 2e-6
    # the wall faces' atol for alpha' (see the module docstring)
    tmp = D * OpsFlat(g, F64, "cpu").grad(torch.tensor(phi, dtype=F64))
    scale = 4 * TAU * float(np.finfo(np.float32).eps)

    def alpha_atol(tmp_block, a_block, w_block):
        wall = _np(w_block) > 1e5
        cancel = np.abs(_np(tmp_block)) + np.abs(a_block)
        return np.where(wall, atol + scale * cancel, atol)

    close(q.q0, q0n, rtol=rtol, atol=atol)
    for got, want, t_b, a_b, w_b in (
            [(alpha.q0, a0n, tmp.q0, a0, tw.q0)]
            + [(alpha.bs[a], abns[a], tmp.bs[a], ab[a], tw.bs[a])
               for a in range(g.ndim_space)]):
        err = np.abs(_np(got) - np.asarray(want))
        bound = alpha_atol(t_b, a_b, w_b) + rtol * np.abs(np.asarray(want))
        assert np.all(err <= bound), float((err - bound).max())
    for a in range(g.ndim_space):
        close(q.bs[a], bns[a], rtol=rtol, atol=atol)
        # the ghost slots stay exactly zero, though w is 1 there
        assert torch.all(q.bs[a] * (1.0 - tops.masks[a]) == 0.0)
        assert torch.all(alpha.bs[a] * (1.0 - tops.masks[a]) == 0.0)


# -- solve_dot end to end ----------------------------------------------------------

def _solve_pair(method, n, nt, levels, barrier, problem, opts):
    jb, tb = _barriers(barrier)
    r0, r1 = JW.get_example_w2d(problem, n, n)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jw = JW.get_weight_by_barrier(n, n, nt, jb, dtype=jnp.float64)
    jout, jh, _ = jsolve.solve_dot(
        r0, r1, nt, levels,
        dict(opts, driver="host", layout="flat", use_pallas=False,
             reuse_solvers=False),
        method, weight=jw, barrier=jb, dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(r0, r1, nt, levels,
                                   dict(opts, driver="host"), method,
                                   _tweight(jw), tb, device="cpu", dtype=F64,
                                   verbose=False)
    return jout, jh, tout, th


@pytest.mark.parametrize("method,n,nt,levels,barrier,problem", [
    ("inPALM", 33, 17, 2, "love-heart", "love-heart"),
    ("ALG2", 33, 9, 1, "circle-pillar", "circle2"),
    ("acc-ADMM", 33, 9, 1, "love-heart", "love-heart"),
])
def test_weighted_solve_matches_jax(method, n, nt, levels, barrier, problem):
    jout, jh, tout, th = _solve_pair(method, n, nt, levels, barrier, problem,
                                     {"tol": 1e-3})
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    assert ([lv["method"] for lv in tout["levels"]]
            == [lv["method"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    close(th["kkt"], jh["kkt"], rtol=1e-7, atol=1e-10)
    close(th["pdGap"], jh["pdGap"], rtol=1e-7, atol=1e-12)
    close(tout["rho"], jout["rho"], rtol=1e-7, atol=1e-12)
    assert tout["mass_ok"] and jout["mass_ok"]
    # weighted problems stop on residuals 1, 3, 6 (checkPrimDualFeas off)
    assert max(th["kkt"][-1][[0, 2, 5]]) < 1e-3
