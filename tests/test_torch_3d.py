"""The 3D path of the PyTorch port (C = 14 cone columns, three face blocks,
a four-axis DCT) against the JAX package on the CPU.

- The 3D example generators, equal to the JAX package's.
- ``OpsFlat`` op by op against the JAX flat engine in float64 at nt 5,
  space (5, 7, 9): a different size on every axis, so a swapped stride,
  size or spacing shows. rtol 1e-12 with an absolute floor of 1e-12 times
  the largest magnitude (the DCT sums in another order); the transfers,
  the level jump and the recovery alike.
- The plain versions of the DIM = 3 step kernels in float32 against the
  Pallas kernels of ``make_fused_flat_step`` (d = 3) in interpret mode, on
  seeded inputs at the same grid: rtol 2e-5 / atol 2e-6, as
  ``tests/test_torch_fused_step.py`` holds them in 1D and 2D. The weighted
  q-steps take seeded weights with about one face in eight at the 1e6 wall
  weight; alpha' on wall faces gets the atol of
  ``tests/test_torch_weighted.py`` (2e-6 + 4 tau eps32 (|D grad phi| +
  |alpha|)), where w q' cancels D grad phi + alpha. The plain sweep against
  ``make_sgs_sweep_pallas`` in 3D, atol 1e-5 as in 2D.
- The flat shift (TPU kernel 3, ``ops/shift.py``): its plain version
  bit-equal to ``make_pallas_shift`` in interpret mode, and to the JAX
  ``_flat_sfwd`` / ``_flat_sbwd`` at strides above the Pallas tile.
- Plain steps, the CA segment and the KKT battery against the JAX jnp path
  in float64 (rtol 1e-12 with the floor above; the KKT battery 1e-10).
- ``solve_dot`` against the JAX host driver in float64 on gaussian 9^3 x 5,
  2 levels, with inPALM, sGS-inPALM and acc-ADMM: the same iteration count
  on every level and the same check schedule, KKT histories within rtol
  1e-7 / atol 1e-12, equal rho and E.
- The output keys (``Ex`` only in 1D), ``utils/objective.py`` against the
  JAX copy, and ``profile_phases``' bytes in 3D.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.algorithms.variants import InPALMKernels
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.multilevel import solve as jsolve
from dotsocp_tpu.multilevel import transfer as jtransfer
from dotsocp_tpu.ops import sgs as jsgs
from dotsocp_tpu.ops.engine import OpsFlat as JOpsFlat
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.pallas_kernels import (_flat_sbwd, _flat_sfwd,
                                            make_fused_flat_step,
                                            make_pallas_shift,
                                            make_sgs_sweep_pallas)
from dotsocp_tpu.ops.staggered import Staggered as JStaggered
from dotsocp_tpu.utils import objective as jobjective

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.models import examples as texamples
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.multilevel import transfer as ttransfer
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops import shift
from dotsocp_tpu_torch.ops import sgs as tsgs
from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.utils import objective as tobjective
from dotsocp_tpu_torch.utils.interop import (level_var_from_numpy,
                                             state_from_numpy, state_to_numpy,
                                             weight_from_numpy)
from dotsocp_tpu_torch.utils.profiling import profile_phases

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
NT, SPACE = 5, (5, 7, 9)
TAU = 1.9
# level scalars of the kernel checks (tests/test_torch_fused_step.py)
D, E, DSCALE = 0.2690, 0.1902, 0.2690
RTOL, ATOL = 2e-5, 2e-6
WALL = 1e6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=1e-12, atol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if atol is None:
        atol = 1e-12 * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def close_stag(got, want, **kw):
    close(got.q0, want.q0, **kw)
    assert len(got.bs) == len(want.bs)
    for a, b in zip(got.bs, want.bs):
        close(a, b, **kw)


def _t(a, dtype=F64):
    return torch.tensor(np.array(a), dtype=dtype)


def _tstag(st, dtype=F64):
    """A port flat Staggered from a JAX flat one."""
    return Staggered(_t(st.q0, dtype), torch.stack([_t(b, dtype)
                                                    for b in st.bs]))


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# -- the problem generators ------------------------------------------------------

@pytest.mark.parametrize("problem", ["gaussian", "split8"])
def test_examples_3d_match(problem):
    for sizes in ((9, 9, 9), (9, 7, 5)):
        for a, b in zip(texamples.get_example_3d(problem, *sizes, 0.1),
                        jexamples.get_example_3d(problem, *sizes, 0.1)):
            np.testing.assert_array_equal(a, b)
            assert a.shape == sizes[::-1]
    with pytest.raises(ValueError, match="unknown 3D problem"):
        texamples.get_example_3d("example2", 5, 5, 5)


# -- the flat engine in float64 ----------------------------------------------------

class Case3D:
    """Seeded float64 inputs at nt 5, space (5, 7, 9) in both packages'
    flat layouts; face blocks with exactly-zero ghost slots."""

    def __init__(self, seed=0):
        self.geom = Geometry(NT, SPACE)
        g = self.geom
        self.jops = JOpsFlat(JGeometry(NT, SPACE), jnp.float64)
        self.tops = OpsFlat(g, F64, "cpu")
        rng = np.random.default_rng(seed)
        S = self.tops.S
        self.phi = rng.standard_normal((g.nt, S))
        self.z = rng.standard_normal((g.cone_cols, g.nt - 1, S))
        shaped = JStaggered(
            q0=jnp.asarray(rng.standard_normal(g.q0_shape)),
            bs=tuple(jnp.asarray(rng.standard_normal(g.b_shape(a)))
                     for a in range(3)))
        self.shaped = shaped
        self.jq = self.jops.stag_to_internal(shaped)
        self.tq = _tstag(self.jq)


OPS = ["shifts", "grad", "grad_T", "bfd", "bfd_T", "oper_q_diag", "poisson"]


@pytest.mark.parametrize("op", OPS)
def test_ops_flat_3d_match_jax(op):
    c = Case3D()
    t, j = c.tops, c.jops
    assert c.geom.cone_cols == 14 and t.strides == (63, 9, 1)
    if op == "shifts":
        assert t.strides == j.strides
        for a in range(3):
            close(t._sfwd(_t(c.phi), a), j._sfwd(c.phi, a))
            close(t._sbwd(_t(c.phi), a), j._sbwd(c.phi, a))
            close(t.masks[a, 0], j.masks[a])
    elif op == "grad":
        got = t.grad(_t(c.phi))
        close_stag(got, j.grad(jnp.asarray(c.phi)))
        assert torch.all(got.bs * (1.0 - t.masks) == 0.0)
    elif op == "grad_T":
        close(t.grad_T(c.tq), j.grad_T(c.jq))
    elif op == "bfd":
        close(t.bfd(c.tq, 0.7, 1.3), j.bfd(c.jq, 0.7, 1.3))
    elif op == "bfd_T":
        got = t.bfd_T(_t(c.z), 0.7)
        close_stag(got, j.bfd_T(jnp.asarray(c.z), 0.7))
        assert torch.all(got.bs * (1.0 - t.masks) == 0.0)
        # the adjoint of bfd on the flat layout
        lhs = torch.sum(t.bfd(c.tq, 0.7, 0.0) * _t(c.z))
        np.testing.assert_allclose(float(lhs), float(c.tq.dot(got)),
                                   rtol=1e-12)
    elif op == "oper_q_diag":
        close_stag(t.oper_q_diag(0.5, 0.3), j.oper_q_diag(0.5, 0.3, None))
    else:
        rhs = np.random.default_rng(4).standard_normal(c.geom.phi_shape)
        scale = 1.0 / (0.37 * 0.37)
        got = t.make_poisson(1.0).solve(t.phi_to_internal(_t(rhs)),
                                        scale=scale)
        want = j.make_poisson(1.0).solve(j.phi_to_internal(jnp.asarray(rhs)),
                                         scale=scale)
        close(got, want)


def test_transfers_and_layout_3d_match_jax():
    c = Case3D(seed=1)
    rng = np.random.default_rng(10)
    rho = rng.random(SPACE) + 0.5
    close(ttransfer.restrict_density(_t(rho)),
          jtransfer.restrict_density(jnp.asarray(rho)))
    phi = rng.standard_normal((3,) + SPACE)
    close(ttransfer.prolong_phi(_t(phi)), jtransfer.prolong_phi(jnp.asarray(phi)))
    z = rng.standard_normal((14, 2) + SPACE)
    close(ttransfer.prolong_z_like(_t(z)),
          jtransfer.prolong_z_like(jnp.asarray(z)))
    ts = Staggered(_t(c.shaped.q0), tuple(_t(b) for b in c.shaped.bs))
    internal = c.tops.stag_to_internal(ts)
    close_stag(internal, c.jq)
    close_stag(c.tops.stag_from_internal(internal),
               c.jops.stag_from_internal(c.jq))
    close(c.tops.z_from_internal(_t(c.z)), c.jops.z_from_internal(c.z))


# -- the plain DIM = 3 kernels against the Pallas kernels, float32 ----------------

KERNELS = ["x_step", "qx_step", "qx_step_w", "cx_step", "cx_final", "z_step",
           "q_step", "q_step_w", "beta_step"]


def _weight_3d(rng, g: Geometry) -> JStaggered:
    """Weights in [0.5, 2], about one face in eight at the wall weight,
    the time block seeded too (the JAX package has no 3D weight model)."""
    def block(shape, walls):
        b = rng.uniform(0.5, 2.0, shape)
        if walls:
            b[rng.random(shape) < 0.125] = WALL
        return jnp.asarray(b, jnp.float32)

    return JStaggered(q0=block(g.q0_shape, False),
                      bs=tuple(block(g.b_shape(a), True) for a in range(3)))


@pytest.mark.parametrize("name", KERNELS)
def test_plain_kernels_3d_match_pallas(interpret_mode, name):
    rng = np.random.default_rng(KERNELS.index(name))
    g, jg = Geometry(NT, SPACE), JGeometry(NT, SPACE)
    jops, tops = JOpsFlat(jg, jnp.float32), OpsFlat(g, F32, "cpu")
    S, C = tops.S, g.cone_cols
    weighted = name.endswith("_w")
    jw = _weight_3d(rng, g) if weighted else None
    jwi = jops.weight_to_internal(jw) if weighted else None
    kern = make_fused_flat_step(jg, jops.strides, jops.masks, TAU,
                                jnp.float32, interpret=True, weight=jwi)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    phi, x, beta = f32(NT, S), f32(C, NT - 1, S), f32(C, NT - 1, S)
    masks = tops.masks.numpy()
    q0, bs = f32(NT - 1, S), f32(3, NT, S) * masks
    a0, ab = f32(NT - 1, S), f32(3, NT, S) * masks
    tq = Staggered(torch.tensor(q0), torch.tensor(bs))
    ta = Staggered(torch.tensor(a0), torch.tensor(ab))
    sbf, sd = E / D, E / DSCALE
    J = jnp.asarray
    before = dict(fs.LAUNCHES)
    if name in ("x_step", "z_step"):
        want = kern[name](J(q0), list(bs), J(beta), sbf, sd)
        fn = fs.x_step if name == "x_step" else fs.z_step
        close(fn(tops, tq, torch.tensor(beta), sbf, sd), want, RTOL, ATOL)
    elif name in ("cx_step", "cx_final"):
        want = kern[name](J(beta), J(x), J(q0), list(bs), jnp.float32(sbf),
                          jnp.float32(sd), jnp.float32(TAU))
        fn = fs.cx_step if name == "cx_step" else fs.cx_final
        got = fn(tops, torch.tensor(beta), torch.tensor(x), tq, sbf, sd, TAU)
        close(got[0], want[0], RTOL, ATOL)
        close(got[1], want[1], RTOL, ATOL)
    elif name == "beta_step":
        want = kern[name](J(beta), J(x), J(q0), list(bs), jnp.float32(sbf),
                          jnp.float32(sd), jnp.float32(TAU))
        close(fs.beta_step(tops, torch.tensor(beta), torch.tensor(x), tq, sbf,
                           sd, TAU), want, RTOL, ATOL)
    else:
        if weighted:
            jdinv = jax.tree.map(lambda v: 1.0 / v,
                                 jops.oper_q_diag(D, E, jwi))
            tw = tops.weight_to_internal(weight_from_numpy(
                jax.device_get(jw), device="cpu", dtype=F32))
            tdinv = fs.weighted_dinv(tops, tw, D, E)
        else:
            jdinv = jax.tree.map(lambda v: 1.0 / v,
                                 jops.oper_q_diag(D, E, None))
            d_in, d_bd = diag_values(D, E)
            tdinv = (1.0 / d_in, 1.0 / d_bd)
        scalars = (jdinv.q0, list(jdinv.bs), jnp.float32(D),
                   jnp.float32(sbf), jnp.float32(TAU))
        if name.startswith("qx"):
            q0n, bns, a0n, abns = kern["qx_step"](J(phi), J(x), J(a0),
                                                  list(ab), *scalars)
            q, a = fs.qx_step(tops, torch.tensor(phi), torch.tensor(x), ta,
                              tdinv, D, sbf, TAU)
        else:
            q0n, bns, a0n, abns = kern["q_step"](J(phi), J(x), J(beta),
                                                 J(a0), list(ab), *scalars)
            q, a = fs.q_step(tops, torch.tensor(phi), torch.tensor(x),
                             torch.tensor(beta), ta, tdinv, D, sbf, TAU)
        close(q.q0, q0n, RTOL, ATOL)
        tmp = D * OpsFlat(g, F64, "cpu").grad(torch.tensor(phi, dtype=F64))
        scale = 4 * TAU * float(np.finfo(np.float32).eps)
        w = tdinv.w if weighted else Staggered(torch.ones(NT - 1, S),
                                               torch.ones(3, NT, S))
        for got, want, t_b, a_b, w_b in (
                [(a.q0, a0n, tmp.q0, a0, w.q0)]
                + [(a.bs[ax], abns[ax], tmp.bs[ax], ab[ax], w.bs[ax])
                   for ax in range(3)]):
            wall = _np(w_b) > 1e5
            bound = (np.where(wall, ATOL + scale * (np.abs(_np(t_b))
                                                    + np.abs(a_b)), ATOL)
                     + RTOL * np.abs(np.asarray(want)))
            err = np.abs(_np(got) - np.asarray(want))
            assert np.all(err <= bound), float((err - bound).max())
        for ax in range(3):
            close(q.bs[ax], bns[ax], RTOL, ATOL)
            # the ghost slots of every face axis stay exactly zero
            assert torch.all(q.bs[ax] * (1.0 - tops.masks[ax]) == 0.0)
        if weighted:
            assert int((_np(tw.bs) == WALL).sum()) > 0
    assert fs.LAUNCHES == before  # CPU tensors take the plain version


def test_plain_sweep_3d_matches_pallas(interpret_mode):
    """TPU kernel 1 (``make_sgs_sweep_pallas``, whole field) in 3D, two
    chained sweeps at 5 x (5, 7, 9)."""
    D_ = 0.8
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((NT,) + SPACE).astype(np.float32)
    rhs = rng.standard_normal((NT,) + SPACE).astype(np.float32)
    jg = JGeometry(NT, SPACE)
    pal = make_sgs_sweep_pallas(jg, D_, jnp.float32)
    base = jsgs.make_sgs(jg, D_, dtype=jnp.float32)
    want = jnp.asarray(phi)
    for _ in range(2):
        want = pal(want, jnp.asarray(rhs), base.inv_diag)
    sgs = tsgs.make_sgs(Geometry(NT, SPACE), dtype=F32)
    got = sgs.sweep(torch.from_numpy(phi), torch.from_numpy(rhs), 2,
                    d2=D_ * D_)
    close(got, want, rtol=0.0, atol=1e-5)


# -- the flat shift (TPU kernel 3) ------------------------------------------------

@pytest.mark.parametrize("forward", [True, False], ids=["sfwd", "sbwd"])
def test_flat_shift_matches_pallas(interpret_mode, forward):
    """The plain version bit-equal to ``make_pallas_shift`` in interpret
    mode (as ``tests/test_pallas.py:248-271`` runs it), on an (R, S) field
    and a plane of a cone array; and to the JAX pad-and-slice shift at
    strides above the Pallas tile, which the Pallas kernel refuses: the
    z stride of a 3D grid (33^2 = 1089 at 33^3) among them."""
    rng = np.random.default_rng(3)
    R, S = 9, 1500
    x2 = rng.standard_normal((R, S)).astype(np.float32)
    cone = rng.standard_normal((6, R, S)).astype(np.float32)
    ref = _flat_sfwd if forward else _flat_sbwd
    before = dict(shift.LAUNCHES)
    for k, ts in ((1, 512), (37, 512), (510, 512), (513, 1024)):
        fn = make_pallas_shift(R, S, k, forward, jnp.float32, interpret=True,
                               ts=ts)
        np.testing.assert_array_equal(
            shift.flat_shift(torch.from_numpy(x2), k, forward).numpy(),
            np.asarray(fn(jnp.asarray(x2))))
        np.testing.assert_array_equal(
            shift.flat_shift(torch.from_numpy(cone), k, forward,
                             plane=4).numpy(),
            np.asarray(fn(jnp.asarray(cone), plane=4)))
    for k in (600, 1089, S - 1, S):
        assert make_pallas_shift(R, S, k, forward, jnp.float32,
                                 interpret=True, ts=512) is None
        np.testing.assert_array_equal(
            shift.flat_shift(torch.from_numpy(x2), k, forward).numpy(),
            np.asarray(ref(jnp.asarray(x2), k, S)))
    # the plain version is the engine's shift along an axis of a 3D grid
    ops = OpsFlat(Geometry(3, (33, 33, 33)), F32, "cpu")
    field = torch.from_numpy(rng.standard_normal((2, ops.S)).astype(
        np.float32))
    for a in range(3):
        want = ops._sfwd(field, a) if forward else ops._sbwd(field, a)
        assert torch.equal(shift.flat_shift(field, ops.strides[a], forward),
                           want)
    assert shift.LAUNCHES == before
    with pytest.raises(ValueError, match="k = -1"):
        shift.flat_shift(field, -1, forward)


# -- steps, CA segment and KKT battery against the JAX jnp path -------------------

def _jax_level(dtype, n=9, nt=5, problem="gaussian"):
    r0, r1 = jexamples.get_example_3d(problem, n, n, n)
    lv = jlevel.initialize(r0, r1, nt, dtype=dtype)
    jlevel.initial_scaling(lv, scaling=True)
    return lv, r0, r1


def _kernels_pair(lv, dtype):
    jk = InPALMKernels(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=TAU,
                                    dtype=dtype, layout="flat"))
    tk = Kernels(LevelConfig(geom=Geometry(lv.geom.nt, lv.geom.space),
                             D=lv.D, E=lv.E, tau=TAU,
                             dtype=F64 if dtype == jnp.float64 else F32,
                             device="cpu"))
    return jk, tk


def _fields(state):
    return jax.device_get(state._asdict())


def _assert_state_close(got: dict, want: dict, **kw):
    for k in ("phi", "z", "beta", "c"):
        close(got[k], want[k], **kw)
    for k in ("q", "alpha"):
        close(got[k][0], want[k][0], **kw)
        for a, b in zip(got[k][1], want[k][1]):
            close(a, b, **kw)


def test_level_steps_and_kkt_3d_match_jax_f64():
    """initialize and InitialScaling, the prep, three plain steps, a
    4-iteration CA segment (which equals 4 plain steps) and the KKT battery
    against the JAX jnp path, 9^3 x 5 gaussian."""
    lv, r0, r1 = _jax_level(jnp.float64)
    tl = tlevel.initialize(r0, r1, 5, dtype=F64, device="cpu")
    tlevel.initial_scaling(tl, True)
    for k in ("D", "E", "cScale", "dScale", "E2", "norm_c", "norm_d"):
        np.testing.assert_allclose(getattr(tl, k), getattr(lv, k),
                                   rtol=1e-14, err_msg=k)
    close(tl.phi, lv.phi)
    jk, tk = _kernels_pair(lv, jnp.float64)
    js = jk.prep(lv.as_dict(), sigma=0.8)
    ts = tk.prep(tl.as_dict(), 0.8)
    _assert_state_close(state_to_numpy(ts), _fields(js))
    for _ in range(3):
        js = jk.run_one(js)
        ts = tk._step_plain(ts)
    _assert_state_close(state_to_numpy(ts), _fields(js))
    # the CA structure (x carried in the z slot) against 4 plain steps
    plain = ts.clone()
    for _ in range(4):
        plain = tk._step_plain(plain)
    seg = tk.run_segment(ts.clone(), 4)
    _assert_state_close(state_to_numpy(seg), state_to_numpy(plain))
    want = jax.device_get(jk.kkt(js))
    got = tk.kkt(state_from_numpy(_fields(js), device="cpu", dtype=F64))
    close(got["kkt_org"], want["kkt_org"], rtol=1e-10, atol=1e-14)
    close(got["kkt"], want["kkt"], rtol=1e-10, atol=1e-14)
    for k in ("priVal", "dualVal", "pdGap", "normPhi", "normQ", "normZ",
              "normAlpha", "normBeta", "normAphi"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)


def test_jump_and_recovery_3d_match_jax():
    lv, _, _ = _jax_level(jnp.float64, n=5, nt=3)
    rng = np.random.default_rng(7)
    lv.phi = jnp.asarray(rng.standard_normal(lv.geom.phi_shape))
    lv.beta = jnp.asarray(rng.standard_normal(lv.geom.z_shape))
    r0, r1 = jexamples.get_example_3d("gaussian", 9, 9, 9)
    jf = jsolve._jump_next_level(lv, r0, r1, 5, jnp.float64)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F64)
    tf = tsolve._jump_next_level(tv, torch.tensor(r0), torch.tensor(r1), 5,
                                 F64)
    for k in ("phi", "beta", "c", "z"):
        close(getattr(tf, k), getattr(jf, k), rtol=1e-13,
              atol=1e-13 * float(np.abs(getattr(jf, k)).max() or 1.0))
    for k in ("q", "alpha"):
        close_stag(getattr(tf, k), getattr(jf, k), rtol=1e-13, atol=1e-12)
    # recovery on the fine level, alpha perturbed off its warm start
    jf.alpha = jax.tree.map(
        lambda x: jnp.asarray(1.0 + 0.01 * rng.standard_normal(x.shape)),
        jf.alpha)
    want = jlevel.recover_solution(jf)
    tf = level_var_from_numpy(jax.device_get(jf.as_dict()), jf.rho0, jf.rho1,
                              device="cpu", dtype=F64)
    got = tlevel.recover_solution(tf)
    close(got[0], want[0])
    for i in (1, 3):
        assert len(got[i]) == len(want[i]) == 3
        for a, b in zip(got[i], want[i]):
            close(a, b)
    close(got[2], want[2])
    assert got[4] == want[4]


# -- solve_dot end to end ---------------------------------------------------------

@pytest.mark.parametrize("method,iters", [
    ("inPALM", [489, 969]),
    ("sGS-inPALM", [569, 1491]),
    ("acc-ADMM", [689, 1049]),
])
def test_solve_dot_3d_matches_jax(method, iters):
    """gaussian 9^3 x 5, 2 levels, tol 1e-4, float64: the JAX host driver's
    iteration counts, check schedule, KKT history, rho and E."""
    r0, r1 = jexamples.get_example_3d("gaussian", 9, 9, 9)
    jout, jh, _ = jsolve.solve_dot(
        r0, r1, 5, 2, {"tol": 1e-4, "driver": "host", "layout": "flat",
                       "use_pallas": False, "reuse_solvers": False},
        method, dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(r0, r1, 5, 2,
                                   {"tol": 1e-4, "driver": "host"}, method,
                                   device="cpu", dtype=F64, verbose=False)
    assert [lv["iters"] for lv in jout["levels"]] == iters
    assert [lv["iters"] for lv in tout["levels"]] == iters
    assert ([lv["method"] for lv in tout["levels"]]
            == [lv["method"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    close(th["kkt"], jh["kkt"], rtol=1e-7, atol=1e-12)
    close(th["pdGap"], jh["pdGap"], rtol=1e-7, atol=1e-12)
    close(tout["rho"], jout["rho"], rtol=1e-7, atol=1e-12)
    assert len(tout["E"]) == len(jout["E"]) == 3
    for a, b in zip(tout["E"], jout["E"]):
        close(a, b, rtol=1e-7, atol=1e-9)
    assert tout["mass_ok"] and jout["mass_ok"]
    assert max(th["kkt"][-1][[0, 2, 5, 6]]) < 1e-4


@pytest.mark.parametrize("dim", [1, 3])
def test_output_keys(dim):
    """E and b list one entry per axis; Ex / bx only in 1D (2D adds Ey /
    by), as the JAX package: in 3D E[0] is the z momentum."""
    if dim == 1:
        r0, r1 = texamples.get_example_1d("gaussian", 17)
    else:
        r0, r1 = texamples.get_example_3d("gaussian", 5, 5, 5)
    out, _, _ = tsolve.solve_dot(r0, r1, 3, 1, {"tol": 1e-3, "maxit": 20},
                                 device="cpu", dtype=F64, verbose=False)
    assert len(out["E"]) == len(out["b"]) == dim
    if dim == 1:
        assert out["Ex"] is out["E"][0] and out["bx"] is out["b"][0]
    else:
        assert not {"Ex", "Ey", "bx", "by"} & set(out)
        assert tuple(out["rho"].shape) == (3, 5, 5, 5)


# -- the objective and the profiler in 3D -----------------------------------------

@pytest.mark.parametrize("staggered", [False, True],
                         ids=["same_grid", "staggered"])
def test_transport_cost_matches_jax(staggered):
    """On the fields of a 3D recovery, and on seeded fields with
    near-vacuum cells."""
    rng = np.random.default_rng(9 + staggered)
    rho = rng.random((5,) + SPACE) + 0.1
    rho[:, 0, 0, :] = 1e-9
    Es = [rng.standard_normal((4 if staggered else 5,) + SPACE)
          for _ in range(3)]
    want = jobjective.transport_cost(rho, Es)
    assert tobjective.transport_cost(torch.tensor(rho),
                                     [torch.tensor(E) for E in Es]) == want
    assert tobjective.transport_cost(rho, Es) == want
    args = ((0.3, 0.3, 0.3), (0.7, 0.7, 0.7), 0.12, 0.12)
    assert (tobjective.gaussian_w2_squared(*args)
            == jobjective.gaussian_w2_squared(*args))
    np.testing.assert_allclose(tobjective.gaussian_w2_squared(*args), 0.48,
                               rtol=1e-14)


def test_profile_phases_bytes_3d():
    """Each phase's GB/s is its counted bytes (the 3D blocks' sizes) over
    its time; all inPALM phases run on a 3D level."""
    lv, _, _ = _jax_level(jnp.float64, n=5, nt=3)
    tv = level_var_from_numpy(jax.device_get(lv.as_dict()), lv.rho0, lv.rho1,
                              device="cpu", dtype=F32)
    tk = Kernels(LevelConfig(geom=tv.geom, D=tv.D, E=tv.E, device="cpu",
                             dtype=F32))
    phases = profile_phases(tk, tk.prep(tv.as_dict(), 1.0), iters=2)
    assert set(phases) == {"phi_dct_solve", "cone_projection", "q_step",
                           "multiplier", "kkt_battery", "full_step_fused"}
    g = tv.geom
    S = int(np.prod(g.space))
    phi = 4 * g.nt * S
    q = 4 * ((g.nt - 1) * S + 3 * g.nt * S)
    z = 4 * 14 * (g.nt - 1) * S
    want = {"phi_dct_solve": 2 * q + 14 * phi, "cone_projection": 3 * z,
            "q_step": phi + 2 * z + 3 * q, "multiplier": phi + 3 * q + 4 * z}
    for name, nbytes in want.items():
        row = phases[name]
        np.testing.assert_allclose(row["gbps"] * 1e9 * row["ms"] * 1e-3,
                                   nbytes, rtol=1e-9)
