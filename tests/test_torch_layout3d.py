"""The port's shaped engine (``ops/engine.Ops3D``, ``ops/grad.py``, the
shaped operators of ``ops/cone.py``: the flat engine's oracle, which no
solver runs) against the JAX package's ``Ops3D``, and the port's flat
solver against the JAX package's ``"3d"`` layout, in float64 on the CPU.

- Each operator (``grad``, ``grad_T``, ``bfd``, ``bfd_T``, ``oper_q_diag``
  unweighted and weighted, ``face_interp``, ``t_node_interp``, the DCT
  solve) on seeded inputs in 1D, 2D and 3D within 1e-12 of JAX's; the
  adjoint identities <grad phi, q> = <phi, grad_T q> and <bfd q, z> =
  <q, bfd_T z> on the port's engine; the port's ``Ops3D`` against its
  ``OpsFlat`` after conversion within 1e-14; a stack of two instances on a
  leading axis bit-equal to each instance alone; the shaped
  ``staggered.zeros`` as the JAX package's; ``make_ops`` builds the flat
  engine, or the halo engine on a mesh, and takes no layout.
- The port's flat ``Kernels`` of every method class (inPALM, PALM,
  acc-ADMM, sGS-inPALM, acc-sGS-ADMM, weighted inPALM), started from the
  JAX "3d" state, take 12 iterations and stay within 1e-10 of the JAX
  kernels on "3d" (``tests/test_flat_layout.py:102-155``).
- ``solve_dot(layout="3d", device="cpu")`` warns and runs the flat engine,
  and takes the JAX ``solve_dot``'s per-level counts on "3d", each driver
  against its JAX counterpart: inPALM in 2D, 1D and 3D, sGS-inPALM,
  acc-ADMM and weighted inPALM. These are the proof that one process
  loses nothing by running "3d" as flat.
- ``solve_batch`` lockstep with "3d" (warned, flat) against the JAX
  ``solve_batch`` on "3d"; ``solve_batch`` and ``solve_fleet`` refuse "3d"
  on a spatial mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.algorithms import variants as jvariants
from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
from dotsocp_tpu.models import examples as jexamples
from dotsocp_tpu.models import wdot2d as jwdot2d
from dotsocp_tpu.multilevel import level as jlevel
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot
from dotsocp_tpu.ops import staggered as jstg
from dotsocp_tpu.ops.engine import Ops3D as JOps3D
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.staggered import Staggered as JStaggered
from dotsocp_tpu.parallel.batch import solve_batch as jsolve_batch

from dotsocp_tpu_torch.algorithms import variants as tvariants
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.ops import staggered as tstg
from dotsocp_tpu_torch.ops.engine import Ops3D, OpsFlat, make_ops
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.ops.halo_engine import OpsHalo
from dotsocp_tpu_torch.parallel import batch as tb
from dotsocp_tpu_torch.parallel.sharding import Mesh
from dotsocp_tpu_torch.utils.interop import (acc_state_from_numpy,
                                             state_from_numpy,
                                             weight_from_numpy)

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-12
SPACES = {"1d": (9,), "2d": (7, 9), "3d": (5, 6, 7)}
NT = 6
OPS = ["grad", "grad_T", "bfd", "bfd_T", "oper_q_diag", "oper_q_diag_w",
       "face_interp", "t_node_interp", "poisson"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=F64)


def _np(x) -> list:
    """The blocks of a result as numpy arrays."""
    if isinstance(x, (Staggered, JStaggered)):
        return [np.asarray(b) for b in [x.q0] + list(x.bs)]
    if isinstance(x, (list, tuple)):
        return [np.asarray(b) for b in x]
    return [np.asarray(x)]


class Case:
    """Seeded inputs of one grid, as numpy, and both engines."""

    def __init__(self, space, seed=0):
        self.geom = Geometry(NT, space)
        self.jgeom = JGeometry(NT, space)
        g = self.geom
        rng = np.random.default_rng(seed)
        d = g.ndim_space
        self.phi = rng.standard_normal(g.phi_shape)
        self.q0 = rng.standard_normal(g.q0_shape)
        self.bs = [rng.standard_normal(g.b_shape(a)) for a in range(d)]
        self.z = rng.standard_normal(g.z_shape)
        self.w0 = rng.uniform(0.5, 2.0, g.q0_shape)
        self.wbs = [rng.uniform(0.5, 2.0, g.b_shape(a)) for a in range(d)]
        self.ops = Ops3D(g, F64, "cpu")
        self.jops = JOps3D(self.jgeom, jnp.float64)

    def stag(self, q0=None, bs=None) -> Staggered:
        return Staggered(_t(self.q0 if q0 is None else q0),
                         tuple(_t(b) for b in (self.bs if bs is None
                                               else bs)))

    def jstag(self, q0=None, bs=None) -> JStaggered:
        return JStaggered(jnp.asarray(self.q0 if q0 is None else q0),
                          tuple(jnp.asarray(b) for b in (self.bs if bs is None
                                                         else bs)))

    def run(self, op, port: bool):
        """Operator ``op`` on the port's engine or on JAX's."""
        o = self.ops if port else self.jops
        arr = _t if port else jnp.asarray
        st = self.stag() if port else self.jstag()
        if op == "grad":
            return o.grad(arr(self.phi))
        if op == "grad_T":
            return o.grad_T(st)
        if op == "bfd":
            return o.bfd(st, 0.7, 1.3)
        if op == "bfd_T":
            return o.bfd_T(arr(self.z), 0.7)
        if op == "oper_q_diag":
            return o.oper_q_diag(0.5, 0.3, None)
        if op == "oper_q_diag_w":
            w = (self.stag(self.w0, self.wbs) if port
                 else self.jstag(self.w0, self.wbs))
            return o.oper_q_diag(0.5, 0.3, w)
        if op == "face_interp":
            return [o.face_interp(arr(self.phi), a)
                    for a in range(self.geom.ndim_space)]
        if op == "t_node_interp":
            return o.t_node_interp(arr(self.q0))
        assert op == "poisson"
        return o.make_poisson(0.5).solve(arr(self.phi))


@pytest.fixture(scope="module", params=list(SPACES))
def case(request):
    return Case(SPACES[request.param])


@pytest.mark.parametrize("op", OPS)
def test_operator_matches_jax(case, op):
    got, want = _np(case.run(op, True)), _np(case.run(op, False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_adjoint_identities(case):
    """<grad phi, q> = <phi, grad_T q>; <bfd q, z> = <q, bfd_T z> with the
    constant scale_d = 0."""
    o = case.ops
    phi, q, z = _t(case.phi), case.stag(), _t(case.z)
    lhs = o.grad(phi).dot(q)
    rhs = torch.sum(phi * o.grad_T(q))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    lhs = torch.sum(o.bfd(q, 0.7, 0.0) * z)
    rhs = q.dot(o.bfd_T(z, 0.7))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_shaped_matches_flat(case):
    """The port's two engines compute the same values: each operator of
    ``Ops3D`` against ``OpsFlat``'s after the layout conversion."""
    o, f = case.ops, OpsFlat(case.geom, F64, "cpu")
    phi, q, z = _t(case.phi), case.stag(), _t(case.z)
    w = case.stag(case.w0, case.wbs)
    pairs = [
        (o.grad(phi), f.stag_from_internal(f.grad(f.phi_to_internal(phi)))),
        (o.grad_T(q), f.phi_from_internal(f.grad_T(f.stag_to_internal(q)))),
        (o.bfd(q, 0.7, 1.3),
         f.z_from_internal(f.bfd(f.stag_to_internal(q), 0.7, 1.3))),
        (o.bfd_T(z, 0.7),
         f.stag_from_internal(f.bfd_T(f.z_to_internal(z), 0.7))),
        (o.oper_q_diag(0.5, 0.3),
         f.stag_from_internal(f.oper_q_diag(0.5, 0.3))),
        (o.oper_q_diag(0.5, 0.3, w), f.stag_from_internal(
            f.oper_q_diag(0.5, 0.3, f.weight_to_internal(w)))),
        (o.t_node_interp(_t(case.q0)), f.phi_from_internal(
            f.t_node_interp(f.phi_to_internal(_t(case.q0))))),
        (o.make_poisson(0.5).solve(phi), f.phi_from_internal(
            f.make_poisson(0.5).solve(f.phi_to_internal(phi)))),
    ]
    for a in range(case.geom.ndim_space):
        n_a = case.geom.space[a]
        pairs.append((o.face_interp(phi, a), f.phi_from_internal(
            f.face_interp(f.phi_to_internal(phi), a)).narrow(1 + a, 0,
                                                             n_a - 1)))
    for got, want in pairs:
        for a, b in zip(_np(got), _np(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)


def test_leading_axis_is_per_instance(case):
    """Every operator on a stack of two instances (the lockstep fleet's
    leading axis) is bit-equal to the operator on each alone."""
    o = case.ops
    phis = [_t(case.phi), 2.0 * _t(case.phi)]
    qs = [case.stag(), case.stag() * 0.5]
    zs = [_t(case.z), -_t(case.z)]
    sd = torch.tensor([1.3, 0.4], dtype=F64).reshape(2, *[1] * (
        case.geom.ndim_space + 1))
    stacked = {
        "grad": o.grad(torch.stack(phis)),
        "grad_T": o.grad_T(Staggered.stack(qs)),
        "bfd": o.bfd(Staggered.stack(qs), 0.7, sd),
        "bfd_T": o.bfd_T(torch.stack(zs), 0.7),
        "t_node_interp": o.t_node_interp(torch.stack([q.q0 for q in qs])),
        "face_interp": o.face_interp(torch.stack(phis), 0),
        "poisson": o.make_poisson(0.5).solve(torch.stack(phis)),
    }
    for b in range(2):
        alone = {
            "grad": o.grad(phis[b]), "grad_T": o.grad_T(qs[b]),
            "bfd": o.bfd(qs[b], 0.7, float(sd.flatten()[b])),
            "bfd_T": o.bfd_T(zs[b], 0.7),
            "t_node_interp": o.t_node_interp(qs[b].q0),
            "face_interp": o.face_interp(phis[b], 0),
            "poisson": o.make_poisson(0.5).solve(phis[b]),
        }
        for name, want in alone.items():
            got = stacked[name]
            got = got.at(b) if isinstance(got, Staggered) else got[b]
            for x, y in zip(_np(got), _np(want)):
                assert np.array_equal(x, y), name
    # the column axis of a stacked cone array is the engine's cone_dim
    assert stacked["bfd"].shape[o.cone_dim] == case.geom.cone_cols


def test_shaped_helpers_match_jax(case):
    """``staggered.zeros``, the shaped field that ``initialize`` starts q
    and alpha from, as the JAX package's: its shapes and dtype."""
    got, want = tstg.zeros(case.geom, F64), jstg.zeros(case.jgeom,
                                                        jnp.float64)
    assert isinstance(got.bs, tuple)
    for a, b in zip(_np(got), _np(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_ops_by_name():
    """One process runs the flat engine, a mesh the halo engine; no layout
    picks another (the shaped engine is built by name, as an oracle)."""
    g = Geometry(5, (7, 9))
    assert type(make_ops(g, F64, "cpu")) is OpsFlat
    mesh = Mesh(("y", "x"), (2, 1), 0, (0, 1), {}, None, "gloo", "cpu")
    assert isinstance(make_ops(g, F64, "cpu", mesh), OpsHalo)
    with pytest.raises(TypeError, match="layout"):
        make_ops(g, F64, "cpu", layout="3d")


# -- Kernels trajectories ---------------------------------------------------------

# method: (JAX kernels class, port kernels class, tau, acc state, weighted)
CLASSES = {
    "inPALM": (jvariants.InPALMKernels, Kernels, 1.9, False, False),
    "PALM": (jvariants.PALMKernels, tvariants.PALMKernels, 1.9, False,
             False),
    "acc-ADMM": (jvariants.AccADMMKernels, tvariants.AccADMMKernels, 1.0,
                 True, False),
    "sGS-inPALM": (jvariants.SgsKernels, tvariants.SgsKernels, 1.9, False,
                   False),
    "acc-sGS-ADMM": (jvariants.AccSgsADMMKernels,
                     tvariants.AccSgsADMMKernels, 1.0, True, False),
    "weighted": (jvariants.InPALMKernels, Kernels, 1.9, False, True),
}
STEPS = 12


def _love_heart(n, nt):
    r0, r1 = jwdot2d.get_example_w2d("love-heart", n, n)
    barrier = jwdot2d.barrier_love_heart()
    r0, r1, _ = jwdot2d.ensure_barrier_validity(r0, r1, barrier)
    return r0, r1, jwdot2d.get_weight_by_barrier(n, n, nt, barrier), barrier


def _shaped(ops, name, x):
    """A flat state field of the port in the JAX package's shaped form."""
    if name in ("q", "alpha"):
        return ops.stag_from_internal(x)
    if name == "phi":
        return ops.phi_from_internal(x)
    return ops.z_from_internal(x)


@pytest.mark.parametrize("name", list(CLASSES))
def test_kernels_trajectory_matches_jax_3d(name):
    """The port's flat kernels from the JAX "3d" state, against the JAX
    kernels on "3d"."""
    jcls, tcls, tau, acc, weighted = CLASSES[name]
    n, nt = 17, 7
    weight = None
    if weighted:
        r0, r1, weight, _ = _love_heart(n, nt)
    else:
        r0, r1 = jexamples.get_example_2d("example2", n, n)
    lv = jlevel.initialize(r0, r1, nt, dtype=jnp.float64, weight=weight)
    jlevel.initial_scaling(lv, scaling=True)
    jcfg = JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=tau,
                        dtype=jnp.float64, layout="3d", weighted=weighted,
                        check_prim_dual_feas=not weighted)
    tcfg = LevelConfig(geom=Geometry(nt, lv.geom.space), D=lv.D, E=lv.E,
                       tau=tau, dtype=F64, device="cpu")
    if weighted:
        jk = jcls(jcfg, lv.weight)
        tk = tcls(tcfg, weight_from_numpy(jax.device_get(lv.weight),
                                          device="cpu", dtype=F64))
    else:
        jk, tk = jcls(jcfg), tcls(tcfg)
    assert type(tk.ops) is OpsFlat
    js = jk.prep(lv.as_dict(), sigma=0.8)
    conv = acc_state_from_numpy if acc else state_from_numpy
    ts = conv(jax.device_get(js)._asdict(), device="cpu", dtype=F64)
    js = jk.run_segment(js, STEPS)
    ts = tk.run_segment(ts, STEPS)
    jres = jax.device_get(jk.kkt(js))
    tres = tk.kkt(ts)
    # atol: the weighted run's residual 5 sits near 4e-11, where the two
    # packages' sums in another order differ by ~1e-12
    np.testing.assert_allclose(tres["kkt_org"], jres["kkt_org"], rtol=1e-10,
                               atol=1e-10)
    js = js.s if acc else js
    ts = ts.s if acc else ts
    for f in ("phi", "z", "beta", "q", "alpha"):
        for a, b in zip(_np(_shaped(tk.ops, f, getattr(ts, f))),
                        _np(getattr(js, f))):
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=f)


# -- solve_dot and solve_batch with "3d": flat, the JAX "3d" counts ---------

def _problem(kind):
    """(rho0, rho1, nt, levels, opts, method, weight kwargs)."""
    if kind == "inPALM-1d":
        r0, r1 = jexamples.get_example_1d("gaussian", 33)
        return r0, r1, 9, 2, {"tol": 1e-4}, "inPALM", {}
    if kind == "inPALM-3d":
        r0, r1 = jexamples.get_example_3d("gaussian", 9, 9, 9)
        return r0, r1, 5, 1, {"tol": 1e-3}, "inPALM", {}
    if kind == "weighted":
        r0, r1, weight, barrier = _love_heart(17, 7)
        return (r0, r1, 7, 2, {"tol": 1e-2, "maxit": 600}, "inPALM",
                {"weight": weight, "barrier": barrier})
    r0, r1 = jexamples.get_example_2d("example2", 17, 17)
    method = {"inPALM-2d": "inPALM", "sGS-inPALM": "sGS-inPALM",
              "acc-ADMM": "acc-ADMM"}[kind]
    opts = {"tol": 1e-3} if method == "inPALM" else {"tol": 1e-3,
                                                     "maxit": 60}
    return r0, r1, 7, 2, opts, method, {}


@pytest.mark.parametrize("driver", ["host", "device"])
@pytest.mark.parametrize("kind", ["inPALM-2d", "inPALM-1d", "inPALM-3d",
                                  "sGS-inPALM", "acc-ADMM", "weighted"])
def test_solve_dot_counts_match_jax_3d(kind, driver):
    r0, r1, nt, levels, opts, method, kw = _problem(kind)
    opts = dict(opts, layout="3d", driver=driver)
    jout, jh, _ = jsolve_dot(r0, r1, nt, levels,
                             dict(opts, reuse_solvers=False), method,
                             dtype=jnp.float64, verbose=False, **kw)
    tkw = {}
    if kw:
        tkw = {"weight": weight_from_numpy(jax.device_get(kw["weight"]),
                                           device="cpu", dtype=F64),
               "barrier": kw["barrier"]}
    with pytest.warns(UserWarning, match="layout='3d'.*'flat' layout"):
        tout, th, _ = tsolve.solve_dot(r0, r1, nt, levels, opts, method,
                                       device="cpu", dtype=F64,
                                       verbose=False, **tkw)
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    np.testing.assert_allclose(tout["rho"], np.asarray(jout["rho"]),
                               rtol=1e-7, atol=1e-12)
    assert tout["mass_ok"] == jout["mass_ok"]


def test_solve_batch_lockstep_matches_jax_3d():
    a0, a1 = jexamples.get_example_2d("example2", 17, 17)
    b0, b1 = jexamples.get_example_2d("example1", 17, 17)
    r0, r1 = np.stack([a0, b0]), np.stack([a1, b1])
    opts = {"tol": 1e-4, "maxit": 3000, "layout": "3d"}
    jout = jsolve_batch(r0, r1, 5, opts, "inPALM", dtype=jnp.float64,
                        verbose=False)
    with pytest.warns(UserWarning, match="layout='3d'.*'flat' layout"):
        tout = tb.solve_batch(r0, r1, 5, opts, "inPALM", dtype=F64,
                              verbose=False, device="cpu")
    np.testing.assert_array_equal(tout["done"], np.asarray(jout["done"]))
    np.testing.assert_array_equal(tout["done_it"],
                                  np.asarray(jout["done_it"]))
    assert tout["iters"] == int(jout["iters"])
    jr = np.asarray(jout["rho"])
    assert np.abs(tout["rho"].numpy() - jr).max() <= 1e-8 * np.abs(jr).max()


def test_fleet_refuses_3d_on_a_spatial_mesh():
    """As ``solve_dot`` under a mesh: before any collective."""
    from dotsocp_tpu_torch.parallel.sharding import Mesh

    a0, a1 = jexamples.get_example_2d("example2", 9, 9)
    r0, r1 = np.stack([a0, a0]), np.stack([a1, a1])
    spatial = Mesh(("batch", "y", "x"), (1, 2, 1), 0, (0, 1), {}, None,
                   "gloo", "cpu")
    for fn in (tb.solve_batch, tb.solve_fleet):
        with pytest.raises(ValueError, match="layout='3d'.*GSPMD.*halo"):
            fn(r0, r1, 5, {"layout": "3d"}, mesh=spatial, verbose=False,
               device="cpu")
