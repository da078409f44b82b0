"""The port's halo engine (``dotsocp_tpu_torch/ops/halo_engine.py``) against
the JAX package's (``dotsocp_tpu/ops/halo_engine.py``), in float64 on the
CPU, on the same mesh shapes.

The port runs SPMD, one rank a shard: a spawned gloo world of 4 ranks
((y, x) 2 x 2) and one of 8 ((y, x) 4 x 2, (t, y, x) 2 x 2 x 2, 1D x 8,
3D (z, y, x) 2 x 2 x 2) each run a batch of cases
(``tests/_torch_worlds.py``); the JAX package runs the same inputs on
``tests/conftest.py``'s 8 virtual devices in this process. Each op
(``grad``, ``grad_T``, ``bfd``, ``bfd_T``, the Poisson solve, two sGS
sweeps, the colour-A residual norm) agrees within 1e-12, and the pads of
every block stay exactly zero. Each operator on a stack of 3 instances
(a leading axis, as the fleet's blocks) is bit-equal, on every rank, to
the operator on each instance alone, its pads zero. The 4-rank world also runs the meshed
solves on a (t, y, x) mesh (2 x 2 x 1) and a 3D (z, y, x) mesh (2 x 2 x
1), held to the JAX meshed solve's per-level counts on the same mesh
shape and to the port's one-process solve's (rho within 1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.models.examples import get_example_3d as jget_example_3d
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot
from dotsocp_tpu.ops.engine import make_ops
from dotsocp_tpu.ops.geometry import Geometry as JGeometry
from dotsocp_tpu.ops.halo_engine import HaloSGS as JHaloSGS
from dotsocp_tpu.ops.staggered import Staggered as JStaggered
from dotsocp_tpu.parallel.sharding import make_mesh as jmake_mesh
from dotsocp_tpu_torch.parallel.launch import run_world

from . import _torch_worlds as worlds

TOL = 1e-12
# (world, axis names, nt, space)
CASES = [(4, ("y", "x"), 5, (17, 17)),
         (8, ("y", "x"), 5, (17, 17)),
         (8, ("t", "y", "x"), 9, (9, 17)),
         (8, ("x",), 5, (33,)),
         (8, ("z", "y", "x"), 5, (9, 9, 17))]
IDS = ["yx2x2", "yx4x2", "tyx2x2x2", "x8", "zyx2x2x2"]
OPS = ["grad", "grad_T", "bfd", "bfd_T", "poisson", "sweep", "resid"]
# the meshed solves of the 4-rank world: (axis names, problem, n, nt,
# levels, opts, method, weighted), as tests/test_halo.py runs them
SOLVES = [(("t", "y", "x"), "example2", 17, 9, 1, {"tol": 1e-3}, "inPALM",
           False),
          (("z", "y", "x"), "gaussian3d", 9, 5, 1,
           {"tol": 5e-3, "maxit": 600}, "inPALM", False)]


def _inputs(nt, space, seed):
    g = JGeometry(nt=nt, space=tuple(space))
    rng = np.random.RandomState(seed)
    return {"phi": rng.randn(*g.phi_shape), "q0": rng.randn(*g.q0_shape),
            "bs": [rng.randn(*g.b_shape(a)) for a in range(len(space))],
            "z": rng.randn(*g.z_shape), "rhs": rng.randn(*g.phi_shape)}


@pytest.fixture(scope="module")
def port():
    """The port's results: case index -> ops dict; plus the 4-rank world's
    solves, every rank's."""
    out = {}
    for world in (4, 8):
        idx = [i for i, c in enumerate(CASES) if c[0] == world]
        cases = [(CASES[i][1], CASES[i][2], CASES[i][3],
                  _inputs(CASES[i][2], CASES[i][3], i)) for i in idx]
        res = run_world(worlds.ops_and_solves, world,
                        (cases, SOLVES if world == 4 else []), timeout=240)
        out.update(zip(idx, res[0][0]))
        if world == 4:
            out["solves"] = [r[1] for r in res]
    return out


def _jax_ops(world, names, nt, space, inp):
    """The JAX halo ops of one case, in one jit (a compile per op would
    cost ~20 s a case)."""
    geom = JGeometry(nt=nt, space=tuple(space))
    mesh = jmake_mesh(world, axis_names=names)
    oh = make_ops(geom, jnp.float64, "halo", mesh)
    sgs = JHaloSGS(oh, D=1.0)
    poisson = oh.make_poisson(1.0)

    @jax.jit
    def run(phi, q0, bs, z, rhs):
        st = JStaggered(q0=q0, bs=tuple(bs))
        rhs = oh.phi_to_internal(rhs)
        d2 = jnp.asarray(0.64)
        sw = sgs.sweep(oh.phi_to_internal(phi), rhs, its=2, d2=d2)
        return {
            "grad": oh.stag_from_internal(oh.grad(oh.phi_to_internal(phi))),
            "grad_T": oh.phi_from_internal(
                oh.grad_T(oh.stag_to_internal(st))),
            "bfd": oh.z_from_internal(
                oh.bfd(oh.stag_to_internal(st), 1.3, 0.7)),
            "bfd_T": oh.stag_from_internal(
                oh.bfd_T(oh.z_to_internal(z), 0.9)),
            "poisson": oh.phi_from_internal(
                poisson.solve(oh.phi_to_internal(phi), scale=0.5)),
            "sweep": oh.phi_from_internal(sw),
            "resid": sgs.residual_color_a_norm(sw, rhs, 0.1, d2=d2),
        }

    out = jax.device_get(run(inp["phi"], inp["q0"], inp["bs"], inp["z"],
                             inp["rhs"]))
    return dict(out, mesh=dict(mesh.shape), resid=float(out["resid"]))


@pytest.fixture(scope="module")
def ref():
    return {i: _jax_ops(*c, _inputs(c[2], c[3], i))
            for i, c in enumerate(CASES)}


def _leaves(x):
    if isinstance(x, (tuple, list)) or hasattr(x, "q0"):
        parts = [x.q0, *x.bs] if hasattr(x, "q0") else list(x)
        return [leaf for p in parts for leaf in _leaves(p)]
    return [np.asarray(x)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_halo_op_matches_jax(port, ref, case, op):
    got, want = port[case], ref[case]
    assert got["mesh"] == want["mesh"], (got["mesh"], want["mesh"])
    g, w = _leaves(got[op]), _leaves(want[op])
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape, (op, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(
            1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_halo_pads_stay_zero(port, case):
    """grad's and bfd_T's face blocks, bfd's cone block and the swept phi
    hold exact zeros in every pad (and ghost) slot of every block."""
    assert port[case]["pads_max"] == 0.0


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_halo_ops_on_a_stack_equal_each_instance(port, case):
    for rank in port[case]["stack"]:
        assert all(rank["equal"].values()), rank["equal"]
        assert rank["pads_max"] == 0.0


@pytest.mark.parametrize("which", range(len(SOLVES)),
                         ids=["tyx_inPALM", "zyx_3d_inPALM"])
def test_meshed_solve_matches_jax_and_one_process(port, which):
    names, problem, n, nt, levels, opts, method, _ = SOLVES[which]
    ranks = port["solves"]
    iters, rho, kkt, mass_ok = ranks[0][which]
    assert len(ranks) == 4
    # every rank returns the same result
    for r in ranks[1:]:
        assert r[which][0] == iters
        np.testing.assert_array_equal(r[which][1], rho)
    if problem == "gaussian3d":
        r0, r1 = jget_example_3d("gaussian", n, n, n)
    else:
        r0, r1 = jget_example_2d(problem, n, n)
    mesh = jmake_mesh(4, axis_names=names)
    jout, _, _ = jsolve_dot(r0, r1, nt, levels,
                            dict(opts, driver="device", mesh=mesh), method,
                            dtype=jnp.float64, verbose=False)
    assert iters == [lv["iters"] for lv in jout["levels"]]
    one = worlds.solve_case(problem, n, nt, levels, opts, method)
    assert iters == one[0]
    np.testing.assert_allclose(rho, one[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rho, np.asarray(jout["rho"]), rtol=0,
                               atol=1e-9)
    assert mass_ok


def test_jax_has_eight_devices():
    # the JAX reference meshes above need conftest's 8 virtual devices
    assert len(jax.devices()) >= 8
