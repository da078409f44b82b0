"""Multi-device solving in the port (``opts={"mesh": ...}``, the sharded
fleet, ``make_sharded_step``) against the JAX package's, in float64 on the
CPU, the port's ranks spawned as gloo worlds (``tests/_torch_worlds.py``)
and the JAX package on ``tests/conftest.py``'s virtual devices.

- A 4-rank world, (y, x) mesh 2 x 2: the meshed ``solve_dot`` of inPALM,
  sGS-inPALM, acc-ADMM and weighted inPALM (love-heart) on example2 33^2 x
  9, as ``__graft_entry__.py:155-236`` runs them, and a float64 refine
  tail (the plain f64 DCT under a mesh, ``dotsocp_tpu/multilevel/
  solve.py:754-760``) after 2 levels at 17^2 x 5. Every rank returns the
  same result; the per-level counts are the JAX meshed solve's (4-device
  (y, x) mesh) and the port's one-process solve's, rho within 1e-9 of
  both. Then ``make_sharded_step`` over a ("batch",) mesh and over the
  (y, x) mesh, 3 steps against 3 of ``run_one`` (1e-10, as
  ``tests/test_parallel.py``); a weighted level's (love-heart) on the
  (y, x) mesh against the JAX ``make_sharded_step``'s; the flat kernels
  over the ("batch",) mesh against the JAX kernels' ``run_one`` on its
  "3d" layout.
- The same 4-rank world on a ("batch", "y", "x") mesh, 2 x 2 x 1: a sum
  over a rank's batch row (``Mesh.row``) adds its row's ranks only, and
  the halo engine refuses the whole mesh; ``solve_batch`` of 4 instances
  at 17^2 x 5 in float64 (inPALM on 2 levels, PALM on 1), every rank's
  result the same, takes exactly the JAX ``solve_batch``'s iterations
  and done_it on its 4-device (batch, y, x) mesh (its "3d" layout) and
  the port's one-process lockstep run's iterations, done_it and chunk
  cuts, rho within 1e-9 of both, with one sum over the mesh a check; and
  ``make_sharded_step(batched=True)`` on that mesh, 3 steps against 3 of
  ``run_one`` per instance (1e-10).
- A 2-rank world: ``solve_fleet(mode="sharded")`` of 4 instances in
  float64 takes exactly the iterations, done_it and chunk cuts of the
  one-process lockstep run (rho within 1e-9) and the JAX ``solve_batch``'s
  counts; ``mode="auto"`` picks "sharded" in a world of two.
- ``demo_batch --mode sharded --spawn 2`` runs, and so does ``--axes
  batch,y --spawn 4`` (the batch x spatial fleet); in a world of one it
  raises, saying that it needs two ranks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models import wdot2d as jwdot2d
from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.multilevel.solve import solve_dot as jsolve_dot
from dotsocp_tpu.parallel.batch import solve_batch as jsolve_batch
from dotsocp_tpu.parallel.sharding import make_mesh as jmake_mesh
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.demos import demo_batch
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.parallel import batch as tb
from dotsocp_tpu_torch.parallel.launch import run_world

from . import _torch_worlds as worlds

F64 = torch.float64
# (axis names, problem, n, nt, levels, opts, method, weighted)
SOLVES = [(("y", "x"), "example2", 33, 9, 1, {"tol": 1e-3}, "inPALM", False),
          (("y", "x"), "example2", 33, 9, 1, {"tol": 1e-3, "maxit": 400},
           "sGS-inPALM", False),
          (("y", "x"), "example2", 33, 9, 1, {"tol": 1e-3, "maxit": 400},
           "acc-ADMM", False),
          (("y", "x"), "love-heart", 33, 9, 1, {"tol": 1e-2, "maxit": 600},
           "inPALM", True),
          (("y", "x"), "example2", 17, 5, 2, {"tol": 1e-3, "refine_tol": 1e-5},
           "inPALM", False)]
SOLVE_IDS = ["inPALM", "sGS-inPALM", "acc-ADMM", "weighted", "refine_tail"]
STEP = (17, 5, 3)   # (n, nt, steps) of make_sharded_step
FLEET = dict(nt=5, opts={"tol": 1e-3, "maxit": 1500}, levels=2)


def _fleet_problems():
    """Four instances at 17^2: example2 and example1, each also rolled."""
    a0, a1 = get_example_2d("example2", 17, 17)
    b0, b1 = get_example_2d("example1", 17, 17)
    r0s = np.stack([a0, b0, np.roll(a0, 3, axis=1), np.roll(b0, 2, axis=0)])
    r1s = np.stack([a1, b1, np.roll(a1, -3, axis=0), np.roll(b1, 2, axis=1)])
    return r0s, r1s


@pytest.fixture(scope="module")
def world4():
    r0s, r1s = _fleet_problems()
    fleet = (r0s, r1s, FLEET["nt"], FLEET["opts"], FLEET["levels"])
    res = run_world(worlds.solves_and_steps, 4, (SOLVES,) + STEP + (fleet,),
                    timeout=400)
    return [r[0] for r in res], res[0][1], [r[2] for r in res]


@pytest.fixture(scope="module")
def world2():
    r0s, r1s = _fleet_problems()
    return run_world(worlds.fleet, 2, (r0s, r1s, FLEET["nt"], FLEET["opts"],
                                       FLEET["levels"]), timeout=300)


def _jax_solve(names, problem, n, nt, levels, opts, method, weighted):
    mesh = jmake_mesh(4, axis_names=names)
    kw = {}
    if weighted:
        r0, r1 = jwdot2d.get_example_w2d(problem, n, n)
        barrier = jwdot2d.barrier_love_heart()
        r0, r1, _ = jwdot2d.ensure_barrier_validity(r0, r1, barrier)
        kw = {"weight": jwdot2d.get_weight_by_barrier(n, n, nt, barrier),
              "barrier": barrier}
    else:
        r0, r1 = jget_example_2d(problem, n, n)
    out, _, _ = jsolve_dot(r0, r1, nt, levels,
                           dict(opts, driver="device", mesh=mesh), method,
                           dtype=jnp.float64, verbose=False, **kw)
    return [lv["iters"] for lv in out["levels"]], np.asarray(out["rho"])


@pytest.mark.parametrize("which", range(len(SOLVES)), ids=SOLVE_IDS)
def test_meshed_solve_matches_jax_and_one_process(world4, which):
    ranks = world4[0]
    iters, rho, kkt, mass_ok = ranks[0][which]
    for r in ranks[1:]:
        assert r[which][0] == iters
        np.testing.assert_array_equal(r[which][1], rho)
        np.testing.assert_array_equal(r[which][2], kkt)
    names, problem, n, nt, levels, opts, method, weighted = SOLVES[which]
    j_iters, j_rho = _jax_solve(*SOLVES[which])
    assert iters == j_iters
    one = worlds.solve_case(problem, n, nt, levels, opts, method, weighted)
    assert iters == one[0]
    np.testing.assert_allclose(rho, one[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rho, j_rho, rtol=0, atol=1e-9)
    # the mass check on the gathered rho, as the one-process solve's (the
    # sGS run stops at maxit short of it)
    assert mass_ok == one[3]


@pytest.fixture(scope="module")
def one_steps():
    n, nt, steps = STEP
    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, nt, dtype=F64, device="cpu")
    initial_scaling(lv, True)
    k = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu",
                            dtype=F64))
    s = k.prep(lv.as_dict(), 1.0)
    for _ in range(steps):
        s = k.run_one(s)
    return s.phi.numpy(), s.z.numpy(), s.q.q0.numpy()


@pytest.mark.parametrize("kind", ["batched", "spatial"])
def test_sharded_step_matches_run_one(world4, one_steps, kind):
    got = world4[1][kind]
    for inst in (got if kind == "batched" else [got]):
        for a, b in zip(inst, one_steps):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_sharded_step_3d_kernels_on_a_batch_mesh(world4):
    """The JAX package's kernels on its "3d" layout, which the port runs
    flat: over the ("batch",) mesh each instance's 3 steps of the port's
    flat kernels are those of the JAX "3d" ``run_one`` (shaped fields)."""
    from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
    from dotsocp_tpu.algorithms.variants import InPALMKernels
    from dotsocp_tpu.multilevel import level as jlevel

    n, nt, steps = STEP
    r0, r1 = jget_example_2d("example2", n, n)
    lv = jlevel.initialize(r0, r1, nt, dtype=jnp.float64)
    jlevel.initial_scaling(lv, True)
    k = InPALMKernels(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                   dtype=jnp.float64, layout="3d"))
    s = k.prep(lv.as_dict(), 1.0)
    for _ in range(steps):
        s = k.run_one(s)
    want = (np.asarray(s.phi), np.asarray(s.z), np.asarray(s.q.q0))
    for inst in world4[1]["batched"]:
        for a, b in zip(inst, want):
            np.testing.assert_allclose(a.reshape(b.shape), b, rtol=1e-10,
                                       atol=1e-12)


def test_sharded_step_weighted_level_matches_jax(world4):
    """A weighted level (love-heart) on the (y, x) mesh: the port's halo
    kernels carry the weight; 3 steps against 3 of the JAX
    ``make_sharded_step`` on its 4-device (y, x) mesh (1e-10)."""
    from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
    from dotsocp_tpu.algorithms.variants import InPALMKernels
    from dotsocp_tpu.multilevel import level as jlevel
    from dotsocp_tpu.parallel.sharding import (make_sharded_step as
                                               jmake_sharded_step)

    n, nt, steps = STEP
    barrier = jwdot2d.barrier_love_heart()
    r0, r1 = jwdot2d.get_example_w2d("love-heart", n, n)
    r0, r1, _ = jwdot2d.ensure_barrier_validity(r0, r1, barrier)
    lv = jlevel.initialize(r0, r1, nt, dtype=jnp.float64,
                           weight=jwdot2d.get_weight_by_barrier(n, n, nt,
                                                                barrier))
    jlevel.initial_scaling(lv, True)
    k = InPALMKernels(JLevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                   dtype=jnp.float64, weighted=True,
                                   check_prim_dual_feas=False), lv.weight)
    step = jmake_sharded_step(k, jmake_mesh(4, axis_names=("y", "x")),
                              batched=False)
    s = k.prep(lv.as_dict(), 1.0)
    for _ in range(steps):
        s = step(s)
    want = (np.asarray(s.phi), np.asarray(s.z), np.asarray(s.q.q0))
    for a, b in zip(world4[1]["weighted_spatial"], want):
        np.testing.assert_allclose(a.reshape(b.shape), b, rtol=1e-10,
                                   atol=1e-12)


def test_batch_row_psum_stays_in_its_row(world4):
    """A sum over a rank's batch row adds the ranks of that row and no
    other: the fault it guards against is a sum over the whole mesh, which
    would add the blocks of different instances together."""
    ranks = world4[2]
    for r in ranks:
        assert r["mesh"] == {"batch": 2, "y": 2, "x": 1}
        row = [q for q, other in enumerate(ranks)
               if other["coords"]["batch"] == r["coords"]["batch"]]
        assert r["row_ranks"] == row
        want = float(sum(q + 1 for q in row))
        assert r["psum"]["row"] == want
        assert r["psum"]["ops"] == want
        assert r["psum"]["mesh"] == 10.0 != want
        assert r["psum"]["refused"]


@pytest.mark.parametrize("method", ["inPALM", "PALM"])
def test_batch_spatial_fleet_matches_jax_and_lockstep(world4, method):
    ranks = [r[method] for r in world4[2]]
    got = ranks[0]
    for other in ranks[1:]:
        for key in ("iters", "chunk_cuts", "checks", "psum_calls"):
            assert other[key] == got[key]
        for key in ("done", "done_it", "kkt", "rho"):
            np.testing.assert_array_equal(other[key], got[key])
    levels = FLEET["levels"] if method == "inPALM" else 1
    # one sum over the mesh a check, for all of a rank's instances; the
    # pieces ran eagerly (no graph kind captured)
    assert got["psum_calls"] == sum(got["checks"])
    assert all(kinds == [] for kinds in got["graph_kinds"])
    r0s, r1s = _fleet_problems()
    lock = tb.solve_batch(r0s, r1s, FLEET["nt"], FLEET["opts"], method,
                          dtype=F64, level_n=levels, verbose=False,
                          device="cpu")
    assert got["iters"] == lock["iters"]
    np.testing.assert_array_equal(got["done_it"], lock["done_it"])
    np.testing.assert_array_equal(got["done"], lock["done"])
    assert got["chunk_cuts"] == [lv["driver"]["chunk_cuts"]
                                 for lv in lock["levels"]]
    np.testing.assert_allclose(got["rho"], lock["rho"].numpy(), rtol=0,
                               atol=1e-9)
    jout = jsolve_batch(r0s, r1s, FLEET["nt"], FLEET["opts"], method,
                        dtype=jnp.float64, level_n=levels, verbose=False,
                        mesh=jmake_mesh(4, axis_names=("batch", "y", "x")))
    assert got["iters"] == jout["iters"]
    np.testing.assert_array_equal(got["done_it"], np.asarray(jout["done_it"]))
    np.testing.assert_allclose(got["rho"], np.asarray(jout["rho"]), rtol=0,
                               atol=1e-9)


def test_batch_spatial_sharded_step_matches_run_one(world4, one_steps):
    steps = world4[2][0]["steps"]
    assert len(steps) == 4
    for inst in steps:
        for a, b in zip(inst, one_steps):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_sharded_fleet_matches_lockstep_and_jax(world2):
    r0s, r1s = _fleet_problems()
    a, b = world2
    # every rank holds the whole fleet's result
    for key in ("iters", "chunk_cuts"):
        assert a[key] == b[key]
    for key in ("done", "done_it", "kkt", "rho"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["mode"] == "sharded"
    lock = tb.solve_batch(r0s, r1s, FLEET["nt"], FLEET["opts"], "inPALM",
                          dtype=F64, level_n=FLEET["levels"], verbose=False,
                          device="cpu")
    assert a["iters"] == lock["iters"]
    np.testing.assert_array_equal(a["done_it"], lock["done_it"])
    np.testing.assert_array_equal(a["done"], lock["done"])
    assert a["chunk_cuts"] == [lv["driver"]["chunk_cuts"]
                               for lv in lock["levels"]]
    np.testing.assert_allclose(a["rho"], lock["rho"].numpy(), rtol=0,
                               atol=1e-9)
    jout = jsolve_batch(r0s, r1s, FLEET["nt"], FLEET["opts"], "inPALM",
                        dtype=jnp.float64, level_n=FLEET["levels"],
                        verbose=False)
    assert a["iters"] == jout["iters"]
    np.testing.assert_array_equal(a["done_it"], np.asarray(jout["done_it"]))


def test_demo_batch_sharded_spawned():
    out = demo_batch.main(["--cpu", "--f64", "--batch", "2", "--nx", "17",
                           "--nt", "5", "--levels", "2", "--mode",
                           "sharded", "--spawn", "2"])
    assert out["mode"] == "sharded"
    assert out["mass_ok"] and bool(np.all(out["done"]))


def test_demo_batch_batch_spatial_spawned():
    out = demo_batch.main(["--cpu", "--f64", "--batch", "2", "--nx", "17",
                           "--nt", "5", "--levels", "1", "--mode",
                           "sharded", "--axes", "batch,y", "--spawn", "4"])
    assert out["mode"] == "sharded"
    assert out["mass_ok"] and bool(np.all(out["done"]))


def test_fleet_auto_picks_sharded_in_a_world_of_two():
    assert tb.pick_fleet_mode(4, (17, 17), 5, 2) == "sharded"
    assert tb.pick_fleet_mode(3, (17, 17), 5, 2) == "lockstep"
    assert tb.pick_fleet_mode(4, (17, 17), 5, 1) == "lockstep"
