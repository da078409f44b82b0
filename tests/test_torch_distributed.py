"""The port's multi-process layer (``dotsocp_tpu_torch/parallel/
distributed.py``, ``sharding.py``, ``comm.py``, ``launch.py``) on the CPU:
the counterpart of ``tests/test_distributed.py``.

- Two processes started by hand (``python -m dotsocp_tpu_torch.parallel.
  distributed --coordinator ... --process-id I``, gloo) run one sharded
  multilevel solve (example2 33^2 x 9, a (y, x) mesh of 2 x 1) through the
  device driver: both print identical ``DIST_RESULT`` records whose counts
  are the one-process solve's.
- A 4-rank world: ``make_mesh`` shapes and coordinates (the JAX
  ``make_mesh``'s on as many devices), ``shard_state`` / ``gather_state``
  round trips, exact, on (y, x), (t, y, x) and (x,) meshes, and the comm
  layer's ``shift``, ``psum``, ``all_gather`` and ``gather_blocks``
  against one process's answers.
- ``solve_fleet(mode="sharded")`` of 2 instances over the 4 ranks: a
  mesh of gcd(2, 4) = 2 ranks, the others receiving its result.
- ``factorize``; a one-rank mesh without a process group; what
  ``initialize_distributed`` refuses; a failing rank ends its world.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dotsocp_tpu.parallel.sharding import factorize as jfactorize
from dotsocp_tpu.parallel.sharding import make_mesh as jmake_mesh
from dotsocp_tpu_torch.parallel.distributed import (initialize_distributed,
                                                    is_coordinator)
from dotsocp_tpu_torch.parallel.launch import free_port, run_world
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.parallel.batch import solve_batch
from dotsocp_tpu_torch.parallel.sharding import factorize, make_mesh

from . import _torch_worlds as worlds

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELFTEST = ["--levels", "1", "--maxit", "400", "--tol", "1e-3", "--cpu",
            "--f64"]


@pytest.mark.parametrize("n,k", [(8, 3), (6, 3), (1, 3), (4, 2), (12, 2),
                                 (7, 1)])
def test_factorize_matches_jax(n, k):
    assert factorize(n, k) == jfactorize(n, k)
    assert int(np.prod(factorize(n, k))) == n


def test_one_rank_mesh_without_a_process_group():
    mesh = make_mesh(axis_names=("y", "x"), device="cpu")
    assert mesh.shape == {"y": 1, "x": 1} and mesh.size == 1
    assert mesh.coords == {"y": 0, "x": 0} and mesh.member
    assert is_coordinator()


def test_initialize_refuses_what_a_rank_cannot_hold():
    with pytest.raises(ValueError, match="one shard"):
        initialize_distributed("127.0.0.1:1", 2, 0, local_device_count=4)


def test_two_process_selftest_matches_one_process():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dotsocp_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)] + SELFTEST,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # the exact PID of a process this test started
    recs = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("DIST_RESULT ")]
        assert lines, out[-3000:]
        rec = json.loads(lines[-1][len("DIST_RESULT "):])
        recs[rec["process"]] = rec
    assert set(recs) == {0, 1}
    r0, r1 = recs[0], recs[1]
    assert r0["processes"] == r1["processes"] == 2
    assert r0["mesh"] == {"y": 2, "x": 1}
    for key in ("iters", "kkt", "mass_ok", "rho_sum"):
        assert r0[key] == r1[key], key
    one = worlds.solve_case("example2", 33, 9, 1,
                            {"tol": 1e-3, "maxit": 400}, "inPALM")
    assert r0["iters"] == one[0]
    assert r0["mass_ok"]
    np.testing.assert_allclose(r0["kkt"], one[2][[0, 2, 5, 6]], rtol=1e-6,
                               atol=1e-12)


def _two_instances():
    a0, a1 = get_example_2d("example2", 9, 9)
    b0, b1 = get_example_2d("example1", 9, 9)
    return np.stack([a0, b0]), np.stack([a1, b1])


@pytest.fixture(scope="module")
def world4_all():
    r0s, r1s = _two_instances()
    return run_world(worlds.conversions_and_fleet, 4,
                     (5, (9, 6), 0, r0s, r1s), timeout=240)


@pytest.fixture(scope="module")
def world4(world4_all):
    return [r[0] for r in world4_all]


def test_sharded_fleet_with_ranks_left_out(world4_all):
    """B = 2 over a world of 4: the mesh holds gcd(2, 4) = 2 ranks, and
    ranks 2 and 3 receive its result; all four hold the one-process
    lockstep run's."""
    r0s, r1s = _two_instances()
    lock = solve_batch(r0s, r1s, 5, {"tol": 1e-3, "maxit": 1500},
                       "inPALM", dtype=torch.float64, level_n=1,
                       verbose=False, device="cpu")
    for _, got in world4_all:
        assert got["mode"] == "sharded"
        assert got["iters"] == lock["iters"]
        np.testing.assert_array_equal(got["done_it"], lock["done_it"])
        np.testing.assert_allclose(got["rho"], lock["rho"].numpy(), rtol=0,
                                   atol=1e-9)


def test_make_mesh_shapes_match_jax(world4):
    names = [("y", "x"), ("t", "y", "x"), ("x",), ("batch", "y", "x")]
    for r, res in enumerate(world4):
        for nm, (shape, coords) in zip(names, res["meshes"]):
            assert shape == dict(jmake_mesh(4, axis_names=nm).shape)
            ext = [shape[n] for n in nm]
            assert coords == dict(zip(nm, (int(c) for c in
                                           np.unravel_index(r, ext))))


@pytest.mark.parametrize("which", range(3), ids=["yx", "tyx", "x"])
def test_shard_gather_round_trip(world4, which):
    for res in world4:
        names, err = res["round_trip"][which]
        assert err == 0.0, (names, err)
        # utils/interop cuts the same block from the fields of a state
        assert res["interop"][which]


@pytest.mark.parametrize("what", ["shift", "shift_x", "psum", "all_gather",
                                  "gather_blocks"])
def test_comm_matches_one_process(world4, what):
    for res in world4:
        assert res["comm"][what] == 0.0
        assert res["comm"]["bytes"] > 0


def test_a_failing_rank_ends_its_world():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_world(worlds.fail_on, 2, (1,), timeout=120)


def test_no_default_device_without_a_card():
    """Entry points run on the card unless the caller asks for the CPU:
    without a card the default device raises, as does the rank's device
    before initialize_distributed ran."""
    from dotsocp_tpu_torch.parallel.distributed import local_device

    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        local_device()
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        make_mesh(axis_names=("y", "x"))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("127.0.0.1:1", 2, 0)
