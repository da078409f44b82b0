"""The weighted love-heart kind (``problems/wdot_loveheart.py``) and its
reference (``benchlib/wreference.py``): the kind loads with every name,
its pool and arguments are what the cell's configuration says, its table
is refused for another weight, barrier or reference, the three readers of
the cell read fixture runs and nothing without their counters, and the
faults of the program read ``correct`` false through the kind's checks
(at 33^2 x 9, two levels, on the CPU, through a table made here)."""
import json
import os

import pytest
import torch

import tabulate_energies
from benchlib import cell, manifest, pool as P, wreference as WR
from benchlib.cell import Run
from benchlib.traffic import Call
from conftest import BENCH, FIXTURES, ROOT
from dotsocp_tpu_torch.algorithms.core import Kernels
from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.multilevel import solve as solve_mod

STREAM = "dotmark129_stream"
SEED = 2 ** 40 + 3
CELL = "wdot_loveheart129"
# the tiny cell's limits: its sound float32 answer to tol 1e-3 at 33^2 x 9
# reads continuity 2.4e-3, energy_gap 0.22 and wall_mass 8e-8 (the eroded
# walls at 33^2 are the outer ones alone); the weight dropped reads
# energy_gap 0.50, and the stalled solves fail continuity or energy_gap
TINY_LIMITS = {"continuity": 1e-2, "energy_gap": 0.35, "wall_mass": 1e-3}


def _committed():
    with open(os.path.join(BENCH, "configs",
                           "wdot2d_loveheart_129x129.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(FIXTURES, "tiny_wdot_33x9.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def kind(tiny):
    return manifest.problem(tiny)


def test_the_kind_loads_with_every_name(kind):
    assert all(hasattr(kind, name) for name in manifest.KIND_NAMES)
    assert kind.STOP_ROWS == [0, 2, 5]
    assert set(kind.CHECKS) == {"continuity", "energy_gap", "wall_mass"}
    assert manifest.problem(_committed()) is kind


def test_the_cells_configuration_names_the_kind_and_its_limits():
    spec = manifest.cell(ROOT, CELL)
    assert spec["config"]["problem"]["kind"] == "wdot_loveheart"
    assert set(spec["limits"]["checks"]) == set(WR.CHECKS)
    names = {m["name"] for m in spec["per_layer"]}
    assert {"weighted_kernel_share", "weight_key_ms", "coarse_us_per_iter",
            "iters_per_instance", "peak_gib"} <= names
    assert spec["workload"]["chips"] == 1


def test_pool_turns_the_pair_by_the_barriers_symmetries(tiny, kind):
    pool = kind.make_pool(tiny, SEED, "cpu", ROOT)
    orient = kind.orientations(SEED, len(pool))
    assert len(pool) == tiny["pool"]["size"] and set(orient) <= {0, 4}
    assert len(set(kind.orientations(s, 64)[0] for s in range(16))) == 2
    base = [torch.as_tensor(r) for r in kind._pair(tiny)]
    for (r0, r1), o in zip(pool, orient):
        assert r0.dtype == torch.float32
        assert torch.equal(r0, P._orient(base[0], o).float())
        assert torch.equal(r1, P._orient(base[1], o).float())
    args = kind.slot_args(tiny, SEED, "cpu", ROOT)
    assert all(a is args[0] for a in args)
    weight = args[0]["weight"]
    # the weight keeps the flip of the columns: every slot passes it
    for b in weight.blocks():
        assert torch.equal(b, torch.flip(b, dims=(-1,)))
    assert kind.slot_pairs(tiny) == ["love-heart"] * len(pool)


@pytest.fixture(scope="module")
def tabled(tiny, tmp_path_factory):
    """The tiny configuration naming a table made here."""
    table = tabulate_energies.make_table(ROOT, tiny, "cpu", "test", "none")
    path = tmp_path_factory.mktemp("wtable") / "tiny.json"
    path.write_text(json.dumps(table))
    return dict(tiny, reference=dict(tiny["reference"], table=str(path)))


def test_table_records_the_weighted_solve(tabled, kind):
    table = cell.read_table(ROOT, tabled)
    row = table["pairs"]["love-heart"]
    assert row["residual"] <= tabled["reference"]["tol"]
    assert table["kind"] == "wdot_loveheart"
    assert table["barrier"] == "love-heart"
    assert table["barrier_weight"] == wdot2d.BARRIER_WEIGHT
    assert table["reference_sha256"] == kind.reference_sha256()


@pytest.mark.parametrize("change", ["wall_weight", "barrier", "reference"])
def test_table_refused_for_another_weight_barrier_or_reference(
        tabled, kind, monkeypatch, tmp_path, change):
    if change == "wall_weight":
        monkeypatch.setattr(wdot2d, "BARRIER_WEIGHT", 1e4)
        match = "was made for"
    elif change == "barrier":
        monkeypatch.setattr(wdot2d, "barrier_love_heart",
                            wdot2d.barrier_circle_pillar)
        match = "was made for"
    else:
        table = cell.read_table(ROOT, tabled)
        path = tmp_path / "stale.json"
        path.write_text(json.dumps(dict(table, reference_sha256="0" * 64)))
        tabled = dict(tabled, reference=dict(tabled["reference"],
                                             table=str(path)))
        match = "another"
    with pytest.raises(ValueError, match=match):
        cell.read_table(ROOT, tabled)


def test_the_committed_table_is_accepted():
    config = _committed()
    table = cell.read_table(ROOT, config)
    row = table["pairs"]["love-heart"]
    assert row["energy"] > 0.0 and len(row["iters"]) == 3
    assert table["card"].startswith("NVIDIA")


# -- the readers ----------------------------------------------------------------

def _run(levels_of_calls):
    """One finished solve a list of levels, each (iters, time, driver dict
    or None), and a failed call that counts for nothing."""
    def level(it, t, d):
        out = {"iters": it, "time": t, "build_s": 0.0}
        if d is not None:
            out["driver"] = d
        return out

    calls = [Call(slots=[i], t0=float(i), t1=i + 1.0, done=[True],
                  total_time=1.2, levels=[level(*lv) for lv in levels])
             for i, levels in enumerate(levels_of_calls)]
    calls.append(Call(slots=[9], t0=9.0, t1=10.0, done=[False],
                      levels=[level(50, 9.0, {"weighted_kernel_iters": 0,
                                              "key_s": 9.0})]))
    return Run(config={}, card="a card", calls=calls, window_s=10.0,
               setup_s=1.0, peak_window_bytes=0)


def read(name, run):
    return manifest.reader(name)(run)


def _driver(iters, on, key_s):
    return {"checks": 3, "weighted_kernel_iters": iters if on else 0,
            "key_s": key_s}


def test_readers_of_a_weighted_window():
    """Two solves of 10,000 + 2,729 + 69 iterations: the coarsest level
    0.73 s and 0.75 s, every level on the kernels; 0.011 s of keys a
    level."""
    solves = [[(10000, t0, _driver(10000, True, 0.011)),
               (2729, 0.33, _driver(2729, True, 0.011)),
               (69, 0.08, _driver(69, True, 0.011))]
              for t0 in (0.73, 0.75)]
    run = _run(solves)
    assert read("weighted_kernel_share", run) == 100.0
    assert read("weight_key_ms", run) == pytest.approx(33.0)
    assert read("coarse_us_per_iter", run) == pytest.approx(74.0)
    off = _run([[(10000, 0.7, _driver(10000, True, 0.01)),
                 (2729, 0.3, _driver(2729, False, 0.01))]])
    assert read("weighted_kernel_share", off) == pytest.approx(
        100.0 * 10000 / 12729)


def test_readers_read_nothing_without_their_counters():
    """A program whose drivers report neither ``weighted_kernel_iters``
    nor ``key_s`` (the parent), levels without a driver, or a window
    without a finished solve."""
    plain = _run([[(20, 0.1, {"checks": 2, "syncs": 2}), (5, 0.1, None)]])
    assert read("weighted_kernel_share", plain) is None
    assert read("weight_key_ms", plain) is None
    empty = _run([])
    for name in ("weighted_kernel_share", "weight_key_ms",
                 "coarse_us_per_iter"):
        assert read(name, empty) is None
    assert read("coarse_us_per_iter", plain) == pytest.approx(5000.0)


# -- the checks and the faults ----------------------------------------------------

def test_checks_on_the_references_own_answer(tabled, kind):
    """The reference's answer against its own optimum: continuity at its
    residual, no energy gap, no mass inside the walls."""
    pool = kind.make_pool(tabled, SEED, "cpu", ROOT)
    args = kind.slot_args(tabled, SEED, "cpu", ROOT)
    rc = tabled["reference"]
    sol = kind.reference_solve(tabled, *pool[0], args[0],
                               levels=rc["levels"], tol=rc["tol"],
                               coarse_tol=rc["coarse_tol"],
                               maxit=rc["maxit"], device="cpu")
    opt = sol.optimum()
    answer = (sol.rho, sol.E)
    assert WR.continuity(answer, opt) < 1e-4
    assert WR.energy_gap(answer, opt) == 0.0
    assert WR.wall_mass(answer, opt) < 1e-6
    assert bool(opt.walls.any())
    table = cell.read_table(ROOT, tabled)
    assert opt.energy == pytest.approx(
        table["pairs"]["love-heart"]["energy"], rel=1e-6)


def _cell_run(tiny_manifest, config, opts=None, limits=TINY_LIMITS):
    spec = manifest.cell(ROOT, STREAM, manifest=tiny_manifest)
    spec["config"] = config
    spec["limits"] = {"checks": dict(limits)}
    if opts:
        spec["traffic"] = dict(spec["traffic"], opts=opts)
    torch.manual_seed(0)
    res, _ = cell.run(ROOT, STREAM, SEED, 0.3, False, device="cpu",
                      spec=spec)
    return res


def _no_solve(*a, **kw):
    raise AssertionError("the table path solved an instance")


def test_sound_run_is_correct(tiny_manifest, tabled, monkeypatch):
    monkeypatch.setattr(WR, "solve", _no_solve)
    res = _cell_run(tiny_manifest, tabled)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0


def _dropped_weight(monkeypatch):
    """The program handed no weight: the unweighted path, through the
    walls."""
    real = solve_mod.solve_dot

    def dropped(*a, weight=None, barrier=None, **kw):
        return real(*a, **kw)

    monkeypatch.setattr(solve_mod, "solve_dot", dropped)
    return None


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(Kernels, "_step", lambda self, s: s)
    monkeypatch.setattr(Kernels, "segment_impl", lambda self, s, k: s)
    return {"maxit": 60}


@pytest.mark.parametrize("fault", [
    _dropped_weight, _unchanged_step, lambda mp: {"maxit": 60}],
    ids=["weight_dropped", "step_returns_its_state", "cut_at_60_iters"])
def test_faults_read_correct_false(tiny_manifest, tabled, monkeypatch,
                                   fault):
    opts = fault(monkeypatch)
    monkeypatch.setattr(WR, "solve", _no_solve)
    res = _cell_run(tiny_manifest, tabled, opts=opts)
    assert res["correct"] is False, res["checks"]
