"""Problem kinds (``manifest.problem``): the committed configurations are
of the built-in kind and read as before; a kind of its own is added as one
file, ``problems/<kind>.py``, and the harness, ``control.py`` and
``tabulate_energies.py`` go through it (a unit-weight kind at 33^2 x 9 on
the CPU)."""
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import control
import tabulate_energies
from benchlib import cell, dotmark, manifest, pool as P
from conftest import BENCH, FIXTURES, ROOT
from dotsocp_tpu_torch.multilevel import solve as solve_mod

BIG = 2 ** 33 + 17
STREAM = "dotmark129_stream"
CONFIGS = ("dot2d_129x33", "dot2d_513x65")


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configurations_are_of_the_builtin_kind(name):
    config = _config(name)
    kind = manifest.problem(config)
    assert kind is dotmark
    assert kind.STOP_ROWS == [0, 2, 5, 6]
    ours = kind.make_pool(config, BIG, "cpu", ROOT)
    theirs = P.make_pool(config, BIG, "cpu", ROOT)
    assert len(ours) == len(theirs) == config["pool"]["size"]
    for a, b in zip(ours, theirs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert kind.slot_args(config, BIG, "cpu", ROOT) == \
        [{}] * config["pool"]["size"]
    p, spec = config["problem"], config["pool"]
    assert kind.table_key(config) == {
        "problem": {"dim": p["dim"], "n": p["n"], "nt": p["nt"]},
        "reference": {k: v for k, v in config["reference"].items()
                      if k != "table"},
        "pairs_from": {"stitch": spec["stitch"]["file"],
                       "cauchy": spec.get("cauchy")}}


def test_the_513_table_holds_the_builtin_kinds_key():
    config = _config("dot2d_513x65")
    with open(os.path.join(ROOT, config["reference"]["table"])) as f:
        table = json.load(f)
    key = dotmark.table_key(config)
    assert {k: table[k] for k in key} == key
    assert table["reference_sha256"] == dotmark.reference_sha256()
    assert cell.read_table(ROOT, config) == table


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark that adds nothing but the unit-weight kind's
    file."""
    bench = tmp_path_factory.mktemp("kind") / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "problems").mkdir()
    shutil.copy(os.path.join(FIXTURES, "problems", "unit_weight.py"),
                bench / "problems")
    return str(bench)


def _unit(config):
    return dict(config, problem=dict(config["problem"], kind="unit_weight"))


def _spec(bench, tiny_manifest):
    spec = manifest.cell(ROOT, STREAM, bench_dir=bench,
                         manifest=tiny_manifest)
    spec["config"] = _unit(spec["config"])
    spec["limits"] = {"checks": dict(spec["limits"]["checks"], mass=1e-5)}
    return spec


@pytest.fixture(scope="module")
def unit_run(bench, tiny_manifest):
    """A run of the unit-weight kind whose every solve reports its duality
    gap (row 6) at 1: over the tolerance, which the kind does not stop on.
    Returns the result, the run and the keyword arguments of each call."""
    seen = []
    real = solve_mod.solve_dot

    def spy(*a, **kw):
        seen.append(kw)
        out, h, last = real(*a, **kw)
        kkt = np.array(out["levels"][-1]["final_kkt"], np.float64)
        kkt[6] = 1.0
        out["levels"][-1]["final_kkt"] = kkt
        return out, h, last

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solve_mod, "solve_dot", spy)
        torch.manual_seed(0)
        res, rec = cell.run(ROOT, STREAM, 2 ** 40 + 3, 0.3, False,
                            device="cpu", bench_dir=bench,
                            spec=_spec(bench, tiny_manifest))
    return res, rec, seen


def test_the_kinds_arguments_reach_solve_dot(unit_run):
    _, rec, seen = unit_run
    assert len(seen) == 2 + len(rec.calls)
    for kw in seen:
        assert kw["barrier"] is None
        blocks = kw["weight"].blocks()
        assert blocks[0].shape == (8, 33, 33)
        assert all(bool((b == 1).all()) for b in blocks)


def test_the_kinds_stop_rows_decide_done(unit_run):
    res, rec, _ = unit_run
    assert all(c.done == [True] for c in rec.calls)
    assert res["failed"] == 0 and res["attempted"] == len(rec.calls)


def test_the_kinds_checks_are_judged_and_the_answer_is_correct(unit_run):
    res, _, _ = unit_run
    assert set(res["checks"]) == {"continuity", "energy_gap", "mass"}
    assert res["correct"] is True, res["checks"]
    with pytest.raises(KeyError, match="mass"):
        cell.judge(_config("dot2d_129x33"), {"mass": 1.0}, [], [], "cpu",
                   ROOT)


def _spy_reference(monkeypatch, kind):
    calls = []
    real = kind.reference_solve

    def spy(config, r0, r1, args, **kw):
        calls.append((args, kw))
        return real(config, r0, r1, args, **kw)

    monkeypatch.setattr(kind, "reference_solve", spy)
    return calls


def test_control_goes_through_the_kind(bench, tiny_manifest, monkeypatch):
    spec = _spec(bench, tiny_manifest)
    calls = _spy_reference(monkeypatch,
                           manifest.problem(spec["config"], bench))
    control.reference_in_place(spec, "tf32", put=monkeypatch.setattr,
                               bench_dir=bench)
    res, _ = cell.run(ROOT, STREAM, 2 ** 35 + 11, 0.1, False, device="cpu",
                      bench_dir=bench, spec=spec, warmups=1)
    assert res["correct"] is False, res["checks"]
    tf32 = [args for args, kw in calls if kw.get("rounding") == "tf32"]
    assert tf32 and all(a["barrier"] is None and "weight" in a
                        for a in tf32)
    # the judge's own solves are the float64 reference's
    assert any("rounding" not in kw for _, kw in calls)


def test_table_goes_through_the_kind(bench, monkeypatch, tmp_path):
    with open(os.path.join(FIXTURES, "tiny_stitch_33x9.json")) as f:
        config = json.load(f)
    config = _unit(dict(config, reference={
        "levels": 2, "tol": 1e-6, "coarse_tol": 1e-5, "maxit": 20000}))
    kind = manifest.problem(config, bench)
    calls = _spy_reference(monkeypatch, kind)
    table = tabulate_energies.make_table(ROOT, config, "cpu", "test", "none",
                                         bench_dir=bench)
    assert [sorted(args) for args, _ in calls] == [["barrier", "weight"]]
    assert table["kind"] == "unit_weight" and set(table["pairs"]) == \
        {"stitch"}
    path = tmp_path / "unit.json"
    path.write_text(json.dumps(table))
    tabled = dict(config, reference=dict(config["reference"],
                                         table=str(path)))
    assert cell.read_table(ROOT, tabled, kind) == table
    builtin = dict(tabled, problem={k: v for k, v in
                                    tabled["problem"].items()
                                    if k != "kind"})
    with pytest.raises(ValueError, match="was made for"):
        cell.read_table(ROOT, builtin)


def test_unknown_kind_names_where_it_looked(bench):
    where = os.path.join(bench, "problems", "no_such_kind.py")
    with pytest.raises(FileNotFoundError, match=re.escape(where)):
        manifest.problem({"problem": {"kind": "no_such_kind"}}, bench)


def test_kind_that_lacks_a_name_is_refused(tmp_path):
    (tmp_path / "problems").mkdir()
    (tmp_path / "problems" / "half.py").write_text("STOP_ROWS = [0]\n")
    with pytest.raises(AttributeError, match="make_pool"):
        manifest.problem({"problem": {"kind": "half"}}, str(tmp_path))
