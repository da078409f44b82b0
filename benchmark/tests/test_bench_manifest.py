"""BENCHMARK.json keeps to its schema and limits, and every cell's files
are found by name; a new cell, traffic mix and metric are added as files
alone."""
import json
import os
import re
import shutil

import pytest

from benchlib import cell, manifest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load(ROOT)


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    total = (2 + 14 * cells) * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_exactly_their_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["source"] in SOURCES


def test_names_and_units(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])


def test_every_cell_resolves_by_name(m):
    wl = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        spec = manifest.cell(ROOT, w["name"], manifest=m)
        names = {x["name"] for x in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"], w["name"]
        for x in spec["end_to_end"] + spec["per_layer"]:
            assert callable(manifest.reader(x["name"]))
        assert spec["limits"]["checks"]
        assert spec["traffic"]["kind"] in ("stream", "fleet")
    for x in m["end_to_end"] + m["per_layer"]:
        assert set(x.get("workloads", [])) <= wl
    for c in m["configs"]:
        assert any(w["config"] == c["name"] for w in m["workloads"])


def test_a_cell_is_added_as_files_alone(tmp_path, tiny_manifest):
    """A throwaway cell with its own traffic mix, limits and per-layer
    metric, written as new files beside copies of the existing ones, runs
    through the unchanged harness."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("benchlib/cell.py", "benchlib/traffic.py",
                        "benchlib/manifest.py", "run.py")}
    (bench / "traffic" / "stream_short.json").write_text(json.dumps(
        {"kind": "stream", "why": "throwaway", "opts": {"tol": 1e-3},
         "checks": 2, "trace_seconds": 1}))
    (bench / "limits" / "tiny_throwaway.json").write_text(json.dumps(
        {"checks": {"continuity": 1.0, "energy_gap": 1.0}}))
    (bench / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    m = dict(tiny_manifest)
    m["workloads"] = m["workloads"] + [
        {"name": "tiny_throwaway", "config": "tiny_33x9",
         "traffic": "stream_short", "chips": 1, "why": "throwaway"}]
    m["per_layer"] = m["per_layer"] + [
        {"name": "calls_made", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "multilevel",
         "moves": "instances_per_s", "workloads": ["tiny_throwaway"]}]
    spec = manifest.cell(ROOT, "tiny_throwaway", bench_dir=str(bench),
                         manifest=m)
    res, _ = cell.run(ROOT, "tiny_throwaway", 7, 0.5, True, device="cpu",
                      bench_dir=str(bench), spec=spec)
    assert res["correct"] is True
    assert res["metrics"]["calls_made"]["value"] >= 1
    for p, data in before.items():
        assert open(os.path.join(BENCH, p), "rb").read() == data


def test_tables_hold_their_configurations(m):
    """A configuration that names a table of optimum energies: the table
    is committed, made for the configuration's grid, pairs and reference
    block by the committed reference, holds every pair of its pool, came
    within 10 times the reference's tolerance (a solve that stops at its
    iteration limit says which residual it reached), and says how it was
    made."""
    from benchlib import pool

    named = 0
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        if "table" not in config["reference"]:
            continue
        named += 1
        table = cell.read_table(ROOT, config)
        assert set(pool.slot_pairs(config)) <= set(table["pairs"])
        for row in table["pairs"].values():
            assert row["energy"] > 0.0
            assert row["residual"] <= 10 * config["reference"]["tol"]
            assert len(row["iters"]) == config["reference"]["levels"]
            assert row["seconds"] > 0.0
        for key in ("command", "card", "commit", "reference_sha256"):
            assert table[key], key
    assert named >= 1
