"""The readers of the device driver's loop split (``launch_host_ms``,
``launch_us_per_replay``, ``record_wait_ms``) on a hand-built run, and on
one whose program reports no split (they read nothing)."""
import json
import os

import pytest

from benchlib import manifest
from benchlib.cell import Run
from benchlib.traffic import Call
from conftest import ROOT

SPLIT = ("launch_host_ms", "launch_us_per_replay", "record_wait_ms")


def _run(split: bool) -> Run:
    def level(launch_s, wait_s, replays):
        d = {"syncs": 5.0, "replays": float(replays), "prepare_s": 0.001}
        if split:
            d.update(launch_s=launch_s, wait_s=wait_s)
        return {"iters": 100, "time": 0.050, "build_s": 0.001, "driver": d}

    # call 1: launch 10 + 30 ms over 100 + 300 replays, wait 2 + 6 ms;
    # call 2: launch 20 + 40 ms over 200 + 400 replays, wait 4 + 8 ms;
    # a call cut by the window (no total_time) is not read
    calls = [Call(slots=[0], t0=0.0, t1=0.1, done=[True], total_time=0.09,
                  levels=[level(0.010, 0.002, 100),
                          level(0.030, 0.006, 300)]),
             Call(slots=[1], t0=0.1, t1=0.2, done=[True], total_time=0.09,
                  levels=[level(0.020, 0.004, 200),
                          level(0.040, 0.008, 400)]),
             Call(slots=[2], t0=0.2, t1=0.3, done=[False], total_time=None,
                  levels=[level(1.0, 1.0, 1)])]
    with open(os.path.join(ROOT, "benchmark/configs/dot2d_129x33.json")) as f:
        config = json.load(f)
    return Run(config=config, card="NVIDIA H100 80GB HBM3", calls=calls,
               window_s=0.3, setup_s=10.0, peak_window_bytes=2 ** 30)


def test_split_readers():
    run = _run(True)
    read = manifest.reader
    # (40 + 60) / 2 ms a solve; 100 ms over 1,000 replays; (8 + 12) / 2
    assert read("launch_host_ms")(run) == pytest.approx(50.0)
    assert read("launch_us_per_replay")(run) == pytest.approx(100.0)
    assert read("record_wait_ms")(run) == pytest.approx(10.0)


def test_split_readers_read_nothing_without_the_split():
    run = _run(False)
    for name in SPLIT:
        assert manifest.reader(name)(run) is None, name
    run = _run(True)
    for lv in (lv for c in run.calls for lv in c.levels):
        lv["driver"]["replays"] = 0.0
    assert manifest.reader("launch_us_per_replay")(run) is None


def test_split_entries_in_the_benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in SPLIT:
        m = entries[name]
        assert m["layer"] == "device driver"
        assert m["moves"] == "instances_per_s"
        assert m["source"] == "program_span"
        assert {"dotmark129_stream", "dotmark513_stream"} <= set(
            m["workloads"])
