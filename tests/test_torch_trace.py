"""The spans of the solve path (``utils/trace.py``), the device driver's
split of its loop (``launch_s``, ``wait_s``), ``solve_dot``'s ``spans`` and
the launch counts folded from the replays (``algorithms/graphs.py``), on
the CPU. The file imports no JAX."""
import os
import sys
import time

import pytest
import torch

from dotsocp_tpu_torch.algorithms import graphs
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache, solve_dot
from dotsocp_tpu_torch.ops import fused_step, sgs_sweep
from dotsocp_tpu_torch.utils import trace

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
MULTILEVEL = ("pyramid", "prewarm", "level.scaling", "level.build",
              "level.loop", "level.prolong", "level.recover")


def _events_of(prof):
    """The events of a stopped profiler as the benchmark's trace reduction
    reads them: (name, is_device, start_ns, end_ns)."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from benchlib import trace as bench_trace

    return bench_trace.events_of(prof)


def _profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events_of(prof)


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("solve"), trace.span("level.loop")
    assert a is b
    with a as entered:
        assert entered is a


def test_span_adds_its_seconds_into_a_dict():
    into = {"level.loop_s": 1.0}
    with trace.span("level.loop", into):
        time.sleep(0.002)
    with trace.span("pyramid", into):
        pass
    assert set(into) == {"level.loop_s", "pyramid_s"}
    assert 1.002 <= into["level.loop_s"] < 2.0
    assert 0.0 <= into["pyramid_s"] < 1.0


def test_span_is_a_profiler_range_while_one_runs():
    into = {}

    def body():
        with trace.span("solve"):
            with trace.span("level.loop", into):
                torch.ones(3).add_(1.0)

    _, events = _profile(body)
    host = {n: (s, e) for n, dev, s, e in events if not dev}
    assert {"dotsocp.solve", "dotsocp.level.loop"} <= set(host)
    (s0, e0), (s1, e1) = host["dotsocp.solve"], host["dotsocp.level.loop"]
    assert s0 <= s1 < e1 <= e0
    assert set(into) == {"level.loop_s"}
    # no range once the profiler has stopped
    assert trace.span("solve") is trace.span("pyramid")


@pytest.fixture
def solve17():
    """A 2-level example2 solve at 17^2 x 9 on the device driver (its
    pieces eager on the CPU) through a fresh solver cache, prewarmed."""
    r0, r1 = get_example_2d("example2", 17, 17)

    def run(method="inPALM"):
        t0 = time.perf_counter()
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-3, "driver": "device",
                                             "prewarm": True},
                              method, device="cpu", dtype=torch.float32,
                              verbose=False)
        return out, time.perf_counter() - t0

    clear_solver_cache()
    try:
        yield run
    finally:
        clear_solver_cache()


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_solve_ranges_nest(solve17):
    """The driver's segments and record reads inside a level's loop, inside
    the call's range; one record read a check."""
    (out, _), events = _profile(solve17)
    ranges = {}
    for n, dev, s, e in events:
        if not dev and n.startswith(trace.PREFIX):
            ranges.setdefault(n, []).append((s, e))
    solve, = ranges["dotsocp.solve"]
    loops = ranges["dotsocp.level.loop"]
    assert len(loops) == 2
    assert all(_inside(lp, solve) for lp in loops)
    for name in ("dotsocp.driver.segment", "dotsocp.driver.record_read",
                 "dotsocp.driver.check", "dotsocp.driver.finish"):
        assert ranges[name], name
        assert all(any(_inside(r, lp) for lp in loops)
                   for r in ranges[name]), name
    checks = sum(lv["driver"]["checks"] for lv in out["levels"])
    assert len(ranges["dotsocp.driver.record_read"]) == checks
    assert all(any(_inside(r, c) for c in ranges["dotsocp.driver.check"])
               for r in ranges["dotsocp.driver.record_read"])
    # a preparation a level in the prewarm's range, one in each loop
    prewarm, = ranges["dotsocp.prewarm"]
    assert _inside(prewarm, solve)
    prepares = ranges["dotsocp.driver.prepare"]
    assert sum(_inside(r, prewarm) for r in prepares) == 2
    assert all(sum(_inside(r, lp) for r in prepares) == 1 for lp in loops)
    for name in MULTILEVEL:
        assert all(_inside(r, solve) for r in ranges["dotsocp." + name])


@pytest.mark.parametrize("method", ["inPALM", "acc-ADMM", "sGS-inPALM"])
def test_loop_split_and_spans(solve17, method):
    """Each level's launch and wait seconds lie within its loop's time;
    ``spans`` holds every multilevel step, and sums within the call's
    wall."""
    out, wall = solve17(method)
    for lv in out["levels"]:
        d = lv["driver"]
        assert d["launch_s"] > 0.0 and d["wait_s"] >= 0.0
        assert d["launch_s"] + d["wait_s"] <= lv["time"]
    spans = out["spans"]
    assert set(spans) == {n + "_s" for n in MULTILEVEL}
    assert all(v >= 0.0 for v in spans.values())
    assert sum(spans.values()) <= wall
    assert spans["level.loop_s"] >= sum(lv["time"] for lv in out["levels"])


def test_fold_adds_each_kinds_replays():
    """A kind's unfolded replays add its per-replay launches, times their
    count, to the counters once; a second fold adds nothing."""
    g = graphs.SegmentGraphs("cpu")
    g._graphs["ca_iteration"] = graphs._Graph(
        None, [{"qx_step": 1, "cx_step": 1}, {}])
    g._graphs["sweep"] = graphs._Graph(None, [{}, {"rb_sweep": 2}])
    g._graphs["ca_iteration"].unfolded = 5
    g._graphs["sweep"].unfolded = 3
    before = dict(fused_step.LAUNCHES), dict(sgs_sweep.LAUNCHES)
    try:
        g.fold_launches()
        g.fold_launches()
        assert fused_step.LAUNCHES == dict(before[0],
                                           qx_step=before[0]["qx_step"] + 5,
                                           cx_step=before[0]["cx_step"] + 5)
        assert sgs_sweep.LAUNCHES["rb_sweep"] == before[1]["rb_sweep"] + 6
        g._graphs["sweep"].unfolded = 1
        g.release()
        assert sgs_sweep.LAUNCHES["rb_sweep"] == before[1]["rb_sweep"] + 8
    finally:
        fused_step.LAUNCHES.update(before[0])
        sgs_sweep.LAUNCHES.update(before[1])
