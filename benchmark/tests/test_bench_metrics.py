"""Each metric reader on a small trace and call record whose numbers are
worked out by hand below."""
import json
import os

import pytest

from benchlib import manifest, trace
from benchlib.cell import Run
from benchlib.traffic import Call
from conftest import FIXTURES, ROOT

OWN = trace.program_kernel_names(os.path.join(ROOT, "dotsocp_tpu_torch",
                                              "csrc"))
MS = 1_000_000   # ns


def test_program_kernel_names_are_read_from_the_sources():
    assert {"x_kernel", "qx_kernel", "cx_kernel", "cone_kernel",
            "rb_sweep_kernel", "shift_kernel"} <= OWN


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::cx_kernel<2, 0>(float const*, float*)",
     "own"),
    ("void (anonymous namespace)::qx_kernel<2, false, false>(float const*)",
     "own"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_dgemm_128x128_8x4_nn_align1>",
     "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "other"),
    ("Memcpy DtoH (Device -> Pageable)", "other"),
])
def test_kernel_class(name, cls):
    assert trace.kernel_class(name, OWN) == cls


# a 10 ms window: a cx kernel 1-3 ms and a gemm 2-4 ms on another stream
# (overlapping: busy 1-4 ms), an add 6-7 ms; the host in a graph launch
# 4-5.5 ms and a stream synchronize 5.5-9 ms, outside any event 0-1 ms
EVENTS = [
    (trace.WINDOW_SPAN, False, 0, 10 * MS),
    ("void (anonymous namespace)::cx_kernel<2, 0>(float const*)", True,
     1 * MS, 3 * MS),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n", True, 2 * MS, 4 * MS),
    ("void at::native::vectorized_elementwise_kernel<4, add>", True,
     6 * MS, 7 * MS),
    ("cudaGraphLaunch", False, 4 * MS, 5500 * 1000),
    ("cudaStreamSynchronize", False, 5500 * 1000, 9 * MS),
    ("bench.call", False, 500 * 1000, 10 * MS),
    # outside the window: not counted
    ("void (anonymous namespace)::cx_kernel<2, 0>(float const*)", True,
     11 * MS, 12 * MS),
]


@pytest.fixture
def summary():
    return trace.summarize_events(EVENTS, OWN)


def test_trace_summary(summary):
    assert summary.window_s == pytest.approx(0.010)
    assert summary.busy_s == pytest.approx(0.004)      # [1, 4] + [6, 7]
    assert summary.device_s["own"] == pytest.approx(0.002)
    assert summary.device_s["gemm"] == pytest.approx(0.002)
    assert summary.device_s["other"] == pytest.approx(0.001)
    gaps = dict(summary.idle_gaps)
    # gaps [0, 1] (mid 0.5: bench.call starts there), [4, 6] (mid 5: the
    # graph launch), [7, 10] (mid 8.5: the synchronize)
    assert gaps["bench.call"] == pytest.approx(0.001)
    assert gaps["cudaGraphLaunch"] == pytest.approx(0.002)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.003)
    assert summary.device_ops[0][1] == pytest.approx(0.002)


def _stream_run(summary):
    lv = [{"iters": 100, "time": 0.010, "build_s": 0.001, "driver": {"syncs": 5, "prepare_s": 0.001, "eager_s": 0.0,
                      "capture_s": 0.0, "finish_s": 0.002}},
          {"iters": 300, "time": 0.050, "build_s": 0.002, "driver": {"syncs": 7, "prepare_s": 0.001, "eager_s": 0.0,
                      "capture_s": 0.0, "finish_s": 0.001}}]
    calls = [Call(slots=[0], t0=0.0, t1=0.080, levels=lv, done=[True],
                  total_time=0.070),
             Call(slots=[1], t0=0.080, t1=0.200, levels=lv, done=[False],
                  total_time=0.090)]
    with open(os.path.join(ROOT, "benchmark/configs/dot2d_129x33.json")) as f:
        config = json.load(f)
    return Run(config=config, card="NVIDIA H100 80GB HBM3", calls=calls,
               window_s=0.200, setup_s=12.5, peak_window_bytes=3 * 2 ** 30,
               trace=summary,
               checks={"answers": 2, "wrong": 0})


def read(name, run):
    return manifest.reader(name)(run)


def test_stream_readers(summary):
    run = _stream_run(summary)
    assert read("instances_per_s", run) == pytest.approx(1 / 0.2)
    assert read("setup_s", run) == 12.5
    # inclusive quantiles of (0.08, 0.12): 0.08 + 0.9 * 0.04
    assert read("solve_s_p90", run) == pytest.approx(0.116)
    assert read("iters_per_instance", run) == 400
    # 70 and 90 ms minus (10 + 1 + 50 + 2) ms
    assert read("outside_levels_ms", run) == pytest.approx(17.0)
    assert read("build_ms", run) == pytest.approx(3.0)
    assert read("syncs_per_instance", run) == 12
    assert read("driver_host_ms", run) == pytest.approx(5.0)
    # 2 ms of own kernels and 2 ms of gemms over 800 iterations
    assert read("step_kernels_ms_per_iter", run) == pytest.approx(2 / 800)
    assert read("dct_ms_per_iter", run) == pytest.approx(2 / 800)
    assert read("device_idle_pct", run) == pytest.approx(60.0)
    assert read("peak_gib", run) == 3.0


def test_untraced_run_leaves_trace_metrics_out():
    run = _stream_run(None)
    for name in ("step_kernels_ms_per_iter", "dct_ms_per_iter",
                 "device_idle_pct"):
        assert read(name, run) is None, name
    run.calls = []
    assert read("iters_per_instance", run) is None


def test_recorded_trace_fixture():
    """A traced window recorded on the card (NVIDIA H100 80GB HBM3): the
    busy time lies within the window and the classes sum the device
    time."""
    path = os.path.join(FIXTURES, "trace_h100_small.json")
    with open(path) as f:
        rec = json.load(f)
    events = [tuple(e) for e in rec["events"]]
    s = trace.summarize_events(events, OWN)
    assert 0.0 < s.busy_s <= s.window_s
    (w0, w1), = [(e[2], e[3]) for e in events if e[0] == trace.WINDOW_SPAN]
    dev = sum(max(0, min(e[3], w1) - max(e[2], w0))
              for e in events if e[1]) / 1e9
    assert sum(s.device_s.values()) == pytest.approx(dev, rel=1e-9)
    assert s.device_s["own"] > 0.0 and s.device_s["gemm"] > 0.0
    assert s.busy_s == pytest.approx(rec["busy_s"], rel=1e-9)


def test_loop_least_gbps():
    """250 finest-level iterations of 2,163,234,816 least bytes (513^2 x
    65) in 0.6 s of finest loops: 901.347... GB/s, on any card."""
    with open(os.path.join(ROOT, "benchmark/configs/dot2d_513x65.json")) as f:
        config = json.load(f)

    def lv(iters, time):
        return {"iters": iters, "time": time, "build_s": 0.0}

    calls = [Call(slots=[0], t0=0.0, t1=1.0, done=[True], total_time=0.9,
                  levels=[lv(200, 0.3), lv(150, 0.4)]),
             Call(slots=[1], t0=1.0, t1=2.0, done=[True], total_time=0.9,
                  levels=[lv(200, 0.3), lv(100, 0.2)])]
    run = Run(config=config, card="some card", calls=calls,
              window_s=2.0, setup_s=1.0, peak_window_bytes=2 ** 30)
    want = 1e-9 * 2_163_234_816 * 250 / 0.6
    assert read("loop_least_gbps", run) == pytest.approx(want, rel=1e-12)
    assert 901.34 < want < 901.35
    run.config = dict(config, problem=dict(config["problem"],
                                           method="sGS-inPALM"))
    assert read("loop_least_gbps", run) is None
    run.config, run.calls = config, []
    assert read("loop_least_gbps", run) is None
