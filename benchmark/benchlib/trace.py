"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: the device's busy time (the union of the intervals
in which any operation ran on the card, so that overlapping streams count
once), device time by kernel class, the operations that took most time,
and the idle gaps labelled by what the host was doing.

Events are read from the profiler's raw results (``kineto_results``), not
from an exported Chrome trace: nothing is written to disk. The window is
the span of the harness's ``WINDOW_SPAN`` record, in the trace's own clock.
"""
from __future__ import annotations

import glob
import os
import re
from collections import Counter
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"
# cuBLAS / CUTLASS matrix products: the phi-step's DCT matmuls
GEMM = re.compile(r"gemm|cutlass|xmma|cublas", re.IGNORECASE)
_BOUNDS = r"(?:__launch_bounds__\([^)]*\)\s*)?"
_GLOBAL = re.compile(r"__global__\s+" + _BOUNDS + r"void\s+" + _BOUNDS +
                     r"(\w+)")


def program_kernel_names(csrc_dir: str) -> frozenset:
    """The names of the program's own CUDA kernels: every ``__global__``
    function of its sources (``csrc/*.cu``)."""
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return frozenset(names)


def kernel_name(name: str) -> str:
    """The bare function name of a kernel as the trace spells it
    ("void (anonymous namespace)::cx_kernel<2, 0>(float const*, ...)" ->
    "cx_kernel")."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip()


def kernel_class(name: str, own: frozenset) -> str:
    """'own' for a kernel of the program's sources, 'gemm' for a library
    matrix product, 'other' for the rest (PyTorch's elementwise and
    reduction kernels, copies)."""
    if kernel_name(name) in own:
        return "own"
    if GEMM.search(name):
        return "gemm"
    return "other"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: Counter = field(default_factory=Counter)   # by class
    device_ops: list = field(default_factory=list)       # [[name, s]]
    idle_gaps: list = field(default_factory=list)        # [[label, s]]


def _union(intervals):
    """Merged (start, end) pairs of sorted intervals."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def summarize_events(events, own: frozenset, top: int = 10):
    """``events``: (name, is_device, start_ns, end_ns) tuples. Returns the
    TraceSummary of the window that the ``WINDOW_SPAN`` host event spans,
    or None where there is none."""
    span = [(s, e) for n, dev, s, e in events
            if not dev and n == WINDOW_SPAN]
    if not span:
        return None
    w0, w1 = span[0]
    dev, host = [], []
    for name, is_dev, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        (dev if is_dev else host).append((name, s, e))
    by_class, by_name = Counter(), Counter()
    for name, s, e in dev:
        by_class[kernel_class(name, own)] += (e - s) / 1e9
        by_name[name] += (e - s) / 1e9
    busy = _union(sorted((s, e) for _, s, e in dev))
    busy_s = sum(b - a for a, b in busy) / 1e9
    # the idle gaps, each labelled by the innermost host event that spans
    # its middle (the harness's own spans, the runtime calls, PyTorch ops)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort(key=lambda h: h[1])
    labels = Counter()
    active, i = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(host) and host[i][1] <= mid:
            if host[i][0] != WINDOW_SPAN:
                active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        best = min(active, key=lambda h: h[2] - h[1], default=None)
        labels[best[0] if best else "host: outside any event"] += \
            (b - a) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s, device_s=by_class,
        device_ops=[[n[:160], s] for n, s in by_name.most_common(top)],
        idle_gaps=[[n[:160], s] for n, s in labels.most_common(top)])


def events_of(prof):
    """(name, is_device, start_ns, end_ns) of every event a stopped
    ``torch.profiler.profile`` recorded, but the device side of the
    harness's own spans (a span is no operation on the card)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == cuda
        if dev and (e.is_user_annotation() or e.name() == WINDOW_SPAN):
            continue
        out.append((e.name(), dev, e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out
