"""Captured CUDA graphs of the device driver's segments: the counterpart of
the JAX package's ``jax.jit`` of the chunk
(``dotsocp_tpu/algorithms/device_driver.py:368-378``).

On the card one iteration of the level loop is a few dozen small kernels,
and launching them one by one from Python costs more than they run (the
headline's finest level spends a quarter of its wall time in kernels). A
:class:`SegmentGraphs` holds one captured graph per *kind* of event-free
piece of the loop (a CA iteration, a check, an acc step with its Halpern
averaging, ...) and replays it. The design replays one-iteration graphs:
a segment of k iterations is k replays, each one ``cudaGraphLaunch``.

The rules a captured function follows (``algorithms/device_driver.py``
keeps them):

- it reads and writes only tensors that outlive the capture (the driver's
  state and loop-state buffers), writing its results into them in place:
  a graph replays at the addresses it was captured at;
- every value that changes between replays lives in a tensor on the card
  (sigma, the scales, the counters), never in a Python number, which the
  capture would freeze;
- it synchronises nothing with the host.

The first call of a kind runs its function eagerly: that run is real work
(its result is the replay's, bit for bit) and it is the warm-up that every
one-time setup needs before a capture (the kernels' build, the sweep's
launch attributes, cuBLAS's handle and workspace on the stream). The second
call captures and then replays; later calls replay. With ``capture_first``
(a driver the solver cache keeps, ``multilevel/solve.py``) the first call
captures right after its eager run, so that every kind a solve used is a
graph for the next solve, even one it used once. All graphs of one driver
share one memory pool and run on one side stream, in order. On the CPU
there are no graphs: every call runs the function. A capture or replay
that fails raises; nothing falls back to eager runs.

A :class:`SegmentGraphs` outlives one solve when its driver is cached: its
graphs, the kinds it has seen and its pool stay, and its counts (captures,
replays, eager runs, the kinds used) restart with each solve
(:meth:`new_solve`). :meth:`release` drops the graphs, and with the last
graph their pool's memory goes back to PyTorch's allocator: at the end of
a solve whose driver is not kept, and at the cache's eviction.

``LAUNCHES`` of ``ops/fused_step.py``, ``ops/sgs_sweep.py`` and
``ops/poisson.py`` count kernel executions: a capture records the launches
its function made and takes them back (a capture runs nothing). A replay only counts itself, by kind;
:meth:`SegmentGraphs.fold_launches` adds the replays' launches to
``LAUNCHES``, which the drivers call at the end of a ``segment``, a
``solve`` and a ``warm`` (and :meth:`release` before it drops the graphs).
So the counts are exact after a segment, a solve or a warm, not in the
middle of one.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from ..ops import fused_step, poisson, sgs_sweep

COUNTERS = (fused_step.LAUNCHES, sgs_sweep.LAUNCHES, poisson.LAUNCHES)
# one side stream per card for every driver (cuBLAS keeps a workspace for
# each stream it has run on)
_STREAMS = {}


def _snapshot():
    return [dict(c) for c in COUNTERS]


class _Graph:
    """A captured graph, the launches one replay makes (a dict for each
    counter of ``COUNTERS``) and its replays not yet added to them."""

    __slots__ = ("graph", "deltas", "unfolded")

    def __init__(self, graph, deltas):
        self.graph = graph
        self.deltas = deltas
        self.unfolded = 0


class SegmentGraphs:
    """The captured graphs of one level's driver, by kind."""

    def __init__(self, device, eager: bool = False,
                 capture_first: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # every call eager, on the card too (what a replay is held against)
        self.eager = eager
        # capture at a kind's first call, after its eager run
        self.capture_first = capture_first
        self._graphs = {}   # kind -> _Graph
        self._seen = set()
        self._pool = None
        self.stream = None
        if self.cuda:
            index = self.device.index
            if index is None:
                index = torch.cuda.current_device()
            self._index = index
            if index not in _STREAMS:
                _STREAMS[index] = torch.cuda.Stream(index)
            self.stream = _STREAMS[index]
            self._pool = torch.cuda.graph_pool_handle()
        self.new_solve()

    def new_solve(self) -> None:
        """Restart the counts (a cached driver's next solve)."""
        self.captures = 0
        self.replays = 0
        self.eager_runs = 0
        # the host's seconds in first (eager) runs and in captures
        self.eager_s = 0.0
        self.capture_s = 0.0
        self.used = set()   # the kinds run, on every device

    def context(self):
        """The stream the driver's work runs on (a no-op on the CPU):
        captures need a side stream, and eager warm-ups must run on the
        stream the capture will use."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def run(self, kind: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` (which returns nothing and works in place on tensors
        that outlive it): eagerly on the CPU and at the first call of
        ``kind``, from its captured graph after that."""
        self.used.add(kind)
        if not self.cuda or self.eager:
            fn()
            return
        entry = self._graphs.get(kind)
        if entry is None:
            if kind not in self._seen:
                self._seen.add(kind)
                self.eager_runs += 1
                t0 = time.perf_counter()
                fn()
                self.eager_s += time.perf_counter() - t0
                if self.capture_first:
                    self._capture(kind, fn)
                return
            entry = self._capture(kind, fn)
        entry.graph.replay()
        self.replays += 1
        entry.unfolded += 1

    def fold_launches(self) -> None:
        """Add the kernel launches of the replays since the last fold to
        ``LAUNCHES``."""
        for entry in self._graphs.values():
            if entry.unfolded:
                for counter, delta in zip(COUNTERS, entry.deltas):
                    for name, n in delta.items():
                        counter[name] += n * entry.unfolded
                entry.unfolded = 0

    def _capture(self, kind: str, fn):
        t0 = time.perf_counter()
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        # the capture records; it runs nothing, so the wrappers' counts
        # taken during it go back (and come again with each replay)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self._pool)
            try:
                fn()
            except BaseException:
                # end the broken capture so the stream takes work again, and
                # the allocator's recording into the pool, which a failed
                # capture_end leaves open; the function's own error is the
                # one that surfaces
                with contextlib.suppress(Exception):
                    graph.capture_end()
                with contextlib.suppress(Exception):
                    torch._C._cuda_endAllocateToPool(self._index, self._pool)
                self._pool = torch.cuda.graph_pool_handle()
                for counter, old in zip(COUNTERS, before):
                    counter.update(old)
                raise
            graph.capture_end()
        deltas = []
        for counter, old in zip(COUNTERS, before):
            deltas.append({k: counter[k] - old[k] for k in counter
                           if counter[k] != old[k]})
            counter.update(old)
        self._graphs[kind] = _Graph(graph, deltas)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return self._graphs[kind]

    def kinds(self) -> list:
        return sorted(self._graphs)

    def release(self) -> None:
        """Drop every graph and its pool (their replays' launches counted
        first)."""
        self.fold_launches()
        self._graphs.clear()
        self._seen.clear()
