"""The device driver: one level's loop with its decision state on the card,
its event-free pieces replayed from captured CUDA graphs; port of
``dotsocp_tpu/algorithms/device_driver.py`` (``DeviceDriver``,
``AccDeviceDriver``).

The JAX package runs the whole level loop in one ``lax.while_loop`` because
a host round trip to a TPU costs ~25 ms. On the H100 the cost to avoid is
Python's launch overhead: an iteration is a few dozen small kernels. Here
the host keeps the loop, but every value the loop decides with lives in a
tensor on the card, and the host replays captured graphs
(:mod:`.graphs`):

- the solver state's scalars (sigma, cScale, dScale, norm_c, norm_d,
  sigmaScale) are 0-d tensors in the state's dtype, and so are E and the
  values derived from it (``core.EScalars``); D, fixed by the geometry and
  the weight, stays a Python float. The kernels read sd = E / dScale, sbf
  = E / D and the q-step's diagonal from memory
  (``ops/fused_step._scalar_args``), so a rescale needs no re-capture, and
  neither does the next problem;
- :class:`LoopState` holds the counters (int32), the decision values
  max_feas, rel_gap, tol and the history rows (float32: seven kkt_org,
  pdGap, it) as the JAX ``LoopState`` does, and one small ``record``;
- a KKT check is one graph: the battery, the history row, the stopping and
  cadence decisions and the sigma table, all in the JAX device driver's
  types, so it makes exactly that driver's choices (which can differ from
  the host driver's float64 ones at a tie). Its ``record`` is the one
  read-back of a check; the host learns from it whether the level is done
  and whether sigma changed (then it replays the sigma graph);
- a rescale is one graph: the norms, the ratio test on the card and the
  rescale, an identity when the test declines (x / 1 and x * 1 are exact),
  so the host never waits for it.

The host mirrors the schedule (``_Schedule``): the cadence points, the
rescale stops and the chunk ends are integer arithmetic on values it knows,
and every check's record brings the mirror back in line with the card. No
host sync happens inside a segment, and one happens per check.

``stats`` splits the loop's host time (always on, reset by ``prepare``):
``launch_s`` is the host's seconds in the loop's graph launches (each
segment, and the check, sigma, rescale and averaging replays; on a solve
that captures, its first eager runs and captures too), ``wait_s`` its
seconds in the record reads, where it waits for the card. The rest of the
level's ``time`` is the host's schedule and bookkeeping. The loop's steps
are spans of ``utils/trace.py`` (``dotsocp.driver.prepare``, ``.segment``,
``.check``, ``.record_read``, ``.rescale``, ``.finish``), which a running
profiler shows.

Chunks follow ``device_driver.py:398-464``: ``chunk_iters`` (600) splits
segments at ``it_end``; ``max_chunks`` and ``time_limit`` stop at chunk
boundaries; ``checkpoint_path`` is written after each chunk and resumed
from (a stale file is ignored); history times are interpolated from the
marks taken at chunk boundaries and checks.

A driver outlives one solve when the solver cache keeps it
(``multilevel/solve.py``, ``reuse_solvers``): its graphs, their pool and
the tensors they read (``BUFFERS``: the state, the loop state, the Halpern
and sGS buffers) stay, and ``prepare`` copies the next level's values into
those same tensors, since a graph replays at the addresses it was
captured at. ``warm`` captures every kind of piece on a throwaway state
(``prewarm``), so that the next solve starts on replays; ``free`` drops
the graphs and the buffers (the cache's eviction).

On the CPU there are no graphs and the same functions run eagerly, which
is how the tests hold these drivers against the JAX package's.

Under a mesh (the level's kernels on the halo engine, one block a rank;
``dotsocp_tpu/algorithms/device_driver.py:119-158``) every norm and dot
product of a check is summed over the mesh bit-identically on every rank,
so every rank reads the same record and takes the same branch. The pieces
run eagerly there: their halo exchanges are collectives, which a CUDA
graph does not capture over gloo. The time limit is agreed on by every
rank, so no rank stops a chunk before the others.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops.staggered import Staggered
from ..parallel import comm
from ..utils.checkpoint import load_tensors, save_tensors
from ..utils.trace import span
from .core import Kernels, SolverState
from .driver import RunHistory, SIGMA_BOUNDS, UPDATE_RULE, SolveOptions
from .graphs import SegmentGraphs
from .variants import ITERATE

# cadence thresholds (``solver_socp_inPALM.m:361-379``)
_CADENCE_EDGES = (20, 50, 100, 200, 500)
_CADENCE_GAPS = (3, 6, 10, 15, 25, 40)
# the solver state's scalars the device driver keeps on the card
SCALARS = ("sigma", "cScale", "dScale", "norm_c", "norm_d", "sigmaScale")
BIG = 2 ** 30
# the fields of the one record a check reads back, in order
RECORD = ("done", "sigma_changed", "max_feas", "rel_gap", "it",
          "last_sigma_it", "hist_n", "stage", "superior", "bad", "bad_value")


def _cadence_gap(it: int) -> int:
    """The inPALM cadence gap at iteration ``it`` (host integers)."""
    return _CADENCE_GAPS[sum(it >= e for e in _CADENCE_EDGES)]


def _next_check_it(it: int, last: int) -> int:
    """Closed-form next cadence point > it: for each threshold region
    [lo, hi) with gap g, the candidate max(it+1, last+g, lo), valid when
    < hi; the answer is the least valid candidate (the JAX
    ``_next_check_it``, here on the host's integers)."""
    los = (0,) + _CADENCE_EDGES
    his = _CADENCE_EDGES + (BIG,)
    cands = [max(it + 1, last + g, lo)
             for lo, hi, g in zip(los, his, _CADENCE_GAPS)]
    return min([c for c, hi in zip(cands, his) if c < hi] or [BIG])


def _pick(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] for a 0-d integer tensor on the card, without the host
    read that Python indexing with a tensor makes."""
    return values.index_select(0, idx.reshape(1).long()).reshape(())


def _step_lookup(x, edges, values, first):
    """``first`` below edges[0], values[i] from edges[i] on (edges
    increasing), as a chain of selects on the card: the value of the last
    edge that x reaches, as the JAX lookups ``table[sum(x >= edges)]``
    give it, with no constant copied to the card."""
    out = torch.full_like(x, first)
    for edge, value in zip(edges, values):
        out = torch.where(x >= edge, value, out)
    return out


def _table_factor(xi, rule) -> torch.Tensor:
    """get_factor of ``adjust_lagrangianParam.m`` on the card in float32
    (the JAX ``_table_factor``; thresholds and factors rounded to float32
    as its arrays are)."""
    xi = xi.to(torch.float32)

    def pos(x):
        return _step_lookup(x, [r[0] for r in rule], [r[1] for r in rule],
                            1.0)

    return torch.where(xi >= 1.0, pos(xi), 1.0 / pos(1.0 / xi))


def _copy_into(dst, src) -> None:
    """dst <- src for tensors or Staggered fields; nothing when src is dst's
    own buffer (a kernel updated it in place)."""
    if isinstance(dst, Staggered):
        for d, s in zip(dst.tensors(), src.tensors()):
            _copy_into(d, s)
    elif src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


def _blocks(x) -> list:
    return x.tensors() if isinstance(x, Staggered) else [x]


def _where(cond, a, b):
    if isinstance(a, Staggered):
        return a.map(lambda x, y: torch.where(cond, x, y), b)
    return torch.where(cond, a, b)


@dataclasses.dataclass
class LoopState:
    """The level loop's decision state, on the state's device (the JAX
    ``LoopState`` without the iterate, which the driver keeps apart)."""

    it: torch.Tensor              # completed iterations (int32)
    last_sigma_it: torch.Tensor   # int32 (-1e9 initially: the first checks)
    use_feas_org: torch.Tensor    # bool
    stage: torch.Tensor           # rescale stage (int32; 0 = disabled)
    max_feas: torch.Tensor        # float32
    rel_gap: torch.Tensor         # float32
    done: torch.Tensor            # bool
    hist: torch.Tensor            # (H, 9) float32: 7 kkt_org, pdGap, it
    hist_n: torch.Tensor          # int32
    tol: torch.Tensor             # float32 stopping tolerance
    factor: torch.Tensor          # the last check's sigma factor (1: none)
    record: torch.Tensor          # float64 (len(RECORD),): read per check

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@dataclasses.dataclass
class _Schedule:
    """The host's mirror of the values the schedule needs; each check's
    record overwrites it with the card's."""

    it: int = 0
    last: int = -(10 ** 9)
    stage: int = 0
    max_feas: float = float("inf")
    rel_gap: float = float("inf")
    stage3_next: int = 0
    done: bool = False
    superior: bool = False


def _f32(x) -> np.float32:
    return np.float32(x)


class DeviceDriver:
    """inPALM, ALG2 and PALM (weighted or not) on the device loop."""

    name = "Inexact Proximal ALM (device loop)"

    # rescale constants (``solver_socp_inPALM.m:70-77``)
    FIRST_ITER = 10
    SECOND_ITER = 50
    RATIO_THRESHOLD = 1.2
    RULE = UPDATE_RULE
    # set to "error" (or "warn") to run the loop under
    # torch.cuda.set_sync_debug_mode: any host sync outside the one
    # read-back of a check (and a checkpoint's) raises
    sync_debug = None

    def __init__(self, kernels: Kernels, opts: SolveOptions,
                 chunk_iters: int = 600, rescale_check_every: int = 100,
                 checkpoint_path: Optional[str] = None,
                 max_chunks: Optional[int] = None):
        self.k = kernels
        self.opts = opts
        self.chunk_iters = int(chunk_iters)
        if self.chunk_iters < 1:
            raise ValueError(f"chunk_iters={chunk_iters}: must be >= 1")
        self.rescale_check_every = rescale_check_every
        self.checkpoint_path = checkpoint_path
        self.max_chunks = max_chunks
        self._hist_cap = opts.maxit // 3 + 8
        self.device = kernels.ops.device
        self.dtype = kernels.cfg.dtype
        self._stop_idx = [0, 2, 5, 6] if opts.check_prim_dual_feas \
            else [0, 2, 5]
        # what a solve measured: syncs (host reads) and checks of the loop
        self.stats = {}
        self.graphs = None
        self.s = None
        # set by the solver cache: the graphs and buffers outlive the solve
        self.cached = False

    # -- state -----------------------------------------------------------
    def _scalar(self, v, dtype=None):
        # a fill on the card, not a copy from the host
        return torch.full((), v, dtype=dtype or self.dtype,
                          device=self.device)

    # the attributes holding the tensors the captured graphs read, whose
    # addresses a cached driver keeps from one solve to the next
    BUFFERS = ("s", "ls")

    def _init_state(self, var) -> None:
        """The iterate from ``prep`` with its scalars, E and the values
        derived from E moved to the card."""
        s = self.k.prep(var, self.opts.sigma)
        s = getattr(s, "s", s)
        ev = self.k.e_scalars(s.D, s.E)
        self.s = s.replace(ev=ev, E=ev.E,
                           **{f: self._scalar(getattr(s, f))
                              for f in SCALARS})

    def _init_loop(self) -> None:
        i32 = torch.int32
        f32 = torch.float32
        stage = 1 if self.opts.scaling else 0
        self.ls = LoopState(
            it=self._scalar(0, i32),
            last_sigma_it=self._scalar(-(10 ** 9), i32),
            use_feas_org=self._scalar(False, torch.bool),
            stage=self._scalar(stage, i32),
            max_feas=self._scalar(float("inf"), f32),
            rel_gap=self._scalar(float("inf"), f32),
            done=self._scalar(False, torch.bool),
            hist=torch.zeros((self._hist_cap, 9), dtype=f32,
                             device=self.device),
            hist_n=self._scalar(0, i32),
            tol=self._scalar(self.opts.tol, f32),
            factor=self._scalar(1.0),
            record=torch.zeros(len(RECORD), dtype=torch.float64,
                               device=self.device),
        )
        self.h = _Schedule(stage=stage,
                           stage3_next=self.rescale_check_every)

    def _state_tensors(self) -> list:
        s = self.s
        out = []
        for f in ("phi", "q", "z", "alpha", "beta", "c"):
            out += _blocks(getattr(s, f))
        return out + [getattr(s, f) for f in SCALARS] + s.ev.tensors()

    def _all_tensors(self) -> list:
        return self._state_tensors() + self.ls.tensors()

    def _store(self, new: SolverState, fields=None) -> None:
        """Copy ``new``'s tensors (and scalars) into the state's buffers."""
        for f in fields or ("phi", "q", "z", "alpha", "beta", "c") + SCALARS:
            _copy_into(getattr(self.s, f), getattr(new, f))

    def _iterate(self):
        return tuple(getattr(self.s, f) for f in ITERATE)

    def _store_iterate(self, new) -> None:
        for f, x in zip(ITERATE, new):
            _copy_into(getattr(self.s, f), x)

    # -- the pieces that run as graphs ------------------------------------
    def _tick(self) -> None:
        self.ls.it.add_(1)

    def _ca_prologue(self) -> None:
        _copy_into(self.s.z, self.k._fresh_x(self.s))

    def _ca_iteration(self, final: bool) -> None:
        """One x-carry iteration; phi, which no iteration reads, is kept
        only from the boundary iteration."""
        new = self.k._step_fused_x(self.s, final)
        self._store(new, ("q", "z", "alpha", "beta") + (("phi",) if final
                                                         else ()))
        self._tick()

    def _plain_step(self) -> None:
        self._store(self.k._step(self.s), ITERATE)
        self._tick()

    def _segment(self, k: int) -> None:
        """k event-free iterations: the CA x-carry segment (x_step, k-1 CA
        iterations, one boundary iteration) where the kernels run it,
        else k steps."""
        if k < 1:
            return
        run = self.graphs.run
        if self.k.segment_ca:
            run("ca_prologue", self._ca_prologue)
            for _ in range(k - 1):
                run("ca_iteration", lambda: self._ca_iteration(False))
            run("ca_boundary", lambda: self._ca_iteration(True))
        else:
            for _ in range(k):
                run("step", self._plain_step)

    def _post_check(self) -> None:
        """The averaging that completes the checked iteration (acc)."""

    def _kkt(self):
        return self.k._kkt(self.s)

    def _record(self, **kw) -> None:
        ls = self.ls
        vals = dict(done=ls.done, sigma_changed=ls.factor != 1.0,
                    max_feas=ls.max_feas, rel_gap=ls.rel_gap, it=ls.it,
                    last_sigma_it=ls.last_sigma_it, hist_n=ls.hist_n,
                    stage=ls.stage, superior=torch.zeros((), dtype=torch.bool,
                                                         device=self.device))
        vals.update(kw)
        ls.record.copy_(torch.stack([vals[k].to(torch.float64)
                                     for k in RECORD]))

    def _history_row(self, res) -> None:
        ls = self.ls
        row = torch.cat([res["kkt_org"].to(torch.float32),
                         torch.stack([res["pdGap"].to(torch.float32),
                                      ls.it.to(torch.float32)])])
        at = torch.clamp(ls.hist_n, max=self._hist_cap - 1)
        ls.hist.index_copy_(0, at.reshape(1).long(), row.reshape(1, 9))
        ls.hist_n.copy_(torch.clamp(ls.hist_n + 1, max=self._hist_cap))

    def _nonfinite(self, kkt_org):
        bad = ~torch.isfinite(kkt_org)
        first = torch.argmax(bad.to(torch.int32))
        return (torch.where(bad.any(), first, -1),
                _pick(kkt_org, first))

    def _decide_common(self, res):
        """The history row, the stop and use_feas_org (both drivers)."""
        ls = self.ls
        self._history_row(res)
        kkt_org, kkt5 = res["kkt_org"], res["kkt"]
        error = torch.stack([kkt_org[i] for i in self._stop_idx]).max()
        done = error < ls.tol
        use_org = ls.use_feas_org | (kkt5.max() < 5.0 * ls.tol)
        return error, done, use_org

    def _sigma_factor(self, sigma, table_factor):
        """The clamped sigma update's factor in sigma's dtype (1 where the
        table says 1)."""
        lo, hi = SIGMA_BOUNDS
        sigma_new = torch.clamp(sigma * table_factor, lo, hi)
        return torch.where(table_factor != 1.0, sigma_new / sigma,
                           torch.ones_like(sigma)).to(sigma.dtype)

    def _check_block(self) -> None:
        """Bottom-of-iteration KKT check and sigma decision
        (``solver_socp_inPALM.m:219-323``; the JAX ``check_block``)."""
        ls = self.ls
        res = self._kkt()
        kkt_org, kkt5, pd_gap = res["kkt_org"], res["kkt"], res["pdGap"]
        _, done, use_org = self._decide_common(res)
        gap = _step_lookup(ls.it, _CADENCE_EDGES, _CADENCE_GAPS[1:],
                           _CADENCE_GAPS[0])
        adjust = (ls.it - ls.last_sigma_it) >= gap
        pri = torch.where(use_org, torch.maximum(kkt_org[0], kkt_org[1]),
                          torch.maximum(kkt5[0], kkt5[1]))
        dua = torch.where(use_org, torch.maximum(kkt_org[2], kkt_org[4]),
                          torch.maximum(kkt5[2], kkt5[4]))
        table = _table_factor(pri / torch.clamp(dua, min=1e-30), self.RULE)
        factor = self._sigma_factor(self.s.sigma, table)
        update = adjust & ~done
        ls.factor.copy_(torch.where(update, factor, torch.ones_like(factor)))
        ls.last_sigma_it.copy_(torch.where(update, ls.it, ls.last_sigma_it))
        self._finish_check(res, done, use_org)

    def _finish_check(self, res, done, use_org, **record) -> None:
        ls = self.ls
        if self.opts.scaling:   # the JAX driver's stage > 0
            ls.max_feas.copy_(res["kkt"].max().to(torch.float32))
            ls.rel_gap.copy_(res["pdGap"].to(torch.float32))
        ls.done.copy_(done)
        ls.use_feas_org.copy_(use_org)
        bad, bad_value = self._nonfinite(res["kkt_org"])
        self._record(bad=bad, bad_value=bad_value, **record)

    def _sigma_apply(self) -> None:
        """sigma <- sigma * factor with the check's factor
        (``solver_socp_inPALM.m:309-315``)."""
        self._store(Kernels.sigma_mult(self.k, self.s, self.ls.factor),
                    ("alpha", "beta", "c", "sigma"))

    def _rescale_values(self, ratio: bool):
        """(d_scale2, c_scale2, ok): the block norms, or 1 and 1 where the
        periodic ratio test declines (``solver_socp_inPALM.m:139-153``)."""
        norms = self.k._norms(self.s)
        phis = torch.maximum(torch.maximum(norms["normPhi"], norms["normQ"]),
                             norms["normZ"])
        alps = torch.maximum(norms["normAlpha"], norms["normBeta"])
        if not ratio:
            return phis, alps, torch.ones((), dtype=torch.bool,
                                          device=self.device)
        ok = (torch.maximum(alps, phis)
              / torch.clamp(torch.minimum(alps, phis), min=1e-30)
              ) > self.RATIO_THRESHOLD
        one = torch.ones_like(phis)
        return torch.where(ok, phis, one), torch.where(ok, alps, one), ok

    def _rescale(self, ratio: bool) -> None:
        d2, c2, ok = self._rescale_values(ratio)
        self._store(Kernels.rescale(self.k, self.s, d2, c2))
        self.ls.stage.add_(ok.to(torch.int32))

    # -- the host's loop ---------------------------------------------------
    def _read_record(self) -> dict:
        """The one host read of a check, its seconds in ``wait_s``."""
        with span("driver.record_read"), self._sync_allowed():
            t0 = time.perf_counter()
            vals = self.ls.record.tolist()
            self.stats["wait_s"] += time.perf_counter() - t0
        self.stats["syncs"] += 1
        return dict(zip(RECORD, vals))

    def _launch(self, kind: str, fn) -> None:
        """A piece outside the segments (a check, a sigma change, a rescale,
        an averaging), its host seconds in ``launch_s``."""
        t0 = time.perf_counter()
        self.graphs.run(kind, fn)
        self.stats["launch_s"] += time.perf_counter() - t0

    @contextlib.contextmanager
    def _sync_allowed(self):
        if self.sync_debug and self.graphs.cuda:
            torch.cuda.set_sync_debug_mode(0)
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(self.sync_debug)
        else:
            yield

    def _check(self) -> None:
        """A KKT check: its graph, the record, and the sigma graph when the
        check changed sigma."""
        with span("driver.check"):
            self._launch("check", self._check_block)
            rec = self._read_record()
            self.stats["checks"] += 1
            self.marks.append((int(rec["it"]), time.monotonic() - self.t0))
            h = self.h
            if int(rec["it"]) != h.it:
                raise RuntimeError(f"device driver: the card's iteration "
                                   f"{int(rec['it'])} is not the host's "
                                   f"{h.it}")
            h.done = bool(rec["done"])
            h.last = int(rec["last_sigma_it"])
            h.stage = int(rec["stage"])
            h.max_feas = rec["max_feas"]
            h.rel_gap = rec["rel_gap"]
            h.superior = bool(rec["superior"])
            if self.opts.debug_nans and rec["bad"] >= 0:
                raise FloatingPointError(
                    f"{self.opts.label}: KKT residual {int(rec['bad']) + 1} "
                    f"is {rec['bad_value']} at iteration {h.it}")
            if rec["sigma_changed"]:
                self._launch("sigma", self._sigma_apply)

    def _stage_due(self) -> int:
        """The first iteration the first or second rescale may fire at, by
        the last check's max_feas and rel_gap (float32 against float32
        thresholds, as the JAX driver compares); BIG when none may."""
        h = self.h
        mf, rg = _f32(h.max_feas), _f32(h.rel_gap)
        if h.stage == 1 and mf < _f32(2e-2) and rg < _f32(5e-2):
            return self.FIRST_ITER
        if h.stage == 2 and mf < _f32(5e-3) and rg < _f32(1e-2):
            return self.SECOND_ITER
        return BIG

    def _fire_rescale(self) -> None:
        """The rescale graph: always applied before the third stage, behind
        the ratio test on the card from then on."""
        h = self.h
        ratio = h.stage >= 3
        with span("driver.rescale"):
            self._launch("rescale_ratio" if ratio else "rescale",
                         lambda: self._rescale(ratio))
        if ratio:
            self.stats["ratio_evals"] += 1
        else:
            h.stage += 1

    def _rescale_trigger(self) -> None:
        """Top-of-iteration rescale decision for iteration it + 1; the
        periodic evaluation advances ``stage3_next`` whether or not the
        ratio test fires (the JAX ``rescale_trigger``)."""
        h = self.h
        it1 = h.it + 1
        periodic = h.stage >= 3 and it1 == h.stage3_next
        every = self.rescale_check_every
        h.stage3_next = (h.stage3_next + every if periodic
                         else max(h.stage3_next, (h.it // every + 1) * every))
        if it1 >= self._stage_due() or periodic:
            self._fire_rescale()

    def _next_rescale_stop(self) -> int:
        """The iteration just before the next rescale-eligible one."""
        h = self.h
        due = self._stage_due()
        e12 = max(h.it + 1, due) if due < BIG else BIG
        e3 = h.stage3_next if h.stage >= 3 else BIG
        return min(e12, e3) - 1

    def _chunk(self, it_end: int) -> None:
        """The JAX chunk: bodies of (segment, check, averaging, rescale)
        until done or ``it_end``."""
        h = self.h
        maxit = self.opts.maxit
        while not h.done and h.it < min(it_end, maxit):
            event = min(_next_check_it(h.it, h.last),
                        self._next_rescale_stop(), maxit)
            stop = min(event, it_end)
            # a segment the chunk's end cuts short (the host driver, which
            # has no chunks, runs it whole)
            self.stats["chunk_cuts"] += stop < event
            k = max(stop - h.it, 0)
            with span("driver.segment"):
                t0 = time.perf_counter()
                self._segment(k)
                self.stats["launch_s"] += time.perf_counter() - t0
            h.it += k
            if h.it - h.last >= _cadence_gap(h.it) or h.it >= maxit:
                self._check()
            self._post_check()
            self._rescale_trigger()

    # -- checkpoint --------------------------------------------------------
    def _save(self) -> None:
        h = self.h
        with self._sync_allowed():
            save_tensors(self.checkpoint_path, self._all_tensors(),
                         {"iters": h.it, "name": self.name,
                          "schedule": dataclasses.asdict(h)})

    def _resume(self) -> None:
        """Continue from the checkpoint when it is this level's. Under a
        mesh each rank reads its own file, and the ranks resume only when
        every one of them read the same iteration and schedule; else all
        of them start afresh (a missing or stale file on one rank would
        mix blocks of different iterations)."""
        snap = None
        if os.path.exists(self.checkpoint_path):
            try:
                tensors, meta = load_tensors(self.checkpoint_path,
                                             self._all_tensors())
                if meta.get("name") == self.name and "schedule" in meta:
                    snap = tensors, meta
            except ValueError:
                pass  # stale checkpoint from another level/config: ignore
        mesh = self.k.ops.mesh
        if mesh is not None:
            key = None if snap is None else (snap[1]["iters"],
                                             snap[1]["schedule"])
            if not comm.all_equal(key, mesh):
                snap = None
        if snap is None:
            return
        for dst, src in zip(self._all_tensors(), snap[0]):
            dst.copy_(src)
        self.h = _Schedule(**snap[1]["schedule"])

    # -- lifecycle ---------------------------------------------------------
    def prepare(self, var, eager: bool = False) -> None:
        """The state from ``var`` and a fresh loop state (resumed from the
        checkpoint when there is one); ``eager`` runs every piece eagerly on
        the card too, with no graph. A driver prepared before keeps its
        graphs and writes the new values into its buffers."""
        with span("driver.prepare"):
            t0 = time.perf_counter()
            mesh = self.k.ops.mesh
            eager = eager or (mesh is not None and mesh.size > 1)
            if self.graphs is None or self.graphs.eager != eager:
                if self.graphs is not None:
                    self.graphs.release()
                self.graphs = SegmentGraphs(self.device, eager=eager)
            self.graphs.capture_first = self.cached
            self.graphs.new_solve()
            self.stats = {"syncs": 0, "checks": 0, "ratio_evals": 0,
                          "chunk_cuts": 0, "launch_s": 0.0, "wait_s": 0.0}
            kept = None if self.s is None else {a: getattr(self, a)
                                                for a in self.BUFFERS}
            self._init_state(var)
            self._init_loop()
            if kept is not None:
                self._refill(kept)
            if self.checkpoint_path:
                self._resume()
            self.stats["prepare_s"] = time.perf_counter() - t0
            self.t0 = time.monotonic()
            self.marks = [(self.h.it, 0.0)]

    def _refill(self, kept: dict) -> None:
        """Take the buffers of ``kept`` back, with the freshly prepared
        values copied into them (on the current stream, which the loop's
        side stream waits for)."""
        fresh = self._all_tensors()
        for attr, value in kept.items():
            setattr(self, attr, value)
        bufs = self._all_tensors()
        if [(b.shape, b.dtype) for b in bufs] != \
                [(f.shape, f.dtype) for f in fresh]:
            raise RuntimeError(f"{self.name}: the new level's state does not "
                               f"fit the cached driver's buffers")
        for b, f in zip(bufs, fresh):
            b.copy_(f)

    def free(self) -> None:
        """Drop the graphs, their pool and the buffers (the solver cache's
        eviction); a later ``prepare`` starts afresh."""
        if self.graphs is not None:
            self.graphs.release()
        self.graphs = None
        for attr in self.BUFFERS:
            setattr(self, attr, None)

    def _segment_pieces(self) -> dict:
        if self.k.segment_ca:
            return {"ca_prologue": self._ca_prologue,
                    "ca_iteration": lambda: self._ca_iteration(False),
                    "ca_boundary": lambda: self._ca_iteration(True)}
        return {"step": self._plain_step}

    def _pieces(self) -> dict:
        """Every kind of piece the loop runs, with its function."""
        return dict(self._segment_pieces(), check=self._check_block,
                    sigma=self._sigma_apply,
                    rescale=lambda: self._rescale(False),
                    rescale_ratio=lambda: self._rescale(True))

    def warm(self, var) -> None:
        """Prepare on ``var`` and run every kind of piece once (``prewarm``):
        a cached driver captures each, so that its next solve starts on
        replays. What the pieces leave in the buffers is of no use; the next
        ``prepare`` overwrites all of it. Under a mesh, where nothing is
        captured, only the preparation."""
        self.prepare(var)
        if self.graphs.eager:
            return
        with self._on_stream():
            for kind, fn in self._pieces().items():
                self.graphs.run(kind, fn)
        self.graphs.fold_launches()

    @contextlib.contextmanager
    def _on_stream(self):
        """The loop's side stream, ordered after the caller's stream on
        entry and before it on exit (the prep and the caller's reads run on
        the current stream)."""
        if not self.graphs.cuda:
            yield
            return
        self.graphs.stream.wait_stream(torch.cuda.current_stream())
        try:
            with self.graphs.context():
                yield
        finally:
            torch.cuda.current_stream().wait_stream(self.graphs.stream)

    def segment(self, k: int) -> None:
        """k event-free iterations from the current state, as the loop runs
        them (graphs after each kind's first use): what ``chip_smoke.py``
        and the card tests hold replays against eager runs with."""
        with self._on_stream():
            self._segment(k)
        self.graphs.fold_launches()

    def solve(self, var):
        opts = self.opts
        self.prepare(var)
        chunks = 0
        try:
            with self._on_stream(), self._sync_debug():
                while not (self.h.it >= opts.maxit or self.h.done):
                    if self._out_of_time():
                        break
                    if (self.max_chunks is not None
                            and chunks >= self.max_chunks):
                        break
                    self._chunk(min(self.h.it + self.chunk_iters,
                                    opts.maxit))
                    chunks += 1
                    self.marks.append((self.h.it,
                                       time.monotonic() - self.t0))
                    if self.checkpoint_path:
                        self._save()
        finally:
            self.graphs.fold_launches()
            self.stats.update(captures=self.graphs.captures,
                              replays=self.graphs.replays,
                              eager_runs=self.graphs.eager_runs,
                              graph_kinds=self.graphs.kinds(),
                              eager_s=self.graphs.eager_s,
                              capture_s=self.graphs.capture_s)
            if not self.cached:
                self.graphs.release()
        t0 = time.perf_counter()
        with span("driver.finish"):
            out = self._finish(var)
        self.stats["finish_s"] = time.perf_counter() - t0
        return out

    def _out_of_time(self) -> bool:
        """The time limit, agreed on by every rank of a mesh."""
        late = time.monotonic() - self.t0 > self.opts.time_limit
        mesh = self.k.ops.mesh
        return late if mesh is None else comm.any_true(late, mesh)

    @contextlib.contextmanager
    def _sync_debug(self):
        if not (self.sync_debug and self.graphs.cuda):
            yield
            return
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.sync_debug)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(before)

    def _finish(self, var):
        """History (per-check times interpolated from the marks) and the
        level variables, with the scalars back on the host."""
        # one read: the history, its length, the stage and the scalars
        ls = self.ls
        tail = torch.stack([ls.hist_n.double(), ls.stage.double()]
                           + [getattr(self.s, f).double() for f in SCALARS])
        vals = torch.cat([ls.hist.reshape(-1).double(), tail]).cpu().numpy()
        rows, tail = vals[:-len(tail)].reshape(ls.hist.shape), vals[-len(tail):]
        n = min(int(tail[0]), self._hist_cap)
        self.stats["stage"] = int(tail[1])
        rows = rows[:n]
        elapsed = time.monotonic() - self.t0
        marks = np.array(sorted(set(self.marks)))
        hist = RunHistory(method=self.name)
        for r in rows:
            it_r = int(r[8])
            t_r = float(np.interp(it_r, marks[:, 0], marks[:, 1]))
            hist.append(r[:7].astype(np.float64), t_r, it_r, float(r[7]))
        s = self.s.replace(**dict(zip(SCALARS, map(float, tail[2:]))))
        out = Kernels.finalize(self.k, s, var)
        out["name"] = self.name
        out["iters"] = self.h.it
        out["solve_time"] = elapsed
        return hist.as_arrays(), out


class HalpernMixin:
    """The Halpern machinery of the acc drivers (acc-ADMM here, acc-sGS-ADMM
    in :mod:`.device_sgs`): sigma changes and rescales restart the anchor
    (``solver_socp_accADMM.m:346-358,369-388``).

    The anchor, the averaging counter k (int32, on the card: the Halpern
    coefficients 1/(k+2) and (k+1)/(k+2) change every iteration) and
    ``old``, the iterate the next averaging reads, are buffers of their
    own: right after ``prep`` the JAX state's anchors alias the iterate,
    and no acc step updates the iterate in place. The restart when k
    reaches ``restart`` is a select on the card, as in the JAX
    ``_halpern``."""

    BUFFERS = DeviceDriver.BUFFERS + ("anchor", "old", "kc")

    def _pieces(self) -> dict:
        return dict(super()._pieces(), acc_average=self._average)

    def _init_state(self, var) -> None:
        super()._init_state(var)
        cur = self._iterate()
        self.anchor = tuple(x.clone() for x in cur)
        self.old = tuple(x.clone() for x in cur)
        self.kc = self._scalar(0, torch.int32)

    def _state_tensors(self) -> list:
        out = super()._state_tensors()
        for x in self.old + self.anchor:
            out += _blocks(x)
        return out + [self.kc]

    def _keep_old(self) -> None:
        for o, x in zip(self.old, self._iterate()):
            _copy_into(o, x)

    def _halpern(self, old, cur, keep_old: bool) -> None:
        """x <- 1/(k+2) x0 + (k+1)/(k+2) ((1-rho) x_old + rho x) into the
        iterate's buffers, k += 1, the anchor restarting when k reaches
        ``restart``; ``keep_old`` also sets ``old`` to the new iterate."""
        kf = self.kc.to(self.dtype)
        c1 = 1.0 / (kf + 2.0)
        c2 = (kf + 1.0) / (kf + 2.0)
        rho = self.k.rho
        new = tuple(x0 * c1 + ((1.0 - rho) * xo + rho * x) * c2
                    for x0, xo, x in zip(self.anchor, old, cur))
        k1 = self.kc + 1
        restart = k1 >= self.k.restart
        for a, n in zip(self.anchor, new):
            _copy_into(a, _where(restart, n, a))
        self.kc.copy_(torch.where(restart, torch.zeros_like(k1), k1))
        self._store_iterate(new)
        if keep_old:
            self._keep_old()

    def _average(self) -> None:
        """The averaging that completes a checked iteration."""
        self._halpern(self.old, self._iterate(), True)

    def _post_check(self) -> None:
        self._launch("acc_average", self._average)

    def _sigma_apply(self) -> None:
        """Scales alpha/beta/c (and old's) and restarts the anchor at the
        scaled iterate (``accADMM.m:346-358``)."""
        super()._sigma_apply()
        inv = 1.0 / self.ls.factor
        for x in self.old[3:]:
            for b in _blocks(x):
                b.mul_(inv)
        for a, x in zip(self.anchor, self._iterate()):
            _copy_into(a, x)
        self.kc.zero_()

    def _rescale(self, ratio: bool) -> None:
        """The rescale restarts old and the anchor at the rescaled iterate
        (where the ratio test fires; else both stay, old being the
        iterate after the averaging)."""
        d2, c2, ok = self._rescale_values(ratio)
        self._store(Kernels.rescale(self.k, self.s, d2, c2))
        self.ls.stage.add_(ok.to(torch.int32))
        for a, x in zip(self.anchor, self._iterate()):
            _copy_into(a, _where(ok, x, a))
        self._keep_old()
        self.kc.copy_(torch.where(ok, torch.zeros_like(self.kc), self.kc))


class AccDeviceDriver(HalpernMixin, DeviceDriver):
    """acc-ADMM, theta = 2 (weighted too), on the device loop: inside a
    segment each step is averaged at once against the iterate before it,
    so ``old`` is copied only before the segment's last step, whose
    averaging waits for the check (the JAX ``_segment``)."""

    name = "Accelerated ADMM (device loop)"

    def __init__(self, kernels, opts, chunk_iters: int = 600, **kw):
        super().__init__(kernels, opts, chunk_iters=chunk_iters,
                         rescale_check_every=200, **kw)

    def _segment_pieces(self) -> dict:
        return {"acc_iteration": self._acc_iteration,
                "acc_last": self._acc_last}

    def _acc_iteration(self) -> None:
        stepped = self.k._step(self.s)
        self._halpern(self._iterate(),
                      tuple(getattr(stepped, f) for f in ITERATE), False)
        self._tick()

    def _acc_last(self) -> None:
        self._keep_old()
        self._store(self.k._step(self.s), ITERATE)
        self._tick()

    def _segment(self, k: int) -> None:
        if k < 1:
            return
        for _ in range(k - 1):
            self.graphs.run("acc_iteration", self._acc_iteration)
        self.graphs.run("acc_last", self._acc_last)


def replay_against_eager(make, var, k: int = 40, counter=None) -> list:
    """Graph replays held against eager runs on the card: two drivers from
    ``make()`` prepared on ``var``, one replaying its pieces from CUDA
    graphs, one running them eagerly. Both run a 2-iteration warm-up (every
    kind's first use, eager in both), then a k-iteration segment, a rescale
    and k more, a sigma change (factor 1.25) and k more; ``counter`` first
    sets an acc driver's averaging counter (restart - k/2 puts an anchor
    restart inside the first segment). Returns, after each of the three
    segments, (what, the largest absolute difference over the driver's
    tensors, the index of the first tensor that differs or None, the
    largest entry of the eager run's tensors that differ)."""
    drivers = []
    for eager in (False, True):
        d = make()
        d.prepare(var, eager=eager)
        drivers.append(d)

    def both(fn):
        for d in drivers:
            with d._on_stream():
                fn(d)

    def sigma(d):
        d.ls.factor.fill_(1.25)
        d.graphs.run("sigma", d._sigma_apply)

    both(lambda d: d._segment(2))
    if counter is not None:
        both(lambda d: d.kc.fill_(counter))
    out = []
    for what, event in (("segment", None),
                        ("after a rescale",
                         lambda d: d.graphs.run("rescale",
                                                lambda: d._rescale(False))),
                        ("after a sigma change", sigma)):
        if event is not None:
            both(event)
        both(lambda d: d._segment(k))
        gap, first, scale = 0.0, None, 0.0
        for i, (a, b) in enumerate(zip(drivers[0]._all_tensors(),
                                       drivers[1]._all_tensors())):
            if torch.equal(a, b):
                continue
            first = i if first is None else first
            gap = max(gap, float((a.double() - b.double()).abs().max()))
            scale = max(scale, float(b.double().abs().max()))
        out.append((what, gap, first, scale))
    return out
