"""The lockstep fleet: many independent transport problems on one shared
geometry, advanced together by one device loop on one card; port of
``dotsocp_tpu/parallel/batch.py`` (``BatchedDeviceDriver``,
``solve_batch``, ``pick_fleet_mode``, ``solve_fleet``).

The KKT cadence depends on the iteration counter alone, so every instance
shares one schedule and the loop never branches per instance. What depends
on the data is a select or an identity, as in the JAX package:

- the sigma update: a per-instance factor, 1 where an instance is done or
  the table says 1;
- the dynamic rescale: a per-instance (d2, c2), (1, 1) where it does not
  fire, its triggers evaluated at the check (aligned to the cadence, the
  one documented deviation from the single-instance trajectory);
- convergence: a converged instance is frozen, every field of it left
  bit-identical, until all are done.

On the card the batched state holds each field of the B instances in one
contiguous ``(B, ...)`` tensor and the scalars sigma .. sigmaScale in
``(B,)`` tensors; D and E are the level's floats (the fleet shares its
geometry, so its D, and E = D / sqrt2 since the JAX batch passes no
``last_kkt``: this is asserted, not assumed). A segment runs the batched
forms of the x-carry kernels (``ops/fused_step.py``: one launch for the
fleet, sd read per instance, the ``active`` mask = not done read by every
block) and the phi-step over the whole stack; PALM runs its own plain step
on each instance's view. The check (the KKT battery and norms on each
instance's view, the decisions on ``(B,)`` tensors) is one more graph.
Each kind of piece is captured once a level and replayed
(``algorithms/graphs.py``); the host reads one record a check.

The levels run on the flat engine, as ``solve_dot``'s do: ``layout``
"halo" and "3d" warn and run flat (``core.warn_single_process_layout``),
and a spatial mesh refuses "flat" and "3d" (``core.check_mesh_opts``).

On the CPU there are no graphs and every piece runs eagerly on the plain
versions, which is how ``tests/test_torch_batch.py`` holds this module to
the JAX package's in float64.

The sharded fleet (``solve_batch(mesh=)``, ``solve_fleet(mode=
"sharded")``; ``dotsocp_tpu/parallel/batch.py:86-110,355-392,436-490``)
splits the batch axis over the ranks of a mesh: each rank runs this same
lockstep loop, kernels and graphs included, on its B/k instances. The
schedule depends on the iteration counter alone, so it is the same on
every rank; the loop ends on the instances' ``all_done`` agreed over the
mesh, so every rank takes the iterations the one-process lockstep run
takes, and the results are gathered to every rank.

A mesh that also splits the grid (a ``batch`` axis and y/x/z/t axes of
extent > 1; the JAX package's batch x spatial path, which it runs on its
GSPMD "3d" layout, ``batch.py:67-113,355-392``) runs SPMD on the halo
engine instead: each batch row of ranks (``Mesh.row``) owns B/k_batch
instances, and each rank of the row holds its block of every one of
them. The level's kernels are built on the row, so every sum of a check
stays within one instance's grid; a step is the variant's plain step on
the whole stack of blocks (one halo exchange and one all-gather for all
of them, as a meshed ``solve_dot`` runs its plain step); a check sums
every instance's parts in one collective and takes the rescale's norms
from the KKT battery's own (the sigma update leaves sigma ||alpha|| and
sigma ||beta|| as they were, and a second collective would otherwise
follow it); the loop's end is agreed over the whole mesh. The pieces
hold collectives, so they run eagerly, never as graphs, as the meshed
device driver's do. The results are gathered along the row, then along
``batch``, to every rank.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..algorithms.core import (BATCH_SCALARS, Kernels, LevelConfig,
                               SolverState, check_mesh_opts, instance,
                               stack_fields, warn_single_process_layout)
from ..algorithms.device_driver import (DeviceDriver, _cadence_gap,
                                        _copy_into, _next_check_it,
                                        _table_factor)
from ..algorithms.driver import SIGMA_BOUNDS, UPDATE_RULE, SolveOptions
from ..algorithms.graphs import SegmentGraphs
from ..algorithms.variants import ITERATE, PALMKernels
from ..multilevel.level import (initial_scaling, initialize, recover_org_var,
                                recover_rho_e)
from ..multilevel.solve import _check_choice, _jump_next_level
from ..multilevel.transfer import restrict_density
from ..ops.staggered import Staggered
from . import comm
from .sharding import Mesh, make_mesh, spatial_axes

# the methods of the lockstep fleet and their multiplier step
# (``dotsocp_tpu/parallel/batch.py:326,340``)
BATCH_METHODS = {"inPALM": 1.9, "PALM": 1.9, "ALG2": 1.0}
# the options solve_batch reads (``batch.py:308-342``); use_pallas / layout
# / driver as solve_dot takes them
BATCH_OPTS = {"tol", "maxit", "sigma", "time_limit", "scaling"}
# solve_dot's cache knobs, which a sequential fleet passes on: the lockstep
# fleet builds its levels afresh on every call (as the JAX solve_batch
# does), so it takes them and they change nothing there
IGNORED_OPTS = {"prewarm", "reuse_solvers"}
FIELDS = ("phi", "q", "z", "alpha", "beta", "c")
# the one record a check reads back
RECORD = ("all_done", "it")


# -- the batched state --------------------------------------------------------

def stack_states(states) -> SolverState:
    """One batched state from per-instance states of one level (``prep``'s):
    each field stacked on a leading axis, the scalars in (B,) tensors in
    the fields' dtype. The instances must share D and E (one geometry):
    RuntimeError where they do not."""
    first = states[0]
    for st in states[1:]:
        if (st.D, st.E) != (first.D, first.E):
            raise RuntimeError(
                f"lockstep fleet: the instances' level constants differ "
                f"(D, E) = {(first.D, first.E)} against {(st.D, st.E)}; "
                f"the batched kernels take one D and one E")
    dev, dtype = first.phi.device, first.phi.dtype
    kw = stack_fields(states, FIELDS)
    for f in BATCH_SCALARS:
        kw[f] = torch.tensor([float(getattr(st, f)) for st in states],
                             dtype=dtype, device=dev)
    return SolverState(D=float(first.D), E=float(first.E), **kw)


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor shaped to broadcast over x's leading axis."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _mul(x, v):
    if isinstance(x, Staggered):
        return x.map(lambda b: _mul(b, v))
    return x * _bcast(v, x)


def _div(x, v):
    if isinstance(x, Staggered):
        return x.map(lambda b: _div(b, v))
    return x / _bcast(v, x)


def sigma_mult(s: SolverState, factor) -> SolverState:
    """sigma <- sigma * factor per instance (the JAX ``_sigma_mult`` under
    vmap): alpha, beta, c are stored pre-divided by sigma."""
    inv = 1.0 / factor
    return s.replace(alpha=_mul(s.alpha, inv), beta=_mul(s.beta, inv),
                     c=_mul(s.c, inv), sigma=s.sigma * factor)


def rescale(s: SolverState, d2, c2, rescaled) -> SolverState:
    """The dynamic rescale per instance (the JAX ``_rescale`` under vmap);
    the blocks of ``rescaled`` (the variant's ``RESCALED``) are divided by
    d2. (1, 1) is an exact identity."""
    r = d2 / (c2 * c2)
    return s.replace(
        sigma=s.sigma * (c2 / d2), c=_mul(s.c, r), norm_c=s.norm_c / c2,
        norm_d=s.norm_d / d2, alpha=_mul(s.alpha, r), beta=_mul(s.beta, r),
        dScale=s.dScale * d2, cScale=s.cScale * c2,
        sigmaScale=s.sigmaScale * (c2 / d2),
        **{b: _div(getattr(s, b), d2) for b in rescaled})


def _blocks(x) -> list:
    return x.tensors() if isinstance(x, Staggered) else [x]


@dataclasses.dataclass
class BatchLoopState:
    """The lockstep loop's decision state on the state's device, in the JAX
    ``BatchLoopState``'s types, with the mask the kernels read and the
    record the host reads."""

    it: torch.Tensor              # shared iteration counter (int32)
    last_sigma_it: torch.Tensor   # shared cadence anchor (int32)
    use_feas_org: torch.Tensor    # (B,) bool
    stage: torch.Tensor           # (B,) int32
    max_feas: torch.Tensor        # (B,) float32
    rel_gap: torch.Tensor         # (B,) float32
    done: torch.Tensor            # (B,) bool
    done_it: torch.Tensor         # (B,) int32: the iteration it converged at
    kkt_last: torch.Tensor        # (B, 7) float32: the latest kkt_org rows
    active: torch.Tensor          # (B,) bool: not done (the kernels' mask)
    record: torch.Tensor          # float64 (len(RECORD),): read per check

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


class BatchedDeviceDriver:
    """Lockstep solve of B instances of one level (inPALM, ALG2, PALM)."""

    name = "Lockstep fleet (device loop)"
    FIRST_ITER = 10
    SECOND_ITER = 50
    RATIO_THRESHOLD = 1.2
    # as DeviceDriver.sync_debug: "error" runs the loop under
    # torch.cuda.set_sync_debug_mode, the check's one read allowed
    sync_debug = None
    # the side stream and the sync-debug switches are the device driver's
    _on_stream = DeviceDriver._on_stream
    _sync_allowed = DeviceDriver._sync_allowed
    _sync_debug = DeviceDriver._sync_debug

    def __init__(self, kernels: Kernels, opts: SolveOptions,
                 chunk_iters: int = 600, mesh: Optional[Mesh] = None):
        # the batch mesh this rank's instances are a block of: the loop's
        # end and its time limit are agreed over it
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.k = kernels
        self.opts = opts
        self.chunk_iters = int(chunk_iters)
        if self.chunk_iters < 1:
            raise ValueError(f"chunk_iters={chunk_iters}: must be >= 1")
        self._stop_idx = [0, 2, 5, 6] if opts.check_prim_dual_feas \
            else [0, 2, 5]
        self.stats = {}

    # -- state ----------------------------------------------------------------
    def prepare(self, bstate: SolverState, eager: bool = False) -> None:
        """Take ``bstate`` (consumed: the kernels update it in place) and a
        fresh loop state; ``eager`` runs every piece eagerly on the card
        too, with no graph."""
        self.s = bstate
        self.device = bstate.phi.device
        self.dtype = bstate.phi.dtype
        # under a spatial mesh the pieces hold collectives: eager, as the
        # meshed device driver's (``device_driver.py``, ``prepare``)
        row = self.k.ops.mesh
        self.graphs = SegmentGraphs(
            self.device, eager=eager or (row is not None and row.size > 1))
        B = bstate.phi.shape[0]
        dev = self.device

        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype, device=dev)

        self.ls = BatchLoopState(
            it=full((), 0, torch.int32),
            last_sigma_it=full((), -(10 ** 9), torch.int32),
            use_feas_org=full((B,), False, torch.bool),
            stage=full((B,), 1 if self.opts.scaling else 0, torch.int32),
            max_feas=full((B,), float("inf"), torch.float32),
            rel_gap=full((B,), float("inf"), torch.float32),
            done=full((B,), False, torch.bool),
            done_it=full((B,), -1, torch.int32),
            kkt_last=full((B, 7), float("inf"), torch.float32),
            active=full((B,), True, torch.bool),
            record=torch.zeros(len(RECORD), dtype=torch.float64, device=dev))
        # the host's mirror of the schedule
        self.h_it, self.h_last, self.h_done = 0, -(10 ** 9), False
        self.stats = {"syncs": 0, "checks": 0, "kkt_kernel_checks": 0,
                      "chunk_cuts": 0}
        self._kkt_on_kernel = self.k.kkt_on_kernel(instance(bstate, 0))
        self.t0 = time.monotonic()

    def _all_tensors(self) -> list:
        out = []
        for f in FIELDS:
            out += _blocks(getattr(self.s, f))
        return out + [getattr(self.s, f) for f in BATCH_SCALARS] \
            + self.ls.tensors()

    def _store(self, new: SolverState, fields) -> None:
        for f in fields:
            _copy_into(getattr(self.s, f), getattr(new, f))

    # -- the pieces that run as graphs ----------------------------------------
    def _tick(self) -> None:
        self.ls.it.add_(1)

    def _ca_prologue(self) -> None:
        _copy_into(self.s.z, self.k._fresh_x_batched(self.s, self.ls.active))

    def _ca_iteration(self, final: bool) -> None:
        new = self.k._step_fused_x_batched(self.s, final, self.ls.active)
        self._store(new, ("q", "z", "alpha", "beta")
                    + (("phi",) if final else ()))
        self._tick()

    def _plain_step(self) -> None:
        self._store(self.k._step_batched(self.s, self.ls.active), ITERATE)
        self._tick()

    def _segment(self, k: int) -> None:
        """k event-free iterations of the fleet (the JAX ``run_to``): the
        CA segment on the batched kernels, or k plain steps (PALM)."""
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

    def _per_instance(self, fn, s: SolverState) -> list:
        return [fn(instance(s, b)) for b in range(s.phi.shape[0])]

    def _check_block(self) -> None:
        """The JAX ``check_block`` (``batch.py:137-207``), operation for
        operation: the stop, the per-instance sigma factor, the rescale
        triggers on the old stage, max_feas and rel_gap, their update, and
        done_it and kkt_last; then the mask and the record. Under a mesh
        the norms of the rescale are the KKT battery's (the module
        docstring), so a check sums over the mesh once."""
        ls = self.ls
        k = self.k
        tol = self.opts.tol
        res = k.kkt_batched(self.s)
        kkt_org = torch.stack([r["kkt_org"] for r in res])   # (B, 7)
        kkt5 = torch.stack([r["kkt"] for r in res])          # (B, 5)
        pd_gap = torch.stack([r["pdGap"] for r in res])      # (B,)

        err = torch.stack([kkt_org[:, i] for i in self._stop_idx],
                          dim=1).amax(dim=1)
        newly_done = err < tol
        done = ls.done | newly_done
        done_it = torch.where(ls.done, ls.done_it,
                              torch.where(newly_done, ls.it, -1))
        use_org = ls.use_feas_org | (kkt5.amax(dim=1) < 5.0 * tol)

        # the per-instance sigma factor (1 where done or no table hit)
        pri = torch.where(use_org,
                          torch.maximum(kkt_org[:, 0], kkt_org[:, 1]),
                          torch.maximum(kkt5[:, 0], kkt5[:, 1]))
        dua = torch.where(use_org,
                          torch.maximum(kkt_org[:, 2], kkt_org[:, 4]),
                          torch.maximum(kkt5[:, 2], kkt5[:, 4]))
        table = _table_factor(pri / torch.clamp(dua, min=1e-30), UPDATE_RULE)
        sigma = self.s.sigma
        sigma_new = torch.clamp(sigma * table, SIGMA_BOUNDS[0],
                                SIGMA_BOUNDS[1])
        factor = torch.where(done, 1.0, sigma_new / sigma).to(sigma.dtype)
        s = sigma_mult(self.s, factor)

        # the rescale, aligned to the check cadence; (1, 1) is the identity
        norms = res if k.ops.mesh is not None \
            else self._per_instance(k._norms, s)
        n = {key: torch.stack([r[key] for r in norms]) for key in norms[0]}
        norm_phis = torch.maximum(torch.maximum(n["normPhi"], n["normQ"]),
                                  n["normZ"])
        norm_alps = torch.maximum(n["normAlpha"], n["normBeta"])
        ratio = torch.maximum(norm_alps, norm_phis) / torch.clamp(
            torch.minimum(norm_alps, norm_phis), min=1e-30)
        it1 = ls.it + 1
        t1 = ((ls.stage == 1) & (ls.max_feas < 2e-2) & (ls.rel_gap < 5e-2)
              & (it1 >= self.FIRST_ITER))
        t2 = ((ls.stage == 2) & (ls.max_feas < 5e-3) & (ls.rel_gap < 1e-2)
              & (it1 >= self.SECOND_ITER))
        t3 = (ls.stage >= 3) & (ratio > self.RATIO_THRESHOLD)
        trigger = (t1 | t2 | t3) & ~done
        one = torch.ones_like(norm_phis)
        d2 = torch.where(trigger, norm_phis, one)
        c2 = torch.where(trigger, norm_alps, one)
        s = rescale(s, d2, c2, k.RESCALED)
        stage = torch.where(trigger, ls.stage + 1, ls.stage)
        max_feas = torch.where(ls.stage > 0, kkt5.amax(dim=1),
                               ls.max_feas).to(torch.float32)
        rel_gap = torch.where(ls.stage > 0, pd_gap,
                              ls.rel_gap).to(torch.float32)

        self._store(s, FIELDS + BATCH_SCALARS)
        ls.last_sigma_it.copy_(ls.it)
        ls.use_feas_org.copy_(use_org)
        ls.stage.copy_(stage)
        ls.max_feas.copy_(max_feas)
        ls.rel_gap.copy_(rel_gap)
        ls.done.copy_(done)
        ls.done_it.copy_(done_it)
        ls.kkt_last.copy_(kkt_org.to(torch.float32))
        ls.active.copy_(~done)
        ls.record.copy_(torch.stack([done.all().to(torch.float64),
                                     ls.it.to(torch.float64)]))

    # -- the host's loop ------------------------------------------------------
    def _check(self) -> None:
        """A check: its graph, then the one host read of the record."""
        self.graphs.run("check", self._check_block)
        with self._sync_allowed():
            rec = dict(zip(RECORD, self.ls.record.tolist()))
        self.stats["syncs"] += 1
        self.stats["checks"] += 1
        self.stats["kkt_kernel_checks"] += self._kkt_on_kernel
        if int(rec["it"]) != self.h_it:
            raise RuntimeError(f"lockstep fleet: the card's iteration "
                               f"{int(rec['it'])} is not the host's "
                               f"{self.h_it}")
        self.h_done = bool(rec["all_done"])
        if self.mesh is not None:
            self.h_done = comm.all_true(self.h_done, self.mesh)
        self.h_last = self.h_it

    def _chunk(self, it_end: int) -> None:
        """The JAX chunk (``batch.py:228-255``): event-free segments to the
        next shared cadence point, a check there, until all are done or
        ``it_end``."""
        maxit = self.opts.maxit
        while not self.h_done and self.h_it < it_end:
            event = min(_next_check_it(self.h_it, self.h_last), maxit)
            stop = min(event, it_end)
            # a segment the chunk's end cuts short
            self.stats["chunk_cuts"] += stop < event
            k = max(stop - self.h_it, 0)
            self._segment(k)
            self.h_it += k
            if (self.h_it - self.h_last >= _cadence_gap(self.h_it)
                    or self.h_it >= maxit):
                self._check()

    def segment(self, k: int) -> None:
        """k event-free iterations from the current state, as the loop runs
        them (graphs after each kind's first use)."""
        with self._on_stream():
            self._segment(k)
        self.graphs.fold_launches()

    def solve(self, bstate: SolverState):
        """Run to convergence of all instances, ``maxit`` or ``time_limit``
        (checked between chunks of ``chunk_iters``, ``batch.py:259-283``).
        Returns (the loop state, seconds); the state is ``self.s``."""
        opts = self.opts
        self.prepare(bstate)
        try:
            with self._on_stream(), self._sync_debug():
                while not (self.h_it >= opts.maxit or self.h_done):
                    late = time.monotonic() - self.t0 > opts.time_limit
                    if self.mesh is not None:
                        late = comm.any_true(late, self.mesh)
                    if late:
                        break
                    self._chunk(min(self.h_it + self.chunk_iters,
                                    opts.maxit))
        finally:
            self.stats.update(captures=self.graphs.captures,
                              replays=self.graphs.replays,
                              eager_runs=self.graphs.eager_runs,
                              graph_kinds=self.graphs.kinds(),
                              fast_dct_iters=(self.h_it if self.k.fast_dct
                                              else 0),
                              dct_kernel_iters=(self.h_it
                                                if self.k.dct_kernel else 0))
            # the replays' launches go to LAUNCHES here
            self.graphs.release()
        return self.ls, time.monotonic() - self.t0


def replay_against_eager(make, bstate: SolverState, k: int = 40,
                         inactive=(), instance_b: Optional[int] = None,
                         single=None) -> list:
    """Graph replays of the lockstep loop held against eager runs on the
    card. Two drivers from ``make()`` take copies of ``bstate``, one
    replaying its pieces from CUDA graphs, one running them eagerly; the
    instances in ``inactive`` are marked done (frozen). Both run a
    2-iteration warm-up, then a k-iteration segment, a per-instance
    rescale (the norms on even instances, (1, 1) on odd ones) and k more,
    a per-instance sigma change (1.25 on odd instances, 1 on even) and k
    more. Returns, after each of the three segments, (what, the largest
    absolute difference over the drivers' tensors, the index of the first
    tensor that differs or None, whether every inactive instance's fields
    are bit-equal to where they started). With ``single`` (a prepared
    single-instance ``DeviceDriver`` of the same level) and
    ``instance_b``, a fourth entry holds instance ``instance_b`` of the
    replaying driver against ``single`` after both ran k more iterations
    from the same state: (what, largest difference, first differing field
    or None, the largest entry of the single driver's fields that
    differ). The kernels are bit-equal per instance; the DCT's products
    over the whole stack are cuBLAS's, whose rounding may depend on the
    batch (bit-equal at 129^2 x 33 on the H100, not at 17^2 x 9)."""
    def clone(s):
        return s.replace(**{f: getattr(s, f).clone() for f in FIELDS
                            + BATCH_SCALARS})

    start = clone(bstate)
    drivers = []
    for eager in (False, True):
        d = make()
        d.prepare(clone(bstate), eager=eager)
        for b in inactive:
            d.ls.done[b] = True
            d.ls.active[b] = False
        drivers.append(d)

    def both(fn):
        for d in drivers:
            with d._on_stream():
                fn(d)

    def rescale_event(d):
        def fn():
            norms = d._per_instance(d.k._norms, d.s)
            n = {key: torch.stack([r[key] for r in norms])
                 for key in norms[0]}
            phis = torch.maximum(torch.maximum(n["normPhi"], n["normQ"]),
                                 n["normZ"])
            alps = torch.maximum(n["normAlpha"], n["normBeta"])
            even = torch.arange(phis.shape[0], device=phis.device) % 2 == 0
            fire = even & d.ls.active
            one = torch.ones_like(phis)
            d._store(rescale(d.s, torch.where(fire, phis, one),
                             torch.where(fire, alps, one), d.k.RESCALED),
                     FIELDS + BATCH_SCALARS)
        d.graphs.run("rescale", fn)

    def sigma_event(d):
        def fn():
            odd = torch.arange(d.s.sigma.shape[0], device=d.device) % 2 == 1
            factor = torch.where(odd & d.ls.active, 1.25, 1.0).to(d.dtype)
            d._store(sigma_mult(d.s, factor), FIELDS + BATCH_SCALARS)
        d.graphs.run("sigma", fn)

    def frozen(d) -> bool:
        for b in inactive:
            for f in FIELDS + BATCH_SCALARS:
                for x, y in zip(_blocks(getattr(instance(d.s, b), f)),
                                _blocks(getattr(instance(start, b), f))):
                    if not torch.equal(x, y):
                        return False
        return True

    both(lambda d: d._segment(2))
    out = []
    for what, event in (("segment", None), ("after a rescale", rescale_event),
                        ("after a sigma change", sigma_event)):
        if event is not None:
            both(event)
        both(lambda d: d._segment(k))
        gap, first = 0.0, None
        for i, (a, b) in enumerate(zip(drivers[0]._all_tensors(),
                                       drivers[1]._all_tensors())):
            if torch.equal(a, b):
                continue
            first = i if first is None else first
            gap = max(gap, float((a.double() - b.double()).abs().max()))
        out.append((what, gap, first, all(frozen(d) for d in drivers)))
    if single is not None:
        d = drivers[0]
        view = instance(d.s, instance_b)
        for f in FIELDS:
            _copy_into(getattr(single.s, f), getattr(view, f))
        for f in BATCH_SCALARS:
            getattr(single.s, f).copy_(getattr(view, f))
        both(lambda dd: dd._segment(k))
        with single._on_stream():
            single._segment(k)
        view = instance(drivers[0].s, instance_b)
        gap, first, scale = 0.0, None, 0.0
        for f in FIELDS:
            for x, y in zip(_blocks(getattr(view, f)),
                            _blocks(getattr(single.s, f))):
                if not torch.equal(x, y):
                    first = f if first is None else first
                    gap = max(gap, float((x.double() - y.double())
                                         .abs().max()))
                    scale = max(scale, float(y.double().abs().max()))
        out.append((f"instance {instance_b} against the single-instance "
                    f"driver", gap, first, scale))
    return out


# -- solve_batch --------------------------------------------------------------

def _check_batch_mesh(mesh, opts: dict) -> None:
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: not a dotsocp_tpu_torch mesh "
                        f"(parallel/sharding.make_mesh)")
    if spatial_axes(mesh):
        # a mesh that splits the grid too: the halo engine on each batch row
        check_mesh_opts(opts, f"the batch x spatial mesh {mesh.shape}")


def _check_batch_request(method: str, opts: dict, mesh) -> None:
    _check_batch_mesh(mesh, opts)
    if method not in BATCH_METHODS:
        # the JAX solve_batch runs inPALM's step with tau = 1.0 for any
        # other method (``batch.py:326,340``); the port refuses
        raise ValueError(f"method {method!r}: the lockstep fleet runs "
                         f"{', '.join(BATCH_METHODS)}")
    for key, value in opts.items():
        if key in ("use_pallas", "layout"):
            _check_choice(key, value)
        elif key == "driver":
            if value not in ("auto", "device"):
                raise ValueError(f"driver={value!r}: the lockstep fleet "
                                 f"runs one device loop ('auto' or "
                                 f"'device')")
        elif key not in BATCH_OPTS | IGNORED_OPTS:
            raise ValueError(f"unknown option {key!r} of solve_batch")


def _device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false): the fleet runs on the card unless the "
                           "caller passes device='cpu'")
    return device


def _restrict_fleet(r: torch.Tensor) -> torch.Tensor:
    """The JAX ``vmap(restrict_density)``, renormalized per instance to unit
    mean (``batch.py:318-322``)."""
    rc = torch.stack([restrict_density(x) for x in r])
    return rc / rc.mean(dim=tuple(range(1, rc.ndim)), keepdim=True)


def solve_batch(rho0s, rho1s, nt: int, opts: Optional[dict] = None,
                method: str = "inPALM", dtype: torch.dtype = torch.float32,
                mesh=None, level_n: int = 1, verbose: bool = True, *,
                device="cuda"):
    """Multilevel lockstep solve of B same-shaped instances on ``device``
    (the card unless the caller asks for the CPU; without a card the
    default raises). ``rho0s`` / ``rho1s``: (B, *space). Methods inPALM,
    PALM (tau 1.9) and ALG2 (tau 1.0). ``mesh``: a mesh whose ``batch``
    axis (extent k, dividing B) splits the instances over its ranks, each
    rank solving B/k of them in lockstep; where its y/x/z/t axes split the
    grid too, each batch row holds its B/k instances' blocks on the halo
    engine (the module docstring); every rank of the world calls
    ``solve_batch`` alike and gets the whole fleet's results (a rank the
    mesh leaves out receives them from rank 0).

    Returns the JAX function's dict: ``rho`` (B, nt, *space) on ``device``,
    ``done`` (B,), ``done_it`` (B,) the final level's iteration at which
    each instance converged (-1: not), ``kkt`` (B, 7) the final level's
    last kkt_org rows (float32), ``iters`` (the shared iterations of all
    levels), ``time``; and ``levels``, one report a level (iterations,
    seconds, the loop's syncs, checks and graph counts). Documented
    deviations from the single-instance multilevel solve, as in the JAX
    package: rescales align to the check cadence, and no E2 feedback
    between levels (E2 = sqrt2 on every level; the JAX docstring's "E2
    inter-level feedback uses the batch-first instance" is not what its
    code does, and the port follows the code)."""
    opts = dict(opts or {})
    _check_batch_request(method, opts, mesh)
    if not (isinstance(level_n, int) and level_n >= 1):
        raise ValueError("level_n must be a positive integer")
    if mesh is None or not spatial_axes(mesh):
        warn_single_process_layout(opts, stacklevel=2)
    device = _device(device)
    if mesh is not None and mesh.size > 1:
        out = None
        if mesh.member:
            out = _solve_batch_sharded(rho0s, rho1s, nt, opts, method, dtype,
                                       mesh, level_n, verbose, device)
        if mesh.size < dist.get_world_size():
            # the ranks the mesh leaves out learn the fleet's result
            out = comm.broadcast_object(
                None if out is None else dict(out, rho=out["rho"].cpu()))
            out["rho"] = out["rho"].to(device)
        return out
    return _solve_batch(rho0s, rho1s, nt, opts, method, dtype, mesh,
                        level_n, verbose, device)


def _solve_batch_sharded(rho0s, rho1s, nt, opts, method, dtype, mesh,
                         level_n, verbose, device):
    """This rank's block of the fleet in lockstep, then every block's
    results gathered along the batch axis."""
    k = mesh.shape["batch"]
    B = np.shape(rho0s)[0]
    if B % k:
        raise ValueError(f"{B} instances do not split over a batch axis of "
                         f"{k} ranks")
    lo = mesh.coords["batch"] * (B // k)
    out = _solve_batch(np.asarray(rho0s)[lo:lo + B // k],
                       np.asarray(rho1s)[lo:lo + B // k], nt, opts, method,
                       dtype, mesh, level_n, False, device)

    # every rank of a batch row holds its instances' results whole
    def gather(x):
        return comm.all_gather(torch.as_tensor(x), 0, mesh, "batch").numpy()

    out.update(rho=comm.all_gather(out["rho"], 0, mesh, "batch"),
               done=gather(out["done"].astype(np.uint8)).astype(bool),
               done_it=gather(out["done_it"]), kkt=gather(out["kkt"]))
    if verbose and mesh.rank == mesh.ranks[0]:
        print(f"batch solve: B={B} over the mesh {mesh.shape}, "
              f"levels={level_n}, "
              f"all_done={bool(out['done'].all())}, iters={out['iters']}, "
              f"{out['time']:.2f}s")
    return out


def _solve_batch(rho0s, rho1s, nt, opts, method, dtype, mesh, level_n,
                 verbose, device):
    rho0s = torch.as_tensor(np.asarray(rho0s), device=device).to(dtype)
    rho1s = torch.as_tensor(np.asarray(rho1s), device=device).to(dtype)
    B = rho0s.shape[0]

    tol = float(opts.get("tol", 1e-4))
    tol_factor = -1.0 if tol > 0.99e-3 else -0.5
    tol_lower = 1e-5 if rho0s.ndim == 2 else 1e-4

    # the coarse pyramid: one geometry, per-instance densities
    r0s, r1s, nts, tols = [rho0s], [rho1s], [nt], [tol]
    for _ in range(level_n - 1):
        r0s.insert(0, _restrict_fleet(r0s[0]))
        r1s.insert(0, _restrict_fleet(r1s[0]))
        nts.insert(0, (nts[0] - 1) // 2 + 1)
        tols.insert(0, max(tols[0] * 2.0 ** tol_factor, tol_lower))

    kcls = PALMKernels if method == "PALM" else Kernels
    # under a spatial mesh the levels run on this rank's batch row, else on
    # the flat engine (``batch.py:358-370``)
    row = mesh.row() if mesh is not None and spatial_axes(mesh) else None
    npdtype = np.float64 if dtype == torch.float64 else np.float32
    sigma_b = np.full(B, float(opts.get("sigma", 1.0)))
    prev_lvs = None
    total_time = 0.0
    total_iters = 0
    reports = []
    for lev in range(level_n):
        o = SolveOptions(
            tol=tols[lev], maxit=int(opts.get("maxit", 3000)),
            sigma=1.0,  # the per-instance sigma goes to prep below
            tau=BATCH_METHODS[method],
            time_limit=float(opts.get("time_limit", 3600.0)),
            scaling=bool(opts.get("scaling", True)),
            label=f"level {lev + 1}")
        lvs = []
        for b in range(B):
            if prev_lvs is None:
                lv = initialize(r0s[lev][b], r1s[lev][b], nts[lev],
                                dtype=dtype, device=device)
            else:
                lv = _jump_next_level(prev_lvs[b], r0s[lev][b], r1s[lev][b],
                                      nts[lev], dtype)
            initial_scaling(lv, o.scaling)
            lvs.append(lv)
        cfg = LevelConfig(geom=lvs[0].geom, D=lvs[0].D, E=lvs[0].E,
                          device=str(device), tau=o.tau, dtype=dtype,
                          mesh=row)
        kernels = kcls(cfg)
        bstate = stack_states([kernels.prep(lv.as_dict(), float(sigma_b[b]))
                               for b, lv in enumerate(lvs)])
        driver = BatchedDeviceDriver(kernels, o, mesh=mesh)
        ls, elapsed = driver.solve(bstate)
        s = driver.s
        # one read: the counters, the decisions and every scalar
        vals = torch.cat(
            [ls.it.double().reshape(1), ls.done.double(),
             ls.done_it.double(), ls.kkt_last.double().reshape(-1)]
            + [getattr(s, f).double() for f in BATCH_SCALARS]).cpu().numpy()
        it = int(vals[0])
        done = vals[1:1 + B] > 0.5
        done_it = vals[1 + B:1 + 2 * B].astype(np.int32)
        kkt = vals[1 + 2 * B:1 + 9 * B].reshape(B, 7).astype(np.float32)
        scal = dict(zip(BATCH_SCALARS,
                        vals[1 + 9 * B:].reshape(len(BATCH_SCALARS), B)))
        total_time += elapsed
        total_iters += it
        reports.append({"level": lev + 1, "geom": lvs[0].geom, "iters": it,
                        "time": elapsed, "driver": dict(driver.stats)})
        for b in range(B):
            st = instance(s, b).replace(
                **{f: float(scal[f][b]) for f in BATCH_SCALARS})
            recover_org_var(lvs[b], kernels.finalize(st, lvs[b].as_dict()))
        if lev < level_n - 1:
            # the inter-level sigma (``batch.py:405-408``), in the state's
            # dtype as the JAX package reads it back, then float64
            sig = scal["sigma"].astype(npdtype)
            sig_scale = scal["sigmaScale"].astype(npdtype)
            sigma_out = (sig / np.maximum(sig_scale, npdtype(1e-300))
                         ).astype(npdtype)
            sigma_b = 10.0 ** (np.log10(np.maximum(
                sigma_b * sigma_out.astype(np.float64), 1e-300)) / 2.0)
            prev_lvs = lvs

    rho = torch.stack([recover_rho_e(lv)[0] for lv in lvs])
    if verbose:
        print(f"batch solve: B={B}, levels={level_n}, "
              f"all_done={bool(done.all())}, iters={total_iters}, "
              f"{total_time:.2f}s")
    return {"rho": rho, "done": done, "done_it": done_it, "kkt": kkt,
            "iters": total_iters, "time": total_time, "levels": reports}


# -- the fleet's front door ---------------------------------------------------

# The port's crossover on one card: where an instance has fewer
# time-staggered cells ((nt - 1) * prod(space)) than this, a lockstep fleet
# of 8 solves more instances a second than sequential solves do. Measured
# with chip_smoke.py phase 8d on an NVIDIA H100 80GB HBM3, 700.00 W power
# limit (demos/demo_batch.py's fleet, B = 8), the sequential solves on the
# solver cache (instance 0 prewarmed, the others on its levels' graphs),
# three runs: lockstep / sequential instances a second 1.55-1.64 at 8,712
# cells (33^2 x 9), 1.28-1.54 at 67,600, 1.07-1.28 at 532,512
# (129^2 x 33), 0.94-0.96 at 4,227,136 (257^2 x 65), 0.85-0.88 at
# 7,114,800 (385^2 x 49); the crossover, log-linear between 532,512 and
# 4,227,136 cells, 1.56M, 2.41M and 3.19M cells, here their median.
# (Without the cache, sequential solves rebuilt every level, and the
# crossover was 6.28M.) The lockstep fleet also holds B levels at once
# (22.5 GiB at 8 x 385^2 x 49 against 3.8 GiB sequential).
SATURATION_CELLS = 2_410_000


def pick_fleet_mode(B: int, space, nt: int, n_devices: int) -> str:
    """The fleet decision as code (``dotsocp_tpu/parallel/batch.py:
    436-452``): 'sharded' for 2+ ranks whose count shares a factor with B;
    on one rank 'sequential' where one instance has ``SATURATION_CELLS``
    cells or more, else 'lockstep'."""
    if n_devices >= 2 and math.gcd(B, n_devices) >= 2:
        return "sharded"
    cells = (nt - 1) * int(np.prod(space))
    return "sequential" if cells >= SATURATION_CELLS else "lockstep"


def solve_fleet(rho0s, rho1s, nt: int, opts: Optional[dict] = None,
                method: str = "inPALM", dtype: torch.dtype = torch.float32,
                level_n: int = 1, mode: str = "auto", mesh=None,
                verbose: bool = True, *, device="cuda"):
    """Solve a fleet of B independent same-shaped instances on ``device``,
    picking the mode (``mode="auto"``) from the instance's size and the
    number of ranks (``pick_fleet_mode``: the mesh's, else the world's).
    'sequential' runs the port's :func:`~..multilevel.solve.solve_dot`
    (``driver`` "auto" unless ``opts`` names one) one instance after
    another on its solver cache, with ``prewarm`` for instance 0 unless
    ``opts`` turns it off (``dotsocp_tpu/parallel/batch.py:505-512``), so
    instances 1 on start on the cached levels' replays; 'lockstep'
    :func:`solve_batch` on this rank, 'sharded'
    :func:`solve_batch` with the batch axis over ``mesh`` (default: a
    ``("batch",)`` mesh of gcd(B, world) ranks, which every rank of the
    world makes here). Returns :func:`solve_batch`'s dict plus ``mode``;
    sequential results carry each instance's final-level iterations in
    ``done_it`` and its final-level KKT row in ``kkt``."""
    _check_batch_mesh(mesh, dict(opts or {}))
    device = _device(device)
    rho0s = np.asarray(rho0s)
    rho1s = np.asarray(rho1s)
    B = rho0s.shape[0]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mode == "auto":
        n_dev = mesh.size if mesh is not None else world
        mode = pick_fleet_mode(B, rho0s.shape[1:], nt, n_dev)
    if verbose:
        print(f"solve_fleet: B={B}, mode={mode}")
    if mode == "sharded":
        if mesh is None:
            # the mesh's batch axis must divide B (``batch.py:474-477``)
            mesh = make_mesh(math.gcd(B, world), axis_names=("batch",),
                             device=device)
        return dict(solve_batch(rho0s, rho1s, nt, opts, method, dtype=dtype,
                                mesh=mesh, level_n=level_n, verbose=verbose,
                                device=device), mode="sharded")
    if mode == "lockstep":
        return dict(solve_batch(rho0s, rho1s, nt, opts, method, dtype=dtype,
                                level_n=level_n, verbose=verbose,
                                device=device), mode="lockstep")
    if mode != "sequential":
        raise ValueError(f"unknown fleet mode {mode!r}")
    from ..multilevel.solve import solve_dot

    opts = dict(opts or {})
    tol = float(opts.get("tol", 1e-4))
    rhos, kkts, done_it, done, reports = [], [], [], [], []
    total_time = 0.0
    total_iters = 0
    for b in range(B):
        o, _, h = solve_dot(
            rho0s[b], rho1s[b], nt, level_n,
            dict(opts, driver=opts.get("driver", "auto"),
                 prewarm=b == 0 and bool(opts.get("prewarm", True))),
            method, device=device, dtype=dtype, verbose=False)
        rhos.append(o["rho"])
        k = np.asarray(h["kkt"][-1])
        kkts.append(k)
        done.append(bool(np.max(k[[0, 2, 5, 6]]) < tol))
        done_it.append(o["levels"][-1]["iters"])
        total_iters += sum(lv["iters"] for lv in o["levels"])
        total_time += o["total_time"]
        reports.append(o["levels"])
    return {"rho": torch.stack(rhos), "done": np.asarray(done),
            "done_it": np.asarray(done_it), "kkt": np.stack(kkts),
            "iters": total_iters, "time": total_time, "levels": reports,
            "mode": "sequential"}
