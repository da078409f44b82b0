"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and drives the program's public entry points in
a closed loop, one caller whose next call follows the return of the last.

    kind "stream": one ``solve_dot`` a call, over the pool's slots in order

``opts`` adds to the configuration's solver options; each slot's extra
arguments (its problem kind's ``slot_args``, made in set-up) follow the
call's own. A call's wall runs from the call to its return followed by
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Call:
    slots: list
    t0: float
    t1: float
    levels: list
    done: list
    total_time: Optional[float] = None
    # (slot, rho, Es, done) of the answers kept for the check, host tensors
    answers: list = field(default_factory=list)


class HostCopies:
    """Copies of the answers kept for the check into pinned host buffers
    made in set-up, on a side stream, so that the window neither waits for
    them nor allocates; past the buffers made, a plain copy."""

    def __init__(self, device, shapes: list, dtype, count: int):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.free = [[torch.empty(s, dtype=dtype, pin_memory=self.cuda)
                      for s in shapes] for _ in range(count)]
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def copy(self, tensors: list) -> list:
        if not self.free:
            return [t.cpu() for t in tensors]
        bufs = self.free.pop()
        if not self.cuda:
            return [b.copy_(t) for b, t in zip(bufs, tensors)]
        torch = self.torch
        self.stream.wait_stream(torch.cuda.current_stream(tensors[0].device))
        with torch.cuda.stream(self.stream):
            for b, t in zip(bufs, tensors):
                b.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
        return bufs

    def wait(self) -> None:
        if self.cuda:
            self.stream.synchronize()


def _numbers(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()
            if isinstance(v, (int, float, np.integer, np.floating))}


def _level(rep: dict) -> dict:
    out = {"iters": int(rep["iters"]), "time": float(rep["time"]),
           "build_s": float(rep.get("build_s", 0.0))}
    if isinstance(rep.get("driver"), dict):
        out["driver"] = _numbers(rep["driver"])
    return out


class Driver:
    """Drives one cell's traffic on its pool; ``call(i)`` makes the i-th
    call of the run and returns its :class:`Call`. ``args[slot]``: the
    slot's extra keyword arguments to ``solve_dot``; a call is done where
    the KKT rows ``stop_rows`` of its last level are under the tolerance."""

    def __init__(self, config: dict, traffic: dict, pool: list, device,
                 args: list, stop_rows: list):
        import torch

        self.torch = torch
        self.p = dict(config["problem"])
        self.traffic = traffic
        self.pool = pool
        self.args = args
        self.stop_rows = list(stop_rows)
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.p["dtype"])
        self.opts = {k: self.p[k] for k in ("tol", "driver", "layout",
                                            "reuse_solvers", "prewarm")}
        self.opts.update(traffic.get("opts", {}))
        self.tol = float(self.opts["tol"])
        if traffic["kind"] != "stream":
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
        self.copies = None

    def plan_copies(self, count: int) -> None:
        """Pinned buffers for ``count`` kept answers (rho and the momentum
        fields)."""
        n, nt, dim = self.p["n"], self.p["nt"], self.p["dim"]
        shapes = [(nt,) + (n,) * dim] * (1 + dim)
        self.copies = HostCopies(self.device, shapes, self.dtype, count)

    def _keep(self, tensors: list) -> list:
        if self.copies is None:
            return [t.cpu() for t in tensors]
        return self.copies.copy(tensors)

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def slots(self, i: int) -> list:
        return [i % len(self.pool)]

    def call(self, i: int, keep: list) -> Call:
        """The i-th call; the answers at positions ``keep`` of the call are
        copied out for the check."""
        from dotsocp_tpu_torch.multilevel.solve import solve_dot

        slots = self.slots(i)
        r0, r1 = self.pool[slots[0]]
        args = self.args[slots[0]]
        self._sync()
        t0 = time.perf_counter()
        out, _, _ = solve_dot(r0, r1, self.p["nt"], self.p["levels"],
                              dict(self.opts), self.p["method"],
                              device=self.device, dtype=self.dtype,
                              verbose=False, **args)
        self._sync()
        t1 = time.perf_counter()
        kkt = np.asarray(out["levels"][-1]["final_kkt"], np.float64)
        c = Call(slots=slots, t0=t0, t1=t1,
                 levels=[_level(r) for r in out["levels"]],
                 done=[bool(np.max(kkt[self.stop_rows]) < self.tol)],
                 total_time=float(out["total_time"]))
        if keep:
            rho, *Es = self._keep([out["rho"]] + list(out["E"]))
            c.answers.append((slots[0], rho, Es, c.done[0]))
        return c
