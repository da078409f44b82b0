"""Probe the batch x spatial fleet at the scale config on one CUDA card
(``chip_smoke.py`` phase 10f's sizing):

    python3 scripts/batch_spatial_probe.py --pairs   # which second instance
    python3 scripts/batch_spatial_probe.py --step    # where a step's time goes

``--pairs``: the one-card lockstep fleet (``solve_fleet(mode="lockstep")``,
513^2 x 65, 3 levels, tol 1e-4, float32, inPALM) of DOTmark 4-stitch beside
each candidate second instance (fleet_problems' example2, example1, circle
and two Gaussian pairs; DOTmark reversed and transposed): the shared
iterations of each level, each instance's done_it, wall, peak memory.

``--step``: the plain step of the fleet on the halo engine
(``Kernels._step_batched`` on a rank's blocks, one instance a batch row)
at the finest level, 513^2 x 65, float32, timed over 8 steps after 2,
with every collective of ``parallel/comm.py`` timed around a synchronize:
on a (y=2) world of 2 ranks and a (batch=2, y=2) world of 4, ranks sharing
the card over gloo; each with the comm layer's host staging as it is
(pageable) and with cached pinned host buffers (patched in here only);
and the plain step on one process on the whole grid. Also the KKT
battery of the blocks once.

Prints one JSON line a result; ``--out FILE`` also writes them all to
FILE. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 8


def pairs() -> dict:
    n, nt, levels, tol = cs.SCALE_CONFIG
    r0, r1 = cs.fleet_problems(n)
    d0, d1 = r0[5], r1[5]
    cands = {"example2": (r0[1], r1[1]), "example1": (r0[0], r1[0]),
             "reverse": (d1, d0), "transpose": (d0.T.copy(), d1.T.copy()),
             "gauss6": (r0[6], r1[6]), "gauss7": (r0[7], r1[7]),
             "circle": (r0[4], r1[4])}
    out = {}
    for name, (a, b) in cands.items():
        lock, wall, _, peak = cs.lockstep(torch, np.stack([d0, a]),
                                          np.stack([d1, b]), nt, levels, tol)
        out[name] = dict(iters=lock["iters"],
                         done_it=[int(v) for v in lock["done_it"]],
                         level_iters=[lv["iters"] for lv in lock["levels"]],
                         wall_s=wall, peak_gib=peak)
        print(json.dumps({name: out[name]}), flush=True)
        del lock
        torch.cuda.empty_cache()
    return out


def _pinned_staging() -> None:
    """The comm layer's gloo staging through cached pinned host buffers
    (the probe's variant; synchronous, every collective is timed around a
    synchronize here)."""
    import torch.distributed as dist

    from dotsocp_tpu_torch.parallel import comm

    cache = {}

    def buf(key, like):
        b = cache.get(key)
        if b is None:
            b = cache[key] = torch.empty(like.shape, dtype=like.dtype,
                                         pin_memory=True)
        return b

    def wire(t, mesh):
        if mesh.backend == "gloo" and t.device.type != "cpu":
            b = buf(("w", tuple(t.shape), t.dtype), t)
            b.copy_(t)
            return b
        return t.contiguous()

    def gather(t, mesh, group, size):
        w = wire(t, mesh)
        parts = [buf(("p", i, tuple(w.shape), w.dtype), w)
                 for i in range(size)]
        dist.all_gather(parts, w, group=group)
        comm._count(mesh, w)
        return [p.to(t.device) for p in parts]

    comm._wire, comm._gather = wire, gather


def _timed_comm() -> dict:
    from dotsocp_tpu_torch.parallel import comm

    acc = {"gather_s": 0.0, "gather_n": 0, "shifts_s": 0.0, "shifts_n": 0}
    inner = {"gather": comm._gather, "shifts": comm.shifts}

    def timed(kind):
        def fn(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[kind](*args)
            torch.cuda.synchronize()
            acc[f"{kind}_s"] += time.perf_counter() - t0
            acc[f"{kind}_n"] += 1
            return out
        return fn

    comm._gather, comm.shifts = timed("gather"), timed("shifts")
    return acc


def _level(row):
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    n, nt = cs.SCALE_CONFIG[:2]
    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device="cuda")
    initial_scaling(lv, True)
    k = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cuda",
                            dtype=torch.float32, mesh=row))
    return k, k.prep(lv.as_dict(), 1.0)


def rank_step(axes, pinned) -> dict:
    """One rank of a spawned world: the fleet's halo step, timed."""
    from dotsocp_tpu_torch.parallel.batch import stack_states
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    if pinned:
        _pinned_staging()
    mesh = make_mesh(axis_names=axes)
    k, s = _level(mesh.row())
    s = stack_states([s])
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    for _ in range(2):
        s = k._step_batched(s, active)
    acc = _timed_comm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s = k._step_batched(s, active)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    per_step = {key: v / STEPS * (1e3 if key.endswith("_s") else 1)
                for key, v in acc.items()}
    for key in acc:
        acc[key] = 0
    t0 = time.perf_counter()
    k.kkt_batched(s)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, mesh=dict(mesh.shape), pinned=pinned,
                step_ms=step_ms,
                gather_ms_per_step=per_step["gather_s"],
                gathers_per_step=per_step["gather_n"],
                shifts_ms_per_step=per_step["shifts_s"],
                shifts_per_step=per_step["shifts_n"],
                kkt_ms=1e3 * (time.perf_counter() - t0),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def step() -> dict:
    from dotsocp_tpu_torch.parallel.launch import run_world

    k, s = _level(None)
    for _ in range(2):
        s = k._step_plain(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s = k._step_plain(s)
    torch.cuda.synchronize()
    out = {"one_card_plain_step_ms":
           1e3 * (time.perf_counter() - t0) / STEPS}
    print(json.dumps(out), flush=True)
    del k, s
    torch.cuda.empty_cache()
    for world, axes in ((2, ("y",)), (4, ("batch", "y"))):
        for pinned in (False, True):
            key = f"{'x'.join(axes)}_{'pinned' if pinned else 'pageable'}"
            out[key] = run_world(rank_step, world, (axes, pinned),
                                 backend="gloo", device="cuda", timeout=300)
            print(json.dumps({key: out[key]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("batch_spatial_probe: needs a CUDA card")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    cs.build_kernels()
    out = {}
    if args.pairs:
        out["pairs"] = pairs()
    if args.step:
        out["step"] = step()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
