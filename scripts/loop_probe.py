#!/usr/bin/env python3
"""Where a warm solve of the benchmark's ``dotmark129_stream`` cell goes,
on the card: the level loops' host launch and record-wait split, untraced,
and the device kernels an iteration under ``torch.profiler``.

    python3 scripts/loop_probe.py [--root DIR] [--solves 16] [--traced 4]
                                  [--seed 7] [--out FILE] [--ca-nodes]

It makes the cell's pool (``benchmark/benchlib/pool.py``) from ``--seed``,
warms up with two solves (the first fills the solver cache and captures
the CUDA graphs), then times ``--solves`` solves one after another, each
ended by a synchronize: wall, ``total_time``, the level loops (Σ level
``time``), their host launches (Σ ``driver["launch_s"]``) and record
waits (Σ ``driver["wait_s"]``), replays and iterations; medians printed.
Then ``--traced`` more solves under the profiler: device kernels (and
copies) per iteration, by name, with their device time per iteration.
``--ca-nodes`` adds the device operations of one CA iteration as the
device driver replays it on the cell's finest level (the 4-stitch pair):
a 12-iteration segment's minus a 4-iteration segment's, over 8, each
replayed from its graphs under the profiler.

``--root`` names the checkout whose ``dotsocp_tpu_torch`` and benchmark
pool are used (default: the working directory), so one copy of this
script measures two commits. The last line of standard output is the
JSON of every number; ``--out`` writes it to a file too. Card only: it
exits 1 without one.
"""
import argparse
import json
import os
import statistics
import sys
import time


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.getcwd())
    p.add_argument("--solves", type=int, default=16)
    p.add_argument("--traced", type=int, default=4)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    p.add_argument("--ca-nodes", action="store_true")
    return p.parse_args(argv)


def _solve(torch, solve_dot, problem, pair, opts):
    r0, r1 = pair
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, _ = solve_dot(r0, r1, problem["nt"], problem["levels"],
                          dict(opts), problem["method"], device="cuda",
                          dtype=getattr(torch, problem["dtype"]),
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    levels = out["levels"]

    def drv(key):
        return sum(float(lv.get("driver", {}).get(key, 0.0))
                   for lv in levels)

    return {"wall_ms": 1e3 * wall, "total_ms": 1e3 * out["total_time"],
            "loop_ms": 1e3 * sum(lv["time"] for lv in levels),
            "launch_ms": 1e3 * drv("launch_s"),
            "wait_ms": 1e3 * drv("wait_s"), "replays": drv("replays"),
            "syncs": drv("syncs"),
            "iters": sum(int(lv["iters"]) for lv in levels)}


def _device_ops(torch, prof):
    """{name: (count, device microseconds)} of the device-side events: the
    kernels and copies (the program's ``dotsocp.`` ranges, which the
    profiler also lists on the device, left out)."""
    from torch.autograd import DeviceType

    ops = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("dotsocp."):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        n, t = ops.get(e.key, (0, 0.0))
        ops[e.key] = (n + e.count, t + us)
    return ops


def ca_nodes(torch):
    """{name: device operations of one CA iteration} of the device
    driver's replays at the cell's finest level."""
    from torch.profiler import ProfilerActivity, profile

    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    lv = initialize(r0, r1, 33, dtype=torch.float32, device="cuda")
    initial_scaling(lv, True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cuda", tau=1.9,
                      dtype=torch.float32)
    d = DeviceDriver(Kernels(cfg), SolveOptions())
    d.prepare(lv.as_dict())
    counts = {}
    for k in (4, 12):
        for _ in range(3):   # eager, capture, replay
            d.segment(k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            d.segment(k)
            torch.cuda.synchronize()
        counts[k] = {n: c for n, (c, _) in _device_ops(torch, prof).items()}
    names = set(counts[4]) | set(counts[12])
    per = {n: (counts[12].get(n, 0) - counts[4].get(n, 0)) / 8 for n in names}
    return {n: v for n, v in per.items() if v}


def main(argv=None):
    args = _args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "benchmark"))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("loop_probe: no CUDA card", file=sys.stderr)
        return 1
    from benchlib import manifest, pool as pool_mod

    from dotsocp_tpu_torch.multilevel.solve import (clear_solver_cache,
                                                    solve_dot)
    from dotsocp_tpu_torch.ops import fused_step

    spec = manifest.cell(root, "dotmark129_stream",
                         os.path.join(root, "benchmark"))
    problem = spec["config"]["problem"]
    opts = {k: problem[k] for k in ("tol", "driver", "layout",
                                    "reuse_solvers", "prewarm")}
    pool = pool_mod.make_pool(spec["config"], args.seed,
                              torch.device("cuda"), root)
    clear_solver_cache()
    for i in range(2):
        _solve(torch, solve_dot, problem, pool[i % len(pool)], opts)
    fused_step.reset_launches()
    runs = [_solve(torch, solve_dot, problem, pool[i % len(pool)], opts)
            for i in range(args.solves)]
    launches = dict(fused_step.LAUNCHES)
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    iters = sum(r["iters"] for r in runs)
    print(f"untraced, {args.solves} solves (medians): " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()))
    print(f"  card time an iteration ~ (launch + wait) / iters: "
          f"{1e3 * (med['launch_ms'] + med['wait_ms']) / med['iters']:.1f} "
          f"us; launches a solve: " + ", ".join(
              f"{k} {v / args.solves:.1f}" for k, v in launches.items()
              if v))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [_solve(torch, solve_dot, problem,
                         pool[(args.solves + i) % len(pool)], opts)
                  for i in range(args.traced)]
    t_iters = sum(r["iters"] for r in traced)
    ops = _device_ops(torch, prof)
    n_ops = sum(n for n, _ in ops.values())
    busy_us = sum(t for _, t in ops.values())
    print(f"traced, {args.traced} solves, {t_iters} iterations: "
          f"{n_ops / t_iters:.2f} device ops and {busy_us / t_iters:.1f} us "
          f"of device time an iteration (checks included)")
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in top[:20]:
        print(f"  {n / t_iters:6.2f}/it {us / t_iters:8.2f} us/it  "
              f"{name[:100]}")
    clear_solver_cache()
    nodes = None
    if args.ca_nodes:
        nodes = ca_nodes(torch)
        print(f"one CA iteration as the device driver replays it at "
              f"129^2 x 33: {sum(nodes.values()):.2f} device operations")
        for name, n in sorted(nodes.items(), key=lambda kv: -kv[1]):
            print(f"  {n:5.2f}  {name[:100]}")
    result = {"card": torch.cuda.get_device_name(0), "root": root,
              "ca_nodes": nodes,
              "seed": args.seed, "untraced": {"median": med, "runs": runs,
                                              "iters": iters,
                                              "launches": launches},
              "traced": {"iters": t_iters, "ops_per_iter": n_ops / t_iters,
                         "device_us_per_iter": busy_us / t_iters,
                         "runs": traced,
                         "top": [[k, n / t_iters, us / t_iters]
                                 for k, (n, us) in top[:40]]}}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
