#!/usr/bin/env python3
"""Readings of a cell's control, from which its limits are set; the
benchmark's own runs never run this.

    python3 benchmark/control.py --workload <name> --kind <kind> \\
        --seeds <n> [<n> ...] --seconds <s>

Each seed makes one run of the cell (set-up, a window of ``--seconds``,
the reference's checks) in this process, and prints one JSON line: every
checked answer's number for each of the cell's checks, and how many of
the window's instances the solver itself reported solved.

    sound  the program as the configuration states it (the lower reading)
    tf32   the plain reference of the cell's problem kind put in the
           program's place, computed in TF32 (float32 with every iterate
           rounded to TF32's 10 mantissa bits: the precision below the
           configuration's float32 with TF32 off) to the configuration's
           tolerance, and judged by the float64 reference like any answer
           (the upper reading)
"""
import argparse
import json
import os
import sys
import time

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.abspath(__file__))
KINDS = ("sound", "tf32")


def reference_in_place(spec: dict, rounding: str, put=setattr,
                       bench_dir: str = BENCH) -> None:
    """Put the reference of the cell's problem kind, computed with
    ``rounding``, in the place of the program's entry point (``put`` sets
    an attribute, e.g. pytest's ``monkeypatch.setattr``), at the
    configuration's tolerance and levels and the program's default of 3000
    iterations a level. The slot's extra arguments reach it as they would
    reach the program."""
    import numpy as np
    import torch

    from benchlib import manifest
    from dotsocp_tpu_torch.multilevel import solve as solve_mod

    config = spec["config"]
    kind = manifest.problem(config, bench_dir)
    p = config["problem"]

    def one(r0, r1, opts, args):
        sol = kind.reference_solve(config, r0, r1, args, levels=p["levels"],
                                   tol=float(opts["tol"]),
                                   coarse_tol=float(opts["tol"]),
                                   maxit=int(opts.get("maxit", 3000)),
                                   device=torch.as_tensor(r0).device,
                                   rounding=rounding)
        return sol, bool(sol.residual < float(opts["tol"]))

    def solve_dot(r0, r1, nt, levels, opts, method, device=None,
                  dtype=torch.float32, verbose=False, **args):
        t0 = time.monotonic()
        sol, done = one(r0, r1, opts, args)
        kkt = np.full(7, 0.0 if done else np.inf)
        return {"rho": sol.rho.to(dtype), "E": [e.to(dtype) for e in sol.E],
                "levels": [{"iters": it, "time": 0.0, "final_kkt": kkt}
                           for it in sol.iters],
                "total_time": time.monotonic() - t0}, None, None

    put(solve_mod, "solve_dot", solve_dot)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=KINDS, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import torch

    from benchlib import cell, manifest

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    spec = manifest.cell(ROOT, args.workload)
    if args.kind == "tf32":
        reference_in_place(spec, "tf32")
    for seed in args.seeds:
        # the control's calls are the reference's: one warm-up times a call
        res, rec = cell.run(ROOT, args.workload, seed, args.seconds, False,
                            spec=spec, warmups=2 if args.kind == "sound"
                            else 1)
        solved = sum(sum(c.done) for c in rec.calls)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "card": rec.card,
                          "attempted": res["attempted"], "solved": solved,
                          "slots": rec.checks["slots"],
                          "reference_s": rec.checks["reference_s"],
                          "values": rec.checks["values"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
