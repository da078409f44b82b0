"""Demo: fleet solve, many independent 2D transport problems through
``solve_fleet`` (a capability the reference lacks; the port of
``demos/demo_batch.py``). ``--mode auto`` (the default) picks sequential or
lockstep from the problem size on the one card, or sharded over the ranks
of a world; ``--mode sharded`` splits the batch axis over the ranks, one
process a rank: under ``torchrun --nproc-per-node=N`` (a card for each
rank), or with ``--spawn N``, which spawns the N ranks here (gloo, sharing
the card or the CPU). A world of one rank has no batch axis to split, and
``--mode sharded`` then raises. ``--axes batch,y`` shapes the ranks into a
mesh of those axes (``parallel/sharding.make_mesh``), whose y (x, t) axes
split each instance's grid too: each batch row then holds its instances'
blocks on the halo engine.

    python -m dotsocp_tpu_torch.demos.demo_batch [--cpu] [--batch 4]
    python -m dotsocp_tpu_torch.demos.demo_batch --mode sharded --spawn 2
    python -m dotsocp_tpu_torch.demos.demo_batch --mode sharded \
        --axes batch,y --spawn 4
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_flags, device_of, dtype_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--nx", type=int, default=65)
    ap.add_argument("--nt", type=int, default=17)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-4)
    add_device_flags(ap)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "sequential", "lockstep", "sharded"],
                    help="fleet execution mode (auto = decision table)")
    ap.add_argument("--spawn", type=int, default=0, metavar="N",
                    help="with --mode sharded: spawn N ranks here (gloo)")
    ap.add_argument("--axes", default=None, metavar="NAMES",
                    help="with --mode sharded: the mesh's axis names, "
                         "comma-separated (default: batch alone), e.g. "
                         "batch,y to split each grid too")
    args = ap.parse_args(argv)
    if args.axes and args.mode != "sharded":
        raise ValueError("--axes shapes the ranks of --mode sharded")

    if args.spawn:
        from ..parallel.launch import run_world

        return run_world(_solve, args.spawn, (args,), backend="gloo",
                         device=device_of(args))[0]
    if args.mode == "sharded":
        import torch.distributed as dist

        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            from ..parallel.distributed import initialize_distributed

            # torchrun's environment; a card for each rank unless --cpu
            initialize_distributed(device="cpu" if args.cpu else None)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < 2:
            raise ValueError(
                "--mode sharded splits the batch over two ranks or more; "
                "this is a world of one: run under torchrun "
                "--nproc-per-node=N or with --spawn N")
    return _solve(args)


def _solve(args):
    from ..models.examples import get_example_2d
    from ..multilevel.level import check_mass_conservation
    from ..parallel.batch import solve_fleet
    from ..parallel.distributed import is_coordinator

    rng = np.random.default_rng(0)
    r0s, r1s = [], []
    base0, base1 = get_example_2d("example2", args.nx, args.nx)
    for _ in range(args.batch):
        shift = int(rng.integers(0, args.nx // 4))
        r0s.append(np.roll(base0, shift, axis=1))
        r1s.append(np.roll(base1, -shift, axis=0))

    mesh = None
    if args.axes:
        from ..parallel.sharding import make_mesh

        mesh = make_mesh(axis_names=tuple(args.axes.split(",")),
                         device=device_of(args))
    out = solve_fleet(
        np.stack(r0s), np.stack(r1s), args.nt,
        {"tol": args.tol, "maxit": 3000},
        level_n=args.levels, dtype=dtype_of(args), mode=args.mode,
        mesh=mesh, device=device_of(args), verbose=is_coordinator(),
    )
    rho = out["rho"].detach().cpu()
    mass_ok = all(check_mass_conservation(r) for r in rho)
    kkt = np.asarray(out["kkt"])[:, [0, 2, 5, 6]].max(axis=1)
    if is_coordinator():
        print("mode:", out["mode"])
        print(f"Mass conservation: {'OK' if mass_ok else 'VIOLATED'}")
        print("per-instance max KKT:", kkt)
        print("Final KKT:", float(kkt.max()))
        print("converged:", out["done"], "at final-level iteration",
              out["done_it"])
        print(f"fleet time: {out['time']:.2f}s "
              f"({args.batch / out['time']:.2f} inst/s)")
    return dict(out, rho=rho, mass_ok=mass_ok)


if __name__ == "__main__":
    main()
