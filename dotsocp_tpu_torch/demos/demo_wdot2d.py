"""Demo: weighted 2D DOT with obstacles (``demo_wdot2d.m``; the port of
``demos/demo_wdot2d.py``).

Default config matches the reference: nt=nx=ny=129, tol=1e-3, 3 levels,
love-heart barrier, inPALM, float32.

    python -m dotsocp_tpu_torch.demos.demo_wdot2d [--cpu] \\
        [--problem maze14 --barrier maze14]
"""
from __future__ import annotations

import argparse

from ._common import add_device_flags, device_of, dtype_of, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--problem",
        default="love-heart",
        choices=[
            "example1", "example2", "example3", "example4", "circle",
            "circle2", "example6", "maze14", "love-heart",
        ],
    )
    ap.add_argument(
        "--barrier",
        default="love-heart",
        choices=["love-heart", "circle-pillar", "maze14", "example6", "none"],
    )
    ap.add_argument("--weight", default="barrier",
                    choices=["barrier", "circle", "circleInv"])
    ap.add_argument("--nx", type=int, default=129)
    ap.add_argument("--nt", type=int, default=129)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--method", default="inPALM",
                    choices=["inPALM", "ALG2", "acc-ADMM"])
    ap.add_argument("--maxit", type=int, default=10000)
    add_device_flags(ap)
    ap.add_argument("--export", default=None,
                    help="publication export: .pdf/.png/.jpg frame series or .gif")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    from ..models import wdot2d as W
    from ..multilevel.solve import solve_dot

    device, dtype = device_of(args), dtype_of(args)
    nx = ny = args.nx
    nt = args.nt
    rho0, rho1 = W.get_example_w2d(args.problem, nx, ny)

    barrier = None
    mask = None
    if args.barrier != "none":
        barrier = {
            "love-heart": W.barrier_love_heart,
            "circle-pillar": W.barrier_circle_pillar,
            "maze14": W.barrier_maze14,
            "example6": W.barrier_example6,
        }[args.barrier]()
        rho0, rho1, mask = W.ensure_barrier_validity(rho0, rho1, barrier)

    if args.weight == "barrier":
        weight = W.get_weight_by_barrier(nx, ny, nt, barrier, dtype=dtype,
                                         device=device)
    elif args.weight == "circle":
        weight = W.gene_weight_circle(nt, nx, ny, dtype=dtype, device=device)
    else:
        weight = W.gene_weight_circle_inv(nt, nx, ny, dtype=dtype,
                                          device=device)

    result = solve_dot(rho0, rho1, nt, args.levels,
                       {"tol": args.tol, "maxit": args.maxit}, args.method,
                       weight, barrier, device=device, dtype=dtype)
    out, _, h = result
    report(out, h)
    if args.plot:
        from ..viz.plots import show_evolution_2d

        show_evolution_2d(out["rho"], "contourf",
                          f"Density evolution of {args.method}",
                          barrier_mask=mask, save=args.plot)
        print("saved", args.plot)
    if args.export:
        from ..viz.plots import export_evolution_2d

        paths = export_evolution_2d(out["rho"], args.export, mode="contourf",
                                    barrier_mask=mask)
        print("exported", *paths)
    return result


if __name__ == "__main__":
    main()
