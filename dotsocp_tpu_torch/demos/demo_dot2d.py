"""Demo: 2D dynamic optimal transport (``demo_dot2d.m``; the port of
``demos/demo_dot2d.py``).

Default config matches the reference: nt=33, nx=ny=129, tol=1e-4, 3 levels,
DOTmark 4-stitch densities, algorithm selectable among all six, float32.

    python -m dotsocp_tpu_torch.demos.demo_dot2d [--cpu] [--problem example5]
"""
from __future__ import annotations

import argparse

from ._common import add_device_flags, device_of, dtype_of, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--problem",
        default="DOTmark_4stitch",
        choices=[
            "example1", "example2", "example3", "example4", "example5",
            "example7", "circle", "DOTmark_4stitch",
        ],
    )
    ap.add_argument("--nx", type=int, default=129)
    ap.add_argument("--ny", type=int, default=0, help="defaults to nx")
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument(
        "--method",
        default="inPALM",
        choices=["PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM", "acc-sGS-ADMM"],
    )
    ap.add_argument("--maxit", type=int, default=3000)
    add_device_flags(ap)
    ap.add_argument("--refine-tol", type=float, default=None,
                    help="mixed precision: the multilevel solve, then a "
                         "float64 tail to this KKT tolerance")
    ap.add_argument("--export", default=None,
                    help="publication export: .pdf/.png/.jpg frame series or .gif")
    ap.add_argument("--plot", default=None, help="save evolution plot to path")
    ap.add_argument("--images", nargs=2, default=None,
                    help="solve between two image files instead of --problem "
                         "(needs PIL)")
    args = ap.parse_args(argv)

    from ..models.examples import get_example_2d, get_example_from_images
    from ..multilevel.solve import solve_dot

    ny = args.ny or args.nx
    if args.images:
        rho0, rho1 = get_example_from_images(args.images[0], args.images[1],
                                             args.nx, ny)
    else:
        rho0, rho1 = get_example_2d(args.problem, args.nx, ny)
    opts = {"tol": args.tol, "maxit": args.maxit}
    if args.refine_tol is not None:
        opts["refine_tol"] = args.refine_tol
    result = solve_dot(rho0, rho1, args.nt, args.levels, opts, args.method,
                       device=device_of(args), dtype=dtype_of(args))
    out, _, h = result
    report(out, h, [out["Ey"], out["Ex"]])
    if args.plot:
        from ..viz.plots import show_evolution_2d

        show_evolution_2d(out["rho"], "imshow",
                          f"Density evolution of {args.method}", save=args.plot)
        print("saved", args.plot)
    if args.export:
        from ..viz.plots import export_evolution_2d

        paths = export_evolution_2d(out["rho"], args.export, mode="imshow",
                                    barrier_mask=None)
        print("exported", *paths)
    return result


if __name__ == "__main__":
    main()
