"""Demo: 1D dynamic optimal transport (``demo_dot1d.m``; the port of
``demos/demo_dot1d.py``).

Default config matches the reference: nt=33, nx=1025, tol=1e-5, 3 levels,
inPALM, Gaussian pair, float64.

    python -m dotsocp_tpu_torch.demos.demo_dot1d [--cpu] [--plot evo.png]
"""
from __future__ import annotations

import argparse

import torch

from ._common import add_device_flags, device_of, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="gaussian", choices=["gaussian", "box"])
    ap.add_argument("--nx", type=int, default=1025)
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--method", default="inPALM")
    ap.add_argument("--maxit", type=int, default=3000)
    add_device_flags(ap, f64_default=True)
    ap.add_argument("--f32", dest="f64", action="store_false",
                    help="run in float32 (the reference 1D tol of 1e-5 is "
                         "below its reach)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed precision: float32 multilevel to 1e-4, then "
                         "a float64 refinement tail to --tol on the finest "
                         "level")
    ap.add_argument("--plot", default=None, help="save evolution plot to path")
    args = ap.parse_args(argv)

    from ..models.examples import get_example_1d
    from ..multilevel.solve import solve_dot

    rho0, rho1 = get_example_1d(args.problem, args.nx)
    if args.mixed:
        opts = {"tol": max(args.tol, 1e-4), "maxit": args.maxit,
                "refine_tol": args.tol}
        dtype = torch.float32
    else:
        opts = {"tol": args.tol, "maxit": args.maxit}
        dtype = torch.float64 if args.f64 else torch.float32
    result = solve_dot(rho0, rho1, args.nt, args.levels, opts, args.method,
                       device=device_of(args), dtype=dtype)
    out, _, h = result
    report(out, h, [out["Ex"]])
    if args.plot:
        from ..viz.plots import show_evolution_1d

        show_evolution_1d(out["rho"], "join", save=args.plot)
        print("saved", args.plot)
    return result


if __name__ == "__main__":
    main()
