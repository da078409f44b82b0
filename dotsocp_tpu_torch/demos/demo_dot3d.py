"""Demo: 3D dynamic optimal transport, a capability beyond the reference
(the port of ``demos/demo_dot3d.py``).

Default config: 33^3 x nt=17, tol 1e-4, 2 levels, inPALM, float32.

    python -m dotsocp_tpu_torch.demos.demo_dot3d [--cpu] [--plot slices.png]
"""
from __future__ import annotations

import argparse

from ._common import add_device_flags, device_of, dtype_of, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="gaussian",
                    choices=["gaussian", "split8"])
    ap.add_argument("--n", type=int, default=33, help="spatial points/axis")
    ap.add_argument("--nt", type=int, default=17)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--method", default="inPALM",
                    choices=["PALM", "inPALM", "ALG2", "acc-ADMM"])
    ap.add_argument("--maxit", type=int, default=3000)
    add_device_flags(ap)
    ap.add_argument("--plot", default=None,
                    help="save a slices-over-time plot to path")
    args = ap.parse_args(argv)

    from ..models.examples import get_example_3d
    from ..multilevel.solve import solve_dot

    rho0, rho1 = get_example_3d(args.problem, args.n, args.n, args.n)
    result = solve_dot(rho0, rho1, args.nt, args.levels,
                       {"tol": args.tol, "maxit": args.maxit}, args.method,
                       device=device_of(args), dtype=dtype_of(args))
    out, _, h = result
    report(out, h, list(out["E"]))
    if args.plot:
        from ..viz.plots import show_evolution_3d

        show_evolution_3d(out["rho"], save=args.plot)
        print(f"saved {args.plot}")
    return result


if __name__ == "__main__":
    main()
