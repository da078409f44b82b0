#!/usr/bin/env python3
"""Fresh float32 solves of the port on the card, one line each: the
iterations per level and a digest of rho, for comparing two trees bit for
bit.

    python3 scripts/fresh_solves.py --root DIR TAG

runs the ``dotsocp_tpu_torch`` package found under DIR (default: this
tree) with ``reuse_solvers=False``: the headline (DOTmark-4stitch 129^2 x
33, 3 levels, inPALM), the sGS path (the same, sGS-inPALM), acc-ADMM and
PALM (example2 65^2 x 17, 2 levels), the weighted headline (love-heart
129^2 x 129, tol 1e-3) and the scale config (DOTmark 513^2 x 65). Each
line reads ``HASH TAG name [iterations] sha256-prefix``; two trees whose
lines agree computed every rho bit for bit alike. Needs a CUDA card.
"""
import argparse
import hashlib
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("fresh_solves: no CUDA card")
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    def run(name, r0, r1, nt, levels, opts, method="inPALM", weight=None,
            barrier=None):
        out, _, _ = solve_dot(r0, r1, nt, levels,
                              dict(opts, reuse_solvers=False), method,
                              weight, barrier, device="cuda",
                              dtype=torch.float32, verbose=False)
        rho = out["rho"].cpu().numpy()
        print("HASH", args.tag, name, [lv["iters"] for lv in out["levels"]],
              hashlib.sha256(rho.tobytes()).hexdigest()[:16], flush=True)

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    run("headline", r0, r1, 33, 3, {"tol": 1e-4})
    run("sgs", r0, r1, 33, 3, {"tol": 1e-4}, "sGS-inPALM")
    a0, a1 = get_example_2d("example2", 65, 65)
    run("acc", a0, a1, 17, 2, {"tol": 1e-4}, "acc-ADMM")
    run("palm", a0, a1, 17, 2, {"tol": 1e-4}, "PALM")
    n = 129
    barrier = W.barrier_love_heart()
    w0, w1 = W.get_example_w2d("love-heart", n, n)
    w0, w1, _ = W.ensure_barrier_validity(w0, w1, barrier)
    weight = W.get_weight_by_barrier(n, n, n, barrier, dtype=torch.float32,
                                     device="cuda")
    run("weighted", w0, w1, n, 3, {"tol": 1e-3}, "inPALM", weight, barrier)
    s0, s1 = get_example_2d("DOTmark_4stitch", 513, 513)
    run("scale", s0, s1, 65, 3, {"tol": 1e-4, "maxit": 3000})


if __name__ == "__main__":
    main()
