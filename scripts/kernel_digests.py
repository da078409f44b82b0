#!/usr/bin/env python3
"""Digests of the step kernels' outputs and of a few iterations on the
card, for finding the first tensor where two trees part bit for bit.

    python3 scripts/kernel_digests.py --root DIR TAG

With the ``dotsocp_tpu_torch`` package found under DIR (default: this
tree), on seeded inputs at 129^2 x 33 (float32, the scalars by value):
each step kernel's outputs; then from DOTmark-4stitch 129^2 x 33 after
initial scaling, the state after 1, 2 and 5 iterations of the CA segment
(``Kernels.run_segment``) and after a 5-iteration device-driver segment
(``DeviceDriver.segment``). One line each, ``DIGEST TAG what
sha256-prefix``, in a fixed order; the first line on which two trees
differ names the first tensor that differs. Needs a CUDA card.
"""
import argparse
import hashlib
import math
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_digests: no CUDA card")
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.staggered import Staggered

    dev = torch.device("cuda")

    def show(what, *tensors):
        h = hashlib.sha256()
        for t in tensors:
            for b in (t.blocks() if isinstance(t, Staggered) else [t]):
                h.update(b.detach().cpu().numpy().tobytes())
        print("DIGEST", args.tag, what, h.hexdigest()[:16], flush=True)

    geom = Geometry(33, (129, 129))
    ops = OpsFlat(geom, torch.float32, dev)
    rng = np.random.default_rng(0)
    d, nt, S, C = geom.ndim_space, geom.nt, ops.S, geom.cone_cols

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(dev)

    def stag():
        return Staggered(rand(nt - 1, S), rand(d, nt, S) * ops.masks)

    q, alpha, phi, beta, x = stag(), stag(), rand(nt, S), rand(C, nt - 1, S), \
        rand(C, nt - 1, S)
    D = math.sqrt(2.0) * math.sqrt(geom.h_mean)
    E = D / math.sqrt(2.0)
    sbf, sd, tau = E / D, E / (E * math.sqrt(2.0)), 1.9
    d_in, d_bd = diag_values(D, E)
    dinv = (1.0 / d_in, 1.0 / d_bd)
    weight = W.get_weight_by_barrier(129, 129, 33, W.barrier_love_heart(),
                                     dtype=torch.float32, device=dev)
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(weight), D, E)
    show("x_step", fs.x_step(ops, q, beta, sbf, sd))
    show("qx_step", *fs.qx_step(ops, phi, x, alpha.clone(), dinv, D, sbf,
                                tau))
    show("qx_step_w", *fs.qx_step(ops, phi, x, alpha.clone(), wdinv, D, sbf,
                                  tau))
    show("cx_step", *fs.cx_step(ops, beta.clone(), x.clone(), q, sbf, sd,
                                tau))
    show("cx_final", *fs.cx_final(ops, beta.clone(), x.clone(), q, sbf, sd,
                                  tau))
    show("z_step", fs.z_step(ops, q, beta, sbf, sd))
    show("q_step", *fs.q_step(ops, phi, x, beta, alpha, dinv, D, sbf, tau))
    show("q_step_w", *fs.q_step(ops, phi, x, beta, alpha, wdinv, D, sbf, tau))
    show("beta_step", fs.beta_step(ops, beta, x, q, sbf, sd, tau))
    show("cone_project_diff", fs.cone_project_diff(x, beta))

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    lv = initialize(r0, r1, 33, dtype=torch.float32, device=dev)
    initial_scaling(lv, True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cuda", tau=1.9)
    kern = Kernels(cfg)
    fields = ("phi", "q", "z", "alpha", "beta")
    for k in (1, 2, 5):
        s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), k)
        show(f"CA segment of {k}: " + ", ".join(fields),
             *(getattr(s, f) for f in fields))
    drv = DeviceDriver(kern, SolveOptions(tol=1e-4, maxit=3000, sigma=1.0,
                                          tau=1.9))
    drv.prepare(lv.as_dict())
    drv.segment(5)
    torch.cuda.synchronize()
    for f in fields:
        show(f"device driver segment of 5: {f}", getattr(drv.s, f))


if __name__ == "__main__":
    main()
