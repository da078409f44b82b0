"""A problem kind for the benchmark's tests: the built-in DOTmark problem
handed to ``solve_dot`` as a weighted one, with weight 1 on every cell and
face and no barrier. It takes the program's weighted path (the weight
pyramid, the weighted kernels, the weighted stop rows) and keeps the
optimum of the unweighted problem, so the built-in reference judges it."""
from __future__ import annotations

from benchlib import dotmark, reference

STOP_ROWS = [0, 2, 5]   # a weighted solve checks no duality gap
make_pool = dotmark.make_pool
slot_pairs = dotmark.slot_pairs
tabled_optimum = dotmark.tabled_optimum
table_key = dotmark.table_key
reference_sha256 = dotmark.reference_sha256


def mass(answer, optimum) -> float:
    """The largest departure of a time slab's mean density from 1."""
    rho, _ = answer
    return float((rho.double().mean(dim=tuple(range(1, rho.ndim))) - 1.0)
                 .abs().max())


CHECKS = dict(reference.CHECKS, mass=mass)


def unit_weight(config: dict, device):
    """Weight 1 on the finest grid's time cells and faces, as the program
    takes it (a shaped ``Staggered``)."""
    import torch

    from dotsocp_tpu_torch.ops.staggered import Staggered

    p = config["problem"]
    nt, space = p["nt"], (p["n"],) * p["dim"]
    kw = dict(dtype=getattr(torch, p["dtype"]), device=device)
    faces = tuple(torch.ones((nt,) + tuple(n - (i == a)
                                           for i, n in enumerate(space)),
                             **kw) for a in range(len(space)))
    return Staggered(q0=torch.ones((nt - 1,) + space, **kw), bs=faces)


def slot_args(config: dict, seed: int, device, root: str) -> list:
    """One weight for every slot: one entry of the solver cache."""
    args = {"weight": unit_weight(config, device), "barrier": None}
    return [args] * int(config["pool"]["size"])


def table_pairs(config: dict, device, root: str) -> dict:
    return {name: (r0, r1, {"weight": unit_weight(config, device),
                            "barrier": None})
            for name, (r0, r1, _) in
            dotmark.table_pairs(config, device, root).items()}


def reference_solve(config: dict, rho0, rho1, args: dict, **kw):
    """The built-in reference, which knows only the weight 1."""
    if not all(bool((b == 1).all()) for b in args["weight"].blocks()):
        raise ValueError("the unit-weight kind's reference takes weight 1 "
                         "alone")
    return dotmark.reference_solve(config, rho0, rho1, {}, **kw)

