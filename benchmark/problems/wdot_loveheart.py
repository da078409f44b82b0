"""The weighted (obstacle) problem of the reference's ``demo_wdot2d.m``:
the love-heart pair moved round the love-heart barrier, whose wall faces
carry ``BARRIER_WEIGHT`` (1e6), judged by the weighted float64 reference
``benchlib/wreference.py``.

Every slot holds the love-heart pair with its walls zeroed (as the demo
makes it: ``get_example_w2d`` and ``ensure_barrier_validity``), turned by
the identity or the flip of the columns (``pool._orient`` 0 or 4, drawn
from ``--seed``): the barrier is even in x - 0.5 on the grid's nodes and
faces, so both keep the weight, and every slot passes the same ``weight``
and ``barrier`` objects, one solver-cache entry a level. The two
orientations share one optimum energy, so the table holds one pair.

Checks (``wreference.CHECKS``): ``continuity`` (the built-in one, on E
as the program returns it: w m, which is m off the walls), ``energy_gap`` (the
weighted energy against J_ref, the walls' terms and the near-vacuum nodes
handled as ``wreference`` says) and ``wall_mass`` (the largest share of a
time slab's mass inside the eroded walls: a path through a wall fails it).

The pool and the arguments build the program's input types from its model
module; the reference and the checks take them as tensors.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from benchlib import pool as P, wreference
from dotsocp_tpu_torch.models import wdot2d as W

STOP_ROWS = [0, 2, 5]   # a weighted solve checks no duality gap
CHECKS = wreference.CHECKS
PAIR = "love-heart"
BARRIER = "love-heart"
ORIENTATIONS = (0, 4)   # the identity and the flip of the columns


def _grid(config: dict):
    p = config["problem"]
    if p["dim"] != 2:
        raise ValueError("the love-heart problem is 2D")
    return int(p["n"]), int(p["nt"])


def _pair(config: dict):
    """The love-heart pair with its walls zeroed, float64 numpy (n, n),
    each of unit mean."""
    n, _ = _grid(config)
    r0, r1 = W.get_example_w2d(PAIR, n, n)
    r0, r1, _ = W.ensure_barrier_validity(r0, r1, W.barrier_love_heart())
    return r0, r1


def orientations(seed: int, size: int) -> list:
    """Each slot's symmetry, 0 or 4, from ``seed``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x4EA7])
    return [ORIENTATIONS[int(k)] for k in rng.integers(0, 2, size)]


def make_pool(config: dict, seed: int, device, root: str) -> list:
    import torch

    size = int(config["pool"]["size"])
    base = [torch.as_tensor(r, dtype=torch.float64, device=device)
            for r in _pair(config)]
    return [tuple(P._orient(r, o).to(torch.float32).contiguous()
                  for r in base)
            for o in orientations(seed, size)]


def _weight(config: dict, device):
    import torch

    n, nt = _grid(config)
    return W.get_weight_by_barrier(n, n, nt, W.barrier_love_heart(),
                                   dtype=torch.float32, device=device)


def _args(config: dict, device) -> dict:
    return {"weight": _weight(config, device),
            "barrier": W.barrier_love_heart()}


def slot_args(config: dict, seed: int, device, root: str) -> list:
    """One weight and one barrier for every slot."""
    return [_args(config, device)] * int(config["pool"]["size"])


def slot_pairs(config: dict) -> list:
    return [PAIR] * int(config["pool"]["size"])


def table_pairs(config: dict, device, root: str) -> dict:
    import torch

    r0, r1 = (torch.as_tensor(r, dtype=torch.float64, device=device)
              for r in _pair(config))
    return {PAIR: (r0, r1, _args(config, device))}


def _faces(weight) -> list:
    """The face weights of a shaped weight, whose time block must be 1
    (``wreference`` takes the time cells' weight as 1)."""
    if not bool((weight.q0 == 1).all()):
        raise ValueError("the weighted reference takes weight 1 on the "
                         "time cells")
    return list(weight.bs)


def reference_solve(config: dict, rho0, rho1, args: dict, **kw):
    """``wreference.solve`` of one instance with the slot's weight."""
    return wreference.solve(rho0, rho1, config["problem"]["nt"],
                            _faces(args["weight"]), **kw)


def tabled_optimum(rho0, rho1, args: dict, energy: float):
    return wreference.optimum_of(rho0, rho1, _faces(args["weight"]), energy)


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def table_key(config: dict) -> dict:
    """The grid, the reference block, the barrier, its wall weight and
    SHA-256 digests of the finest weight's face blocks and of the pair as
    a slot under the identity holds it (float32)."""
    p = config["problem"]
    weight = _weight(config, "cpu")
    return {"problem": {k: p[k] for k in ("dim", "n", "nt")},
            "reference": {k: v for k, v in config["reference"].items()
                          if k != "table"},
            "barrier": BARRIER, "barrier_weight": W.BARRIER_WEIGHT,
            "weight_sha256": _sha(*(b.numpy() for b in weight.blocks())),
            "pair_sha256": _sha(*(np.asarray(r, np.float32)
                                  for r in _pair(config)))}


def reference_sha256() -> str:
    """SHA-256 over the SHA-256s of ``wreference.py`` and the
    ``reference.py`` it imports."""
    here = os.path.dirname(os.path.abspath(wreference.__file__))
    h = hashlib.sha256()
    for name in ("wreference.py", "reference.py"):
        with open(os.path.join(here, name), "rb") as f:
            h.update(hashlib.sha256(f.read()).hexdigest().encode())
    return h.hexdigest()
