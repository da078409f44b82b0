"""The built-in problem kind: unweighted dynamic OT between the DOTmark
pairs of ``pool.py``, judged by the float64 reference of ``reference.py``.

A configuration whose ``problem`` names no ``kind`` is of this kind. A kind
of its own is a module ``problems/<kind>.py`` that defines the same names
(``manifest.problem`` finds it; the benchmark's README lists them):

    make_pool(config, seed, device, root)   [(rho0, rho1)] on the device
    slot_args(config, seed, device, root)   each slot's extra keyword
                                            arguments to ``solve_dot``
    slot_pairs(config)                      each slot's pair name
    table_pairs(config, device, root)       {pair name: (rho0, rho1, args)}
    STOP_ROWS                               the KKT rows a solve stops on
    reference_solve(config, rho0, rho1, args, **kw)
    tabled_optimum(rho0, rho1, args, energy)
    table_key(config), reference_sha256()
    CHECKS                                  {name: (answer, optimum) -> float}
"""
from __future__ import annotations

import hashlib
import os

from . import pool, reference

STOP_ROWS = [0, 2, 5, 6]   # primal and dual feasibility, the gap
CHECKS = reference.CHECKS

make_pool = pool.make_pool
slot_pairs = pool.slot_pairs


def slot_args(config: dict, seed: int, device, root: str) -> list:
    """No slot passes more to ``solve_dot`` than the pair."""
    return [{} for _ in range(int(config["pool"]["size"]))]


def table_pairs(config: dict, device, root: str) -> dict:
    """The pool's distinct pairs, unturned, each with its slot's
    arguments (none)."""
    return {name: (r0, r1, {})
            for name, (r0, r1) in pool.pairs(config, device, root).items()}


def reference_solve(config: dict, rho0, rho1, args: dict, **kw):
    """The float64 reference's solve of one instance (``reference.solve``:
    ``kw`` its levels, tolerances, iteration limit, device and
    rounding)."""
    return reference.solve(rho0, rho1, config["problem"]["nt"], **kw)


def tabled_optimum(rho0, rho1, args: dict, energy: float):
    return reference.Optimum(rho0, rho1, energy)


def table_key(config: dict) -> dict:
    """What a table of optimum energies holds for: the grid, the reference
    block and what makes the pool's pairs (the stitch file, the Cauchy
    draw)."""
    p, spec = config["problem"], config["pool"]
    return {"problem": {k: p[k] for k in ("dim", "n", "nt")},
            "reference": {k: v for k, v in config["reference"].items()
                          if k != "table"},
            "pairs_from": {"stitch": spec["stitch"]["file"],
                           "cauchy": spec.get("cauchy")}}


def reference_sha256() -> str:
    """SHA-256 of ``benchlib/reference.py``, the code a table was made
    by."""
    with open(os.path.join(os.path.dirname(__file__), "reference.py"),
              "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()
