"""The instance pool of a run: ``size`` pairs (rho0, rho1) of unit-mean
float32 densities on the configuration's grid, made on the run's device.

Slots named in ``stitch.slots`` hold the committed DOTmark ClassicImages
4-stitch pair (decoded as the program's image loader decodes it: gray / 255
+ 1e-12, then divided by its mean); the other slots hold pairs of DOTmark
CauchyDensity-class densities (mixtures of bivariate Cauchy densities), all
made in one batched computation from parameters that ``cauchy.pool_seed``
draws. A pool whose every slot holds the stitch pair has no ``cauchy``
block.

``--seed`` turns each pair by one of the eight symmetries of the square
(``orientation``): every seed gets other arrays, and so other answers to
check, while a solve's work (its iteration counts) stays that of the pair,
so that runs with different seeds do the same work. Each slot draws its
symmetry alone.

A pair's name (``slot_pairs``) is "stitch" or "cauchy<j>": the key of its
optimum's energy in a table of the reference (``tabulate_energies.py``).
"""
from __future__ import annotations

import os

import numpy as np


def orientations(seed: int, size: int) -> list:
    """The symmetry of each slot, 0..7, from ``seed``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x9E37])
    return [int(o) for o in rng.integers(0, 8, size)]


def _orient(x, o: int):
    """Symmetry ``o`` of the square on the last two axes: o % 4 quarter
    turns, then a flip of the columns where o >= 4."""
    import torch

    x = torch.rot90(x, o % 4, dims=(-2, -1))
    return torch.flip(x, dims=(-1,)) if o >= 4 else x


def cauchy_params(spec: dict, count: int) -> list:
    """Per density: (weights, centres (K, 2), scales) for ``count``
    densities, drawn from ``spec['pool_seed']``."""
    rng = np.random.default_rng(int(spec["pool_seed"]))
    out = []
    for _ in range(count):
        k = int(rng.integers(spec["bumps"][0], spec["bumps"][1] + 1))
        out.append((rng.uniform(*spec["weight"], k),
                    rng.uniform(*spec["center"], (k, 2)),
                    rng.uniform(*spec["scale"], k)))
    return out


def cauchy_densities(spec: dict, count: int, n: int, device):
    """(count, n, n) float64 on ``device``: each a sum of bivariate Cauchy
    densities s / (2 pi (|x - c|^2 + s^2)^(3/2)) on the unit square's n x n
    nodes, divided by its mean."""
    import torch

    params = cauchy_params(spec, count)
    kmax = max(len(w) for w, _, _ in params)
    w = np.zeros((count, kmax))
    c = np.full((count, kmax, 2), 0.5)
    s = np.ones((count, kmax))
    for i, (wi, ci, si) in enumerate(params):
        w[i, :len(wi)], c[i, :len(wi)], s[i, :len(wi)] = wi, ci, si
    f64 = dict(dtype=torch.float64, device=device)
    w, c, s = (torch.as_tensor(a, **f64) for a in (w, c, s))
    x = torch.linspace(0.0, 1.0, n, **f64)
    dy = x.view(1, 1, n, 1) - c[:, :, 0].view(count, kmax, 1, 1)
    dx = x.view(1, 1, 1, n) - c[:, :, 1].view(count, kmax, 1, 1)
    sk = s.view(count, kmax, 1, 1)
    dens = (w.view(count, kmax, 1, 1) * sk / (2.0 * np.pi) /
            (dy * dy + dx * dx + sk * sk) ** 1.5).sum(dim=1)
    return dens / dens.mean(dim=(1, 2), keepdim=True)


def stitch_pair(root: str, spec: dict):
    """The committed 4-stitch pair, float64 numpy, each divided by its
    mean."""
    with np.load(os.path.join(root, spec["file"])) as f:
        pair = [np.asarray(f[k], np.float64) / 255.0 + 1e-12
                for k in ("rho0", "rho1")]
    return [p / p.mean() for p in pair]


def slot_pairs(config: dict) -> list:
    """The name of the pair each slot holds: "stitch" for the slots of
    ``stitch.slots``, "cauchy<j>" for the j-th of the others."""
    spec = config["pool"]
    stitch = set(spec["stitch"]["slots"])
    others = [i for i in range(int(spec["size"])) if i not in stitch]
    if others and "cauchy" not in spec:
        raise ValueError(f"slots {others} hold no stitch pair and the pool "
                         "has no cauchy block")
    return ["stitch" if i in stitch else f"cauchy{others.index(i)}"
            for i in range(int(spec["size"]))]


def pairs(config: dict, device, root: str) -> dict:
    """The pool's distinct pairs, unturned: {name: (rho0, rho1)} float64
    (n, n) tensors on ``device``."""
    import torch

    spec = config["pool"]
    names = slot_pairs(config)
    out = {"stitch": tuple(torch.as_tensor(p, dtype=torch.float64,
                                           device=device)
                           for p in stitch_pair(root, spec["stitch"]))}
    count = sum(1 for name in names if name != "stitch")
    if count:
        dens = cauchy_densities(spec["cauchy"], 2 * count,
                                config["problem"]["n"], device)
        out.update((f"cauchy{j}", (dens[2 * j], dens[2 * j + 1]))
                   for j in range(count))
    return out


def make_pool(config: dict, seed: int, device, root: str) -> list:
    """The run's pool: ``size`` pairs of float32 (n, n) tensors on
    ``device``, in slot order."""
    import torch

    names = slot_pairs(config)
    base = pairs(config, device, root)
    orient = orientations(seed, len(names))
    return [tuple(_orient(r, o).to(torch.float32).contiguous()
                  for r in base[name])
            for name, o in zip(names, orient)]
