"""Weighted-DOT problem layer: densities, barriers and staggered weights
(the reference's ``examples/wdot2d``); a copy of
``dotsocp_tpu/models/wdot2d.py`` whose weights are the port's
:class:`~dotsocp_tpu_torch.ops.staggered.Staggered` in torch.

A barrier is a callable ``barrier(x, y) -> bool array`` over broadcastable
coordinate arrays (x horizontal in [0,1], y vertical in [0,1]). Weights live
on the staggered grid, shaped layout: ``q0`` ``(nt-1, ny, nx)`` and one face
block per axis; the time block is identically 1
(``get_weight_by_barrier.m:33-36``).

The maze of ``barrier_maze14`` is the wall mask of the JAX package's
``maze-14.png``, committed bit-packed as ``resources/maze14_mask.npz``
(``scripts/make_dotmark_npz.py --maze14``), so no image library is needed;
``barrier_from_image`` and an explicit ``resources`` directory decode image
files with PIL, imported only then.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from .examples import (RESOURCES, _grid2d, _normalize, gene_example1,
                       gene_example2, gene_example3, gene_example4,
                       gene_example_circle)

BARRIER_WEIGHT = 1e6  # wall weight (``get_weight_by_barrier.m:8-10``; the
# reference's barrierWeight argument is dead code: 1e6 always wins)

MAZE14_MASK = os.path.join(RESOURCES, "maze14_mask.npz")


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------

def _disc_density(nx, ny, center, r):
    y, x = _grid2d(nx, ny)
    return ((x - center[0]) ** 2 + (y - center[1]) ** 2 < r * r).astype(np.float64)


def gene_example_circle2(nx, ny):
    """Discs used with the rectangle obstacle (``gene_exampleCircle2.m``)."""
    scale = 40.0
    r1, r2, r3 = 5 / scale, 4 / scale, 3 / scale
    rho0 = _disc_density(nx, ny, (r1 / 2 + 0.1, 0.475), r1)
    rho1 = _disc_density(nx, ny, (r2 / 2 + 0.1, 0.95 - r2), r2) + _disc_density(
        nx, ny, (r3 / 2 + 0.1, r3 + 0.05), r3
    )
    return rho0, np.minimum(rho1, 1.0)


def _truncated_gaussian(nx, ny, center, r):
    """Gaussian truncated to a disc (``gene_example6.m``; the reference's
    (X, Y) are (row, col) coordinates, i.e. (y, x) here)."""
    sigma = r / 3.0
    y, x = _grid2d(nx, ny)
    g = np.exp(-(((y - center[0]) ** 2) + (x - center[1]) ** 2) / (2 * sigma**2))
    g[((y - center[0]) ** 2 + (x - center[1]) ** 2) > r * r] = 0.0
    return g


def gene_example6(nx, ny):
    return (
        _truncated_gaussian(nx, ny, (0.925, 0.075), 0.09),
        _truncated_gaussian(nx, ny, (0.075, 0.925), 0.09),
    )


def gene_example_love_heart(nx, ny):
    return (
        _truncated_gaussian(nx, ny, (0.7, 0.3), 0.09),
        _truncated_gaussian(nx, ny, (0.345, 0.625), 0.09),
    )


def gene_example_maze14(nx, ny):
    """Densities for the maze of [Papadakis-Peyre-Oudet 2014]: blobs at the
    entrance and exit corners (procedural; the maze itself is an image
    barrier)."""
    y, x = _grid2d(nx, ny)
    rho0 = np.exp(-(((x - 0.5) ** 2) + (y - 0.5) ** 2) / (2 * 0.05**2))
    rho1 = np.exp(-(((x - 0.05) ** 2) + (y - 0.05) ** 2) / (2 * 0.05**2))
    return rho0, rho1


def get_example_w2d(problem: str, nx: int, ny: int, lower_bound: float = 0.0):
    gens = {
        "example1": gene_example1,
        "example2": gene_example2,
        "example3": gene_example3,
        "example4": gene_example4,
        "circle": gene_example_circle,
        "circle2": gene_example_circle2,
        "example6": gene_example6,
        "maze14": gene_example_maze14,
        "love-heart": gene_example_love_heart,
    }
    if problem not in gens:
        raise ValueError(f"unknown weighted-2D problem {problem!r}")
    rho0, rho1 = gens[problem](nx, ny)
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


# ---------------------------------------------------------------------------
# barriers (predicates over (x, y))
# ---------------------------------------------------------------------------

def barrier_circle_pillar() -> Callable:
    """Circle + two pillars (``gene_barrier_of_circle_pillar.m``)."""

    def barrier(x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        return (
            ((x >= 0.2) & (x <= 0.25) & (y >= 0.4) & (y <= 1.0))
            | ((x >= 0.75) & (x <= 0.8) & (y >= 0.0) & (y <= 0.6))
            | ((x - 0.5) ** 2 + (y - 0.5) ** 2 <= 0.15**2)
        )

    return barrier


def barrier_love_heart() -> Callable:
    """Implicit heart-curve annulus (``gene_barrier_of_love_heart.m``)."""

    def heart(x, y, s):
        u = s * (np.asarray(x) - 0.5)
        v = s * (np.asarray(y) - 0.5)
        return (u * u + v * v - 1.0) ** 3 - u * u * v**3

    def barrier(x, y):
        return (heart(x, np.asarray(y) + 0.05, 2.5) > 0) | (heart(x, y, 15.0) <= 0)

    return barrier


def _mask_barrier(mask: np.ndarray) -> Callable:
    """Nearest-neighbour predicate of a boolean (h, w) image mask over
    [0, 1]^2, row 0 at y = 0 (``dotsocp_tpu/models/wdot2d.py:146-153``)."""
    h, w = mask.shape

    def barrier(x, y):
        x = np.clip(np.asarray(x), 0.0, 1.0)
        y = np.clip(np.asarray(y), 0.0, 1.0)
        i = np.round(y * (h - 1)).astype(int)
        j = np.round(x * (w - 1)).astype(int)
        return mask[i, j]

    return barrier


def barrier_from_image(path: str, threshold: float = 0.5,
                       invert: bool = False) -> Callable:
    """Nearest-neighbour barrier interpolant from a maze image
    (``gene_barrier_of_maze14.m`` / ``gene_barrier_of_example6.m``); needs
    PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL is needed to read an arbitrary image file; "
                          "barrier_maze14 reads its committed mask") from e
    img = np.asarray(Image.open(path).convert("L"), np.float64) / 255.0
    return _mask_barrier((img < threshold) if not invert
                         else (img > threshold))


def _maze_procedural() -> Callable:
    """The JAX package's procedural labyrinth: concentric square walls with
    alternating gaps (``dotsocp_tpu/models/wdot2d.py:156-174``)."""

    def barrier(x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        d = np.maximum(np.abs(x - 0.5), np.abs(y - 0.5))
        ring = ((d > 0.12) & (d < 0.15)) | ((d > 0.24) & (d < 0.27)) | (
            (d > 0.36) & (d < 0.39)
        )
        gap1 = (np.abs(y - 0.5) < 0.03) & (x > 0.5) & (d > 0.1) & (d < 0.16)
        gap2 = (np.abs(x - 0.5) < 0.03) & (y < 0.5) & (d > 0.22) & (d < 0.28)
        gap3 = (np.abs(y - 0.5) < 0.03) & (x < 0.5) & (d > 0.34) & (d < 0.40)
        return ring & ~(gap1 | gap2 | gap3)

    return barrier


def _image_in(resources: Optional[str], maze: bool) -> Optional[str]:
    """The first PNG (``maze``: any file) of ``resources`` whose name does
    (``maze``) or does not contain 'maze', in sorted order, as the JAX
    package picks it."""
    if not (resources and os.path.isdir(resources)):
        return None
    for name in sorted(os.listdir(resources)):
        if maze and "maze" in name.lower():
            return os.path.join(resources, name)
        if (not maze and name.lower().endswith(".png")
                and "maze" not in name.lower()):
            return os.path.join(resources, name)
    return None


def barrier_maze14(resources: Optional[str] = None) -> Callable:
    """The maze of [Papadakis-Peyre-Oudet 2014] (``gene_barrier_of_maze14.m``,
    ``maze-14.png``): the committed wall mask, or a maze image of an
    explicit ``resources`` directory (PIL)."""
    path = _image_in(resources, maze=True)
    if path is not None:
        return barrier_from_image(path)
    with np.load(MAZE14_MASK) as f:
        shape = tuple(int(v) for v in f["shape"])
        bits = f["bits"]
    mask = np.unpackbits(bits, count=shape[0] * shape[1]).reshape(shape)
    return _mask_barrier(mask.astype(bool))


def barrier_example6(resources: Optional[str] = None) -> Callable:
    """The obstacle of ``gene_barrier_of_example6.m``: the first non-maze
    PNG of an explicit ``resources`` directory (PIL); else the procedural
    labyrinth, which the JAX function also returns with its bundled images
    (they hold no non-maze PNG)."""
    path = _image_in(resources, maze=False)
    return barrier_from_image(path) if path is not None else _maze_procedural()


def wdot_provenance(problem: str = "love-heart") -> str:
    """Provenance of the wdot2d densities and barrier, for stamping results
    (``dotsocp_tpu/models/wdot2d.py:wdot_provenance``): the image barriers
    (maze14, example6) report ``assets:<the port's data directory>``,
    every other problem 'analytic'."""
    if problem in ("maze14", "example6"):
        return f"assets:{RESOURCES}"
    return "analytic"


# ---------------------------------------------------------------------------
# weights on the staggered grid
# ---------------------------------------------------------------------------

def _staggered_grids(nx, ny):
    """(x_stag, x_cent, y_stag, y_cent): face and node coordinates."""
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    return (np.linspace(0.5 * hx, 1 - 0.5 * hx, nx - 1),
            np.linspace(0.0, 1.0, nx),
            np.linspace(0.5 * hy, 1 - 0.5 * hy, ny - 1),
            np.linspace(0.0, 1.0, ny))


def _weight(nx, ny, nt, wy, wx, dtype, device) -> Staggered:
    """The shaped weight: 1 on the time block, (wy, wx) on the faces of
    every time node, built in ``dtype`` (default: torch's default float)."""
    dtype = dtype or torch.get_default_dtype()
    geom = Geometry(nt=nt, space=(ny, nx))
    kw = dict(dtype=dtype, device=device)
    by = torch.as_tensor(wy, **kw).expand(geom.b_shape(0)).contiguous()
    bx = torch.as_tensor(wx, **kw).expand(geom.b_shape(1)).contiguous()
    return Staggered(q0=torch.ones(geom.q0_shape, **kw), bs=(by, bx))


def get_weight_by_barrier(nx: int, ny: int, nt: int,
                          barrier: Optional[Callable] = None,
                          dtype: Optional[torch.dtype] = None,
                          device="cpu") -> Staggered:
    """Weight 1 everywhere, BARRIER_WEIGHT on faces inside the barrier,
    evaluated on the staggered x/y grids (``get_weight_by_barrier.m:12-31``);
    the time block is identically 1."""
    x_stag, x_cent, y_stag, y_cent = _staggered_grids(nx, ny)
    wx = np.ones((ny, nx - 1))
    wy = np.ones((ny - 1, nx))
    if barrier is not None:
        wx[np.asarray(barrier(x_stag[None, :], y_cent[:, None])) > 0] = BARRIER_WEIGHT
        wy[np.asarray(barrier(x_cent[None, :], y_stag[:, None])) > 0] = BARRIER_WEIGHT
    return _weight(nx, ny, nt, wy, wx, dtype, device)


def _radial_weight(nx, ny, nt, func, dtype=None, device="cpu") -> Staggered:
    x_stag, x_cent, y_stag, y_cent = _staggered_grids(nx, ny)
    wx = func(x_stag[None, :], y_cent[:, None])
    wx = wx * (wx.size / wx.sum())
    wy = func(x_cent[None, :], y_stag[:, None])
    wy = wy * (wy.size / wy.sum())
    return _weight(nx, ny, nt, wy, wx, dtype, device)


def gene_weight_circle(nt, nx, ny, dtype=None, device="cpu") -> Staggered:
    """Radial distance weight, normalized to unit mean
    (``gene_weight_circle.m``)."""
    return _radial_weight(
        nx, ny, nt, lambda x, y: np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2),
        dtype, device)


def gene_weight_circle_inv(nt, nx, ny, dtype=None, device="cpu") -> Staggered:
    """Inverse radial weight (``gene_weight_circleInv.m``)."""
    return _radial_weight(
        nx, ny, nt,
        lambda x, y: 1.0 / (0.1 + np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)),
        dtype, device)


# ---------------------------------------------------------------------------
# validity (``ensure_barrier_validity.m``, ``check_barrier_validity.m``)
# ---------------------------------------------------------------------------

def _barrier_mask(barrier: Callable, ny: int, nx: int) -> np.ndarray:
    x = np.linspace(0, 1, nx)[None, :]
    y = np.linspace(0, 1, ny)[:, None]
    return np.asarray(barrier(x, y), np.float64)


def ensure_barrier_validity(rho0, rho1, barrier: Callable):
    """Zero out density inside the barrier and renormalize to unit mean.
    Takes numpy arrays or tensors; returns float64 numpy arrays and the
    mask."""
    rho0 = np.array(_host(rho0), np.float64)
    rho1 = np.array(_host(rho1), np.float64)
    m = _barrier_mask(barrier, *rho0.shape)
    mask = m > m.mean()
    rho0[mask] = 0.0
    rho1[mask] = 0.0
    rho0 = rho0 / rho0.mean()
    rho1 = rho1 / rho1.mean()
    return rho0, rho1, mask


def check_barrier_validity(rho0, rho1, barrier: Callable, tol: float = 1e-4):
    """Error if mass sits on the barrier (``check_barrier_validity.m``)."""
    rho0 = np.asarray(_host(rho0))
    rho1 = np.asarray(_host(rho1))
    mask = _barrier_mask(barrier, *rho0.shape) > 0
    total = float(rho0[mask].sum() + rho1[mask].sum())
    if total > tol:
        raise ValueError(f"invalid (rho0, rho1, barrier): mass {total} on barrier")
    return mask


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
