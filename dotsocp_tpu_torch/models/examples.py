"""Problem generators for 1D, 2D and 3D DOT; a numpy copy of
``dotsocp_tpu/models/examples.py`` (``get_example_1d``, ``get_example_2d``,
``get_example_3d``, ``get_example_from_images``, ``density_source``).

Array convention: densities are (ny, nx) with rows = the first spatial axis
(y) and columns = x; 1D densities are (nx,), 3D ones (nz, ny, nx). All generators normalize to
unit mean with an optional lower bound:
rho <- (rho / mean(rho) + lb) / (1 + lb)  (``get_example.m:45-47``).

The image problems (``DOTmark_4stitch``, ``example5``) read the gray values
the JAX package decodes from its bundled images, committed as uint8 ``.npz``
files under ``resources/`` (``scripts/make_dotmark_npz.py``), and rebuild
its float64 arrays from them bit for bit, so no image library is needed. A
size or stitch with no file raises FileNotFoundError naming the command that
writes it: the JAX package's procedural stand-ins are a different problem
under the same name, and the port never substitutes them. An explicit
``resources`` directory of image files, and ``get_example_from_images``,
decode with PIL, imported only then.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

RESOURCES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "resources")


def _normalize(rho: np.ndarray, lower_bound: float = 0.0) -> np.ndarray:
    rho = np.asarray(rho, np.float64)
    return (rho / rho.mean() + lower_bound) / (1.0 + lower_bound)


# ---------------------------------------------------------------------------
# 1D (``examples/dot1d``)
# ---------------------------------------------------------------------------

def gene_example_gaussian_1d(nx: int):
    """N(0.3, 0.01) -> N(0.7, 0.0025) (``gene_example_gaussian.m``)."""
    x = np.linspace(0.0, 1.0, nx)
    s1, s2 = 0.01, 0.01 / 4.0

    def normal(mu, var):
        return math.sqrt(1.0 / var) / (2 * math.pi) * np.exp(-0.5 * (x - mu) ** 2 / var)

    return normal(0.3, s1), normal(0.7, s2)


def gene_example_box_1d(nx: int):
    """Indicator [0.1, 0.5] -> [0.85, 0.95] (``gene_example_box.m``)."""
    x = np.linspace(0.0, 1.0, nx)
    rho0 = ((x >= 0.1) & (x <= 0.5)).astype(np.float64)
    rho1 = ((x >= 0.85) & (x <= 0.95)).astype(np.float64)
    return rho0, rho1


def get_example_1d(problem: str, nx: int, lower_bound: float = 0.0):
    if problem == "gaussian":
        rho0, rho1 = gene_example_gaussian_1d(nx)
    elif problem == "box":
        rho0, rho1 = gene_example_box_1d(nx)
    else:
        raise ValueError(f"unknown 1D problem {problem!r}")
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


# ---------------------------------------------------------------------------
# 2D analytic (``examples/dot2d/gene_example*.m``)
# ---------------------------------------------------------------------------

def _grid2d(nx: int, ny: int):
    """(Y, X) with Y varying along rows (ny) and X along columns (nx)."""
    y = np.linspace(0.0, 1.0, ny)[:, None]
    x = np.linspace(0.0, 1.0, nx)[None, :]
    return y, x


def _gaussian2d(nx, ny, a, b, sigma):
    y, x = _grid2d(nx, ny)
    return np.exp(-((y - a) ** 2 + (x - b) ** 2) / (2.0 * sigma**2))


def gene_example1(nx, ny):
    """Offset isotropic Gaussians swapping corners (``gene_example1.m``)."""
    mu1, mu2, sigma = 0.25, 0.75, 0.05
    y, x = _grid2d(nx, ny)

    def normal(m1, m2):
        inv = 1.0 / sigma
        return (
            math.sqrt(inv * inv)
            / (2 * math.pi)
            * np.exp(-0.5 * (inv * (y - m1) ** 2 + inv * (x - m2) ** 2))
        )

    return normal(mu1, mu2), normal(mu2, mu1)


def _four_corners(nx, ny, mu1, mu2, sigma):
    return (
        _gaussian2d(nx, ny, mu1, mu1, sigma)
        + _gaussian2d(nx, ny, mu1, mu2, sigma)
        + _gaussian2d(nx, ny, mu2, mu1, sigma)
        + _gaussian2d(nx, ny, mu2, mu2, sigma)
    )


def gene_example2(nx, ny):
    """One Gaussian -> four corner Gaussians (``gene_example2.m``)."""
    mu1 = 0.25
    mu2 = 1 - mu1
    rho0 = _gaussian2d(nx, ny, mu1, mu1, 0.1)
    rho1 = _four_corners(nx, ny, mu1, mu2, 0.05)
    return rho0, rho1


def gene_example3(nx, ny):
    """exp-exp Laplacian -> four Gaussians (``gene_example3.m``)."""
    a1, a2 = 3.0, 5.0
    mu1 = 0.25
    mu2 = 1 - mu1
    y, x = _grid2d(nx, ny)
    rho0 = np.exp(np.exp(-a1 * np.abs(y - mu1) - a2 * np.abs(x - mu1)))
    rho1 = _four_corners(nx, ny, mu1, mu2, 0.05)
    return rho0, rho1


def gene_example4(nx, ny):
    """Quartic bowl -> four Gaussians (``gene_example4.m``)."""
    y, x = _grid2d(nx, ny)
    rho0 = (y - 0.5) ** 4 + (x - 0.5) ** 4
    rho1 = _four_corners(nx, ny, 0.25, 0.75, 0.05)
    return rho0, rho1


def gene_example_circle(nx, ny):
    """Disjoint discs (``gene_exampleCircle.m``)."""
    y, x = _grid2d(nx, ny)
    rho0 = ((x - 0.25) ** 2 + (y - 0.75) ** 2 < 0.25**2).astype(np.float64)
    rho1 = ((x - 0.75) ** 2 + (y - 0.25) ** 2 < 0.25**2).astype(np.float64)
    return rho0, rho1


# The reference's frozen 30-point Dirac instance (``gene_example7.m:19-21``).
_EXAMPLE7_DIRAC_X = np.array([
    0.8323, 0.5339, 0.4031, 0.6536, 0.8200, 0.4918, 0.5108, 0.6082, 0.4633,
    0.1500, 0.7227, 0.4967, 0.5318, 0.6625, 0.4309, 0.1076, 0.3052, 0.4113,
    0.4955, 0.4485, 0.5031, 0.7529, 0.4723, 0.3668, 0.4848, 0.5474, 0.3867,
    0.3192, 0.0676, 0.2382,
])
_EXAMPLE7_DIRAC_Y = np.array([
    0.4477, 0.6033, 0.4264, 0.5378, 0.8026, 0.7535, 0.3472, 0.2628, 0.4023,
    0.4676, 0.4535, 0.5105, 0.5903, 0.6705, 0.5134, 0.4471, 0.6960, 0.5068,
    0.5040, 0.5468, 0.2641, 0.1783, 0.2195, 0.3484, 0.5056, 0.3925, 0.4511,
    0.2659, 0.4157, 0.8016,
])


def gene_example7(nx, ny):
    """Center Gaussian -> the hard-coded 30-Dirac instance
    (``gene_example7.m:19-21,28-43``); the row index is clamped to its own
    axis, as in the JAX package."""
    rho0 = _gaussian2d(nx, ny, 0.5, 0.5, 0.1)
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    ix = np.clip(np.floor(_EXAMPLE7_DIRAC_X / hx + 0.5).astype(int), 1, ny)
    iy = np.clip(np.floor(_EXAMPLE7_DIRAC_Y / hy + 0.5).astype(int), 1, nx)
    rho1 = np.zeros((ny, nx))
    rho1[ix - 1, iy - 1] = 1.0
    return rho0, rho1


# ---------------------------------------------------------------------------
# image problems from committed data
# ---------------------------------------------------------------------------

DOTMARK_DEFAULT = ("ClassicImages", (1, 2, 3, 4), (5, 6, 7, 8))
SCRIPT = "python scripts/make_dotmark_npz.py"


def decode_gray(u8: np.ndarray, invert: bool = False) -> np.ndarray:
    """The JAX package's float64 density from 8-bit gray values:
    ``u8 / 255.0 + 1e-12`` (DOTmark), ``1.0 - u8 / 255.0 + 1e-12`` with
    ``invert`` (example5), rounded as the JAX generators round them."""
    gray = np.asarray(u8, np.float64) / 255.0
    return (1.0 - gray if invert else gray) + 1e-12


def dotmark_npz_path(n: int, dotmark_type: str = "ClassicImages",
                     stitch1=(1, 2, 3, 4), stitch2=(5, 6, 7, 8)) -> str:
    """The data file of a DOTmark 4-stitch on an n x n grid."""
    if (dotmark_type, tuple(stitch1), tuple(stitch2)) == DOTMARK_DEFAULT:
        return os.path.join(RESOURCES, f"dotmark_4stitch_{n}.npz")
    tag = "_".join([dotmark_type, "-".join(map(str, stitch1)),
                    "-".join(map(str, stitch2))])
    return os.path.join(RESOURCES, f"dotmark_4stitch_{tag}_{n}.npz")


def example5_npz_path(n: int) -> str:
    return os.path.join(RESOURCES, f"example5_{n}.npz")


def _load_pair(path: str, nx: int, ny: int, what: str, command: str,
               invert: bool):
    if nx != ny or not os.path.isfile(path):
        raise FileNotFoundError(
            f"no {what} data for {ny}x{nx}: {path} is missing. Write it "
            f"from the JAX package's images with `{command}` (square grids "
            f"only)")
    with np.load(path) as f:
        return decode_gray(f["rho0"], invert), decode_gray(f["rho1"], invert)


def _load_image_gray(path: str, shape) -> np.ndarray:
    """An image file's gray values in [0, 1], resized to ``shape`` with
    PIL's default resampling, as the JAX package decodes it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL is needed to read an arbitrary image file; "
                          "the committed problems need none") from e
    img = Image.open(path).convert("L")
    img = img.resize((shape[1], shape[0]))  # PIL size = (width, height)
    return np.asarray(img, np.float64) / 255.0


def get_example_from_images(path0: str, path1: str, nx: int, ny: int,
                            invert: bool = False, lower_bound: float = 0.0):
    """Any two images as densities (``get_example_from_images.m``); needs
    PIL."""
    rho0 = _load_image_gray(path0, (ny, nx))
    rho1 = _load_image_gray(path1, (ny, nx))
    if invert:
        rho0, rho1 = 1.0 - rho0, 1.0 - rho1
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


def gene_example5(nx, ny, resources: Optional[str] = None):
    """centaur.bmp -> man.bmp, color-inverted (``gene_example5.m``), from
    the committed data; from ``resources``' bitmaps (PIL) where given."""
    if resources is not None:
        c, m = (os.path.join(resources, f) for f in ("centaur.bmp", "man.bmp"))
        return (1.0 - _load_image_gray(c, (ny, nx)) + 1e-12,
                1.0 - _load_image_gray(m, (ny, nx)) + 1e-12)
    return _load_pair(example5_npz_path(nx), nx, ny, "example5",
                      f"{SCRIPT} --example5 --n {nx}", invert=True)


def gene_example_dotmark_4stitch(nx, ny, dotmark_type: str = "ClassicImages",
                                 stitch1=(1, 2, 3, 4), stitch2=(5, 6, 7, 8),
                                 resources: Optional[str] = None):
    """2x2 stitch of DOTmark images (``gene_example_DOTmark_4stitch.m``),
    from the committed data; from the PNG tiles under
    ``<resources>/DOTmark/<type>/`` (PIL) where ``resources`` is given."""
    if resources is not None:
        hy, hx = (ny + 1) // 2, (nx + 1) // 2

        def stitch(indices):
            t = [_load_image_gray(os.path.join(resources, "DOTmark",
                                               dotmark_type, f"{i}.png"),
                                  (hy, hx)) for i in indices]
            full = np.concatenate([np.concatenate(t[:2], axis=1),
                                   np.concatenate(t[2:], axis=1)], axis=0)
            return full[:ny, :nx] + 1e-12

        return stitch(stitch1), stitch(stitch2)
    command = f"{SCRIPT} --n {nx}"
    if (dotmark_type, tuple(stitch1), tuple(stitch2)) != DOTMARK_DEFAULT:
        command += (f" --type {dotmark_type} --stitch1 "
                    f"{' '.join(map(str, stitch1))} --stitch2 "
                    f"{' '.join(map(str, stitch2))}")
    return _load_pair(dotmark_npz_path(nx, dotmark_type, stitch1, stitch2),
                      nx, ny, "DOTmark_4stitch", command, invert=False)


def density_source(problem: str = "DOTmark_4stitch",
                   resources: Optional[str] = None) -> str:
    """Provenance of an image example's densities, for stamping results
    (``dotsocp_tpu/models/examples.py:density_source``): ``assets:<dir>``,
    the port's data directory or ``resources``. The JAX function's other
    value, 'procedural', never applies: the port raises where it has no
    data."""
    return f"assets:{resources if resources is not None else RESOURCES}"


# ---------------------------------------------------------------------------
# 3D problems (``dotsocp_tpu/models/examples.py:304-349``): beyond the
# reference, which stops at 2D; cone width 2 + 4*3 = 14
# ---------------------------------------------------------------------------

def _grid3d(nx, ny, nz):
    z = np.linspace(0.0, 1.0, nz)[:, None, None]
    y = np.linspace(0.0, 1.0, ny)[None, :, None]
    x = np.linspace(0.0, 1.0, nx)[None, None, :]
    return z, y, x


def gene_example3d_gaussian(nx, ny, nz):
    """Two offset 3D Gaussians (the 3D analogue of example1)."""
    z, y, x = _grid3d(nx, ny, nz)

    def g(c, s):
        return np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                      / (2 * s * s))

    return g((0.3, 0.3, 0.3), 0.12), g((0.7, 0.7, 0.7), 0.12)


def gene_example3d_split8(nx, ny, nz):
    """One center Gaussian splitting into the 8 corners (3D example2)."""
    z, y, x = _grid3d(nx, ny, nz)

    def g(c, s):
        return np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                      / (2 * s * s))

    rho0 = g((0.5, 0.5, 0.5), 0.12)
    rho1 = sum(
        g((cx, cy, cz), 0.07)
        for cx in (0.25, 0.75) for cy in (0.25, 0.75) for cz in (0.25, 0.75)
    )
    return rho0, rho1


def get_example_3d(problem: str, nx: int, ny: int, nz: int,
                   lower_bound: float = 0.0):
    gens = {"gaussian": gene_example3d_gaussian,
            "split8": gene_example3d_split8}
    if problem not in gens:
        raise ValueError(f"unknown 3D problem {problem!r}")
    rho0, rho1 = gens[problem](nx, ny, nz)
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


# ---------------------------------------------------------------------------
# dispatch (``examples/dot2d/get_example.m``)
# ---------------------------------------------------------------------------

def get_example_2d(problem: str, nx: int, ny: int, lower_bound: float = 0.0,
                   **kwargs):
    """The 2D problems by name (``get_example.m``); ``DOTmark_4stitch``
    takes the JAX keywords ``DOTmark_type``, ``stitch1_indices``,
    ``stitch2_indices`` and ``resources``, ``example5`` takes
    ``resources``."""
    gens = {
        "example1": gene_example1,
        "example2": gene_example2,
        "example3": gene_example3,
        "example4": gene_example4,
        "example7": gene_example7,
        "circle": gene_example_circle,
    }
    if problem in gens:
        rho0, rho1 = gens[problem](nx, ny)
    elif problem == "example5":
        rho0, rho1 = gene_example5(nx, ny, kwargs.get("resources"))
    elif problem == "DOTmark_4stitch":
        rho0, rho1 = gene_example_dotmark_4stitch(
            nx, ny,
            kwargs.get("DOTmark_type", "ClassicImages"),
            kwargs.get("stitch1_indices", (1, 2, 3, 4)),
            kwargs.get("stitch2_indices", (5, 6, 7, 8)),
            kwargs.get("resources"),
        )
    else:
        raise ValueError(f"unknown 2D problem {problem!r}")
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)
