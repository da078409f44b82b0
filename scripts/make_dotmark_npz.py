"""Write the image problems of the JAX package as data for the PyTorch port.

The port reads ``dotsocp_tpu_torch/resources/*.npz`` instead of decoding
the PNG and BMP files (it needs no image library). Each file holds what the
JAX generator decoded, as the 8-bit gray values it came from; the port
rebuilds the JAX package's float64 arrays from them bit for bit:

- ``dotmark_4stitch_<n>.npz`` (ClassicImages 1-4 -> 5-8) and
  ``dotmark_4stitch_<type>_<stitch1>_<stitch2>_<n>.npz`` for other
  stitches: the raw stitch of
  ``dotsocp_tpu.models.examples.gene_example_dotmark_4stitch`` is
  ``u8 / 255.0 + 1e-12``;
- ``example5_<n>.npz`` (centaur -> man): ``gene_example5`` is
  ``1.0 - u8 / 255.0 + 1e-12``;
- ``maze14_mask.npz``: the wall mask of ``wdot2d/maze-14.png`` at its
  native size (gray / 255 < 0.5, as ``barrier_from_image`` computes it),
  bit-packed.

Each array is checked against the JAX generator before it is written.

    python scripts/make_dotmark_npz.py                  # the committed set
    python scripts/make_dotmark_npz.py --n 1025         # another DOTmark size
    python scripts/make_dotmark_npz.py --n 129 --type Shapes \\
        --stitch1 1 2 3 4 --stitch2 5 6 7 8
    python scripts/make_dotmark_npz.py --example5 --n 513
    python scripts/make_dotmark_npz.py --maze14
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dotsocp_tpu.models import examples as jexamples  # noqa: E402
from dotsocp_tpu.models import wdot2d as jwdot2d  # noqa: E402

from dotsocp_tpu_torch.models import examples as texamples  # noqa: E402
from dotsocp_tpu_torch.models import wdot2d as twdot2d  # noqa: E402

# the files the port ships, besides the maze: DOTmark at the three levels of
# the scale config, example5 at the demo's sizes, and both at 33 for small
# runs
COMMITTED = {"dotmark": (33, 129, 257, 513), "example5": (33, 129, 257)}


def _encode(rho: np.ndarray, invert: bool) -> np.ndarray:
    """The uint8 gray values that rebuild ``rho`` exactly."""
    gray = (1.0 - (rho - 1e-12)) if invert else (rho - 1e-12)
    u8 = np.clip(np.round(gray * 255.0), 0, 255).astype(np.uint8)
    back = texamples.decode_gray(u8, invert)
    if not np.array_equal(back, rho):
        raise SystemExit("the uint8 encoding does not rebuild the JAX "
                         "densities bit for bit; refusing to write it")
    return u8


def _save(path: str, **arrays) -> None:
    np.savez_compressed(path, **arrays)
    print(f"wrote {os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path)} bytes)")


def write_dotmark(n: int, dotmark_type: str, stitch1, stitch2) -> None:
    src = jexamples.density_source("DOTmark_4stitch")
    if src == "procedural":
        raise SystemExit("the DOTmark PNG tiles are missing; refusing to "
                         "write the procedural stand-in")
    rho0, rho1 = jexamples.gene_example_dotmark_4stitch(
        n, n, dotmark_type, tuple(stitch1), tuple(stitch2))
    _save(texamples.dotmark_npz_path(n, dotmark_type, stitch1, stitch2),
          rho0=_encode(rho0, False), rho1=_encode(rho1, False))


def write_example5(n: int) -> None:
    if jexamples.density_source("example5") == "procedural":
        raise SystemExit("centaur.bmp / man.bmp are missing; refusing to "
                         "write the procedural stand-in")
    rho0, rho1 = jexamples.gene_example5(n, n)
    _save(texamples.example5_npz_path(n), rho0=_encode(rho0, True),
          rho1=_encode(rho1, True))


def write_maze14() -> None:
    from PIL import Image

    path = os.path.join(os.path.dirname(jwdot2d.__file__), "..",
                        "resources", "wdot2d", "maze-14.png")
    img = np.asarray(Image.open(path).convert("L"), np.float64) / 255.0
    mask = img < 0.5
    h, w = mask.shape
    # the JAX predicate on the image's own grid gives back every pixel
    want = jwdot2d.barrier_maze14()(np.linspace(0, 1, w)[None, :],
                                    np.linspace(0, 1, h)[:, None])
    if not np.array_equal(mask, want):
        raise SystemExit("the decoded maze differs from barrier_maze14's")
    _save(twdot2d.MAZE14_MASK, bits=np.packbits(mask),
          shape=np.asarray(mask.shape, np.int64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=None,
                    help="grid points per axis (square grids)")
    ap.add_argument("--type", default="ClassicImages",
                    help="DOTmark class (ClassicImages, Shapes)")
    ap.add_argument("--stitch1", type=int, nargs=4, default=(1, 2, 3, 4))
    ap.add_argument("--stitch2", type=int, nargs=4, default=(5, 6, 7, 8))
    ap.add_argument("--example5", action="store_true",
                    help="write example5 (centaur -> man) at --n")
    ap.add_argument("--maze14", action="store_true",
                    help="write the maze-14 wall mask")
    args = ap.parse_args(argv)
    import PIL

    print(f"PIL {PIL.__version__}, numpy {np.__version__}")
    os.makedirs(texamples.RESOURCES, exist_ok=True)
    if args.n is None and not (args.example5 or args.maze14):
        for n in COMMITTED["dotmark"]:
            write_dotmark(n, "ClassicImages", (1, 2, 3, 4), (5, 6, 7, 8))
        for n in COMMITTED["example5"]:
            write_example5(n)
        write_maze14()
        return
    for n in args.n or ():
        if args.example5:
            write_example5(n)
        else:
            write_dotmark(n, args.type, args.stitch1, args.stitch2)
    if args.maze14:
        write_maze14()


if __name__ == "__main__":
    main()
