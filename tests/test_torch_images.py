"""The image problems of the PyTorch port against the JAX package on the CPU.

- Data (``dotsocp_tpu_torch/resources/*.npz``, ``scripts/make_dotmark_npz.py``):
  every committed DOTmark 4-stitch and example5 file rebuilds the JAX
  generator's float64 densities bit for bit at its size, and the maze mask
  is the JAX package's ``maze-14.png`` mask pixel for pixel. These decode
  the JAX package's images, so they need PIL and skip where it is absent.
- ``get_example_2d`` / ``get_example_w2d`` equal the JAX functions for
  example5, DOTmark_4stitch and maze14, from the data and from an explicit
  ``resources`` directory; ``get_example_from_images`` too.
- Barriers: ``barrier_maze14``, ``barrier_example6`` and
  ``barrier_from_image`` (a PNG written to ``tmp_path``) equal the JAX
  predicates on random points and on the staggered grids at 33, 129 and
  257; ``get_weight_by_barrier`` with the maze equals the JAX weight.
- A size or stitch with no data raises FileNotFoundError naming the
  script; ``density_source`` and ``wdot_provenance`` give the JAX kinds.
- ``solve_dot`` in float64 on the CPU against the JAX host driver, fed the
  same densities: weighted inPALM on the maze (33^2 x 17, 2 levels, tol
  1e-3) and example5 (33^2 x 9, 2 levels, tol 1e-4): the same iterations
  on every level and the same check schedule, the tolerances of
  ``tests/test_torch_weighted.py``.

Run as a script, ``python tests/test_torch_images.py --anchors`` runs the
JAX package's demo configurations of ``chip_smoke.py`` phase 9 on the CPU
in float32 (x64 off, its default driver) and prints their per-level
iterations: ``MAZE_ANCHOR`` (maze14 129^2 x 129, 3 levels, tol 1e-3,
inPALM) and ``EXAMPLE5_ANCHOR`` (example5 129^2 x 33, 3 levels, tol 1e-4);
with ``--f64`` the same in float64 (x64 on): ``MAZE_F64_ANCHOR``.
"""
import os
import sys

if __name__ == "__main__":  # run as a script from anywhere
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models import examples as JE
from dotsocp_tpu.models import wdot2d as JW
from dotsocp_tpu.multilevel import solve as jsolve

from dotsocp_tpu_torch.models import examples as TE
from dotsocp_tpu_torch.models import wdot2d as TW
from dotsocp_tpu_torch.multilevel import solve as tsolve
from dotsocp_tpu_torch.utils.interop import weight_from_numpy

torch.set_num_threads(2)

F64 = torch.float64
MAZE_SOLVE = (33, 17, 2, {"tol": 1e-3})
EXAMPLE5_SOLVE = (33, 9, 2, {"tol": 1e-4})
DOTMARK_SIZES = (33, 129, 257, 513)
EXAMPLE5_SIZES = (33, 129, 257)


def _needs_pil():
    pytest.importorskip("PIL", reason="the JAX generators decode images "
                                      "with PIL")


def _staggered(n):
    """The face and node coordinates ``get_weight_by_barrier`` evaluates a
    barrier on, as two (x, y) pairs."""
    h = 1.0 / (n - 1)
    stag = np.linspace(0.5 * h, 1 - 0.5 * h, n - 1)
    cent = np.linspace(0.0, 1.0, n)
    return ((stag[None, :], cent[:, None]), (cent[None, :], stag[:, None]))


def _points(seed=0, m=20000):
    rng = np.random.default_rng(seed)
    # a margin outside [0, 1]: the predicates clip
    return rng.uniform(-0.05, 1.05, m), rng.uniform(-0.05, 1.05, m)


def _same_predicate(tb, jb):
    x, y = _points()
    np.testing.assert_array_equal(tb(x, y), jb(x, y))
    for n in (33, 129, 257):
        for xs, ys in _staggered(n):
            np.testing.assert_array_equal(tb(xs, ys), jb(xs, ys))


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("n", DOTMARK_SIZES)
def test_dotmark_file_equals_jax_generator(n):
    _needs_pil()
    with np.load(TE.dotmark_npz_path(n)) as f:
        assert f["rho0"].dtype == np.uint8 and f["rho0"].shape == (n, n)
    for a, b in zip(TE.gene_example_dotmark_4stitch(n, n),
                    JE.gene_example_dotmark_4stitch(n, n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TE.get_example_2d("DOTmark_4stitch", n, n, 0.1),
                    JE.get_example_2d("DOTmark_4stitch", n, n, 0.1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", EXAMPLE5_SIZES)
def test_example5_file_equals_jax_generator(n):
    _needs_pil()
    for a, b in zip(TE.gene_example5(n, n), JE.gene_example5(n, n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TE.get_example_2d("example5", n, n),
                    JE.get_example_2d("example5", n, n)):
        np.testing.assert_array_equal(a, b)


def test_maze_mask_equals_the_png():
    _needs_pil()
    from PIL import Image

    png = os.path.join(os.path.dirname(JW.__file__), "..", "resources",
                       "wdot2d", "maze-14.png")
    img = np.asarray(Image.open(png).convert("L"), np.float64) / 255.0
    h, w = img.shape
    grid = (np.linspace(0, 1, w)[None, :], np.linspace(0, 1, h)[:, None])
    np.testing.assert_array_equal(TW.barrier_maze14()(*grid), img < 0.5)


@pytest.mark.parametrize("problem", ["DOTmark_4stitch", "example5"])
def test_explicit_resources_decode_as_jax(problem):
    """An explicit ``resources`` directory of images (PIL) gives the JAX
    densities at a size that has no data file."""
    _needs_pil()
    res = JE._BUNDLED_RESOURCES
    kw = {"resources": res}
    if problem == "DOTmark_4stitch":
        kw.update(DOTmark_type="Shapes", stitch1_indices=(2, 3, 4, 5),
                  stitch2_indices=(6, 7, 8, 1))
    for a, b in zip(TE.get_example_2d(problem, 47, 39, **kw),
                    JE.get_example_2d(problem, 47, 39, **kw)):
        np.testing.assert_array_equal(a, b)
    assert TE.density_source(problem, res) == f"assets:{res}"


def test_get_example_from_images_matches(tmp_path):
    _needs_pil()
    from PIL import Image

    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 30), np.uint8)).save(p)
        paths.append(p)
    for invert in (False, True):
        for a, b in zip(TE.get_example_from_images(*paths, 25, 21, invert, 0.1),
                        JE.get_example_from_images(*paths, 25, 21, invert, 0.1)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call,match", [
    (lambda TE: TE.get_example_2d("DOTmark_4stitch", 65, 65),
     r"make_dotmark_npz.py --n 65`"),
    (lambda TE: TE.get_example_2d("DOTmark_4stitch", 129, 65),
     r"make_dotmark_npz.py --n 129"),
    (lambda TE: TE.get_example_2d("example5", 65, 65),
     r"make_dotmark_npz.py --example5 --n 65"),
    (lambda TE: TE.get_example_2d("DOTmark_4stitch", 129, 129,
                                  DOTmark_type="Shapes"),
     r"--n 129 --type Shapes --stitch1 1 2 3 4 --stitch2 5 6 7 8"),
], ids=["size", "non-square", "example5", "stitch"])
def test_missing_data_raises_naming_the_script(call, match):
    with pytest.raises(FileNotFoundError, match=match):
        call(TE)


def test_provenance_kinds_match():
    def kind(v):
        return v.split(":")[0]

    for problem in ("DOTmark_4stitch", "example5", "example2"):
        got, want = TE.density_source(problem), JE.density_source(problem)
        assert kind(got) == kind(want) == "assets"
        assert got == f"assets:{TE.RESOURCES}"
    for problem in ("maze14", "example6", "love-heart", "circle2"):
        got, want = TW.wdot_provenance(problem), JW.wdot_provenance(problem)
        assert kind(got) == kind(want)
        assert got in ("analytic", f"assets:{TE.RESOURCES}")


# -- barriers and weights ----------------------------------------------------------

@pytest.mark.parametrize("name", ["barrier_maze14", "barrier_example6"])
def test_image_barriers_match(name):
    _needs_pil()
    _same_predicate(getattr(TW, name)(), getattr(JW, name)())


def test_image_barriers_take_explicit_resources(tmp_path):
    """With an explicit directory both packages read its images: the first
    maze file for maze14, the first non-maze PNG for example6."""
    _needs_pil()
    from PIL import Image

    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (50, 70), np.uint8)).save(
        tmp_path / "a-maze.png")
    Image.fromarray(rng.integers(0, 256, (60, 40), np.uint8)).save(
        tmp_path / "obstacle.png")
    for name in ("barrier_maze14", "barrier_example6"):
        tb = getattr(TW, name)(str(tmp_path))
        _same_predicate(tb, getattr(JW, name)(str(tmp_path)))
        # not the committed maze nor the procedural labyrinth
        x, y = _points(1)
        assert not np.array_equal(tb(x, y), TW.barrier_maze14()(x, y))


@pytest.mark.parametrize("threshold,invert", [(0.5, False), (0.3, True)])
def test_barrier_from_image_matches(tmp_path, threshold, invert):
    _needs_pil()
    from PIL import Image

    path = str(tmp_path / "walls.png")
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (37, 53), np.uint8)).save(path)
    _same_predicate(TW.barrier_from_image(path, threshold, invert),
                    JW.barrier_from_image(path, threshold, invert))


@pytest.mark.parametrize("n,nt", [(33, 17), (129, 5)])
def test_maze_weight_matches(n, nt):
    _needs_pil()
    jw = JW.get_weight_by_barrier(n, n, nt, JW.barrier_maze14(),
                                  dtype=jnp.float64)
    tw = TW.get_weight_by_barrier(n, n, nt, TW.barrier_maze14(), dtype=F64)
    np.testing.assert_array_equal(tw.q0.numpy(), np.asarray(jw.q0))
    for a, b in zip(tw.bs, jw.bs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(tw.bs[1].max()) == TW.BARRIER_WEIGHT
    r0, r1 = JW.get_example_w2d("maze14", n, n)
    for a, b in zip(TW.ensure_barrier_validity(r0, r1, TW.barrier_maze14()),
                    JW.ensure_barrier_validity(r0, r1, JW.barrier_maze14())):
        np.testing.assert_array_equal(a, b)


# -- solves ------------------------------------------------------------------------

def _close(got, want, rtol, atol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _jax_opts(opts):
    return dict(opts, driver="host", layout="flat", use_pallas=False,
                reuse_solvers=False)


def test_maze_solve_matches_jax_f64():
    _needs_pil()
    n, nt, levels, opts = MAZE_SOLVE
    jb, tb = JW.barrier_maze14(), TW.barrier_maze14()
    r0, r1 = JW.get_example_w2d("maze14", n, n)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, jb)
    jw = JW.get_weight_by_barrier(n, n, nt, jb, dtype=jnp.float64)
    jout, jh, _ = jsolve.solve_dot(r0, r1, nt, levels, _jax_opts(opts),
                                   "inPALM", weight=jw, barrier=jb,
                                   dtype=jnp.float64, verbose=False)
    tw = weight_from_numpy(jax.device_get(jw), device="cpu", dtype=F64)
    tout, th, _ = tsolve.solve_dot(r0, r1, nt, levels,
                                   dict(opts, driver="host"), "inPALM", tw,
                                   tb, device="cpu", dtype=F64, verbose=False)
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    _close(th["kkt"], jh["kkt"], 1e-7, 1e-10)
    _close(tout["rho"], jout["rho"], 1e-7, 1e-12)
    assert tout["mass_ok"] and jout["mass_ok"]
    assert max(th["kkt"][-1][[0, 2, 5]]) < opts["tol"]


def test_example5_solve_matches_jax_f64():
    _needs_pil()
    n, nt, levels, opts = EXAMPLE5_SOLVE
    r0, r1 = JE.get_example_2d("example5", n, n)
    jout, jh, _ = jsolve.solve_dot(r0, r1, nt, levels, _jax_opts(opts),
                                   "inPALM", dtype=jnp.float64, verbose=False)
    tout, th, _ = tsolve.solve_dot(r0, r1, nt, levels,
                                   dict(opts, driver="host"), "inPALM",
                                   device="cpu", dtype=F64, verbose=False)
    assert ([lv["iters"] for lv in tout["levels"]]
            == [lv["iters"] for lv in jout["levels"]])
    np.testing.assert_array_equal(th["iter"], jh["iter"])
    _close(th["kkt"], jh["kkt"], 1e-7, 1e-12)
    _close(tout["rho"], jout["rho"], 1e-7, 1e-12)
    assert tout["mass_ok"] and jout["mass_ok"]
    assert max(th["kkt"][-1][[0, 2, 5, 6]]) < opts["tol"]


def jax_anchors():
    """The JAX package's float32 runs behind ``chip_smoke.py``'s
    ``MAZE_ANCHOR`` and ``EXAMPLE5_ANCHOR``: per-level iterations."""
    solve_dot = jsolve.solve_dot
    barrier = JW.barrier_maze14()
    r0, r1 = JW.get_example_w2d("maze14", 129, 129)
    r0, r1, _ = JW.ensure_barrier_validity(r0, r1, barrier)
    weight = JW.get_weight_by_barrier(129, 129, 129, barrier)
    maze, _, _ = solve_dot(r0, r1, 129, 3, {"tol": 1e-3, "maxit": 10000},
                           "inPALM", weight=weight, barrier=barrier,
                           verbose=False)
    e0, e1 = JE.get_example_2d("example5", 129, 129)
    ex5, _, _ = solve_dot(e0, e1, 33, 3, {"tol": 1e-4, "maxit": 3000},
                          "inPALM", verbose=False)
    return {"MAZE_ANCHOR": [lv["iters"] for lv in maze["levels"]],
            "EXAMPLE5_ANCHOR": [lv["iters"] for lv in ex5["levels"]],
            "jax": jax.__version__}


if __name__ == "__main__" and "--anchors" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", "--f64" in sys.argv)
    print("float64" if "--f64" in sys.argv else "float32", jax_anchors())
