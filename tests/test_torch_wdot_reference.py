"""The port's weighted solve against the benchmark's plain weighted
reference (``benchmark/benchlib/wreference.py``, float64 PyTorch, which
imports nothing of the port), on the CPU, and that reference against the
unweighted one (``benchmark/benchlib/reference.py``).

- 17^2 x 9, one level, no barrier, a seeded smooth random face weight in
  [0.5, 2] (the same at every time node), smooth positive densities: both
  solve to residuals of 1e-9 (the reference) and 1e-10 (the port), where
  they agree to ~2e-8 in rho and E (L1, relative) and to ~1e-11 in the
  weighted energy (second order at the optimum). The tolerances, 1e-6 in
  rho and E and 1e-8 in the energy, leave 50x and more of room above that
  and lie far below what the reference computed in TF32 reads (~7e-3 in
  rho, ~1e-2 in E), so a TF32 run fails them.
- 33^2 x 17, two levels, the love-heart barrier (1e6 walls) and its
  densities with the walls zeroed: the problem's slow tail (truncated
  Gaussians, the walls) leaves the reference at residual 1e-5 (4,125
  iterations on its finest level) and the port in float64 at tol 1e-6
  (7,809) 1.2e-3 apart in rho, 0.9e-3 in E and 8.7e-4 in the weighted
  energy; the tolerances, 5e-3 in each, leave 4x and more of room, and the
  reference in TF32 reads 0.18, 128 and 0.059 there. The port's answer
  also holds continuity (4e-7) and keeps its mass off the walls (8e-8).
- With weight 1 the weighted reference is the unweighted one: every
  operation multiplied by 1 (to 1e-10; bit for bit in practice).

The file imports no JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache, solve_dot
from dotsocp_tpu_torch.ops.staggered import Staggered

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from benchlib import reference as R  # noqa: E402
from benchlib import wreference as WR  # noqa: E402

F64 = torch.float64


def _pair(n):
    """Smooth positive densities of unit mean (Cauchy bumps)."""
    y, x = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="ij")

    def bump(cy, cx, s):
        return s / ((y - cy) ** 2 + (x - cx) ** 2 + s * s) ** 1.5

    r0 = bump(.3, .3, .1) + .3 * bump(.7, .6, .2)
    r1 = bump(.6, .7, .12) + .5 * bump(.2, .8, .1)
    return (torch.tensor(r0 / r0.mean()), torch.tensor(r1 / r1.mean()))


def smooth_weight(nt, n, seed):
    """Face weights in [0.5, 2] per space axis, (nt, ...), smooth in space
    (four products of cosines of random low frequency and phase, mapped
    to 0.5 * 4^f with f in [0, 1]), the same at every time node."""
    gen = torch.Generator().manual_seed(seed)
    faces = []
    for a in range(2):
        shape = [n, n]
        shape[a] = n - 1
        ys = torch.linspace(0, 1, shape[0], dtype=F64)[:, None]
        xs = torch.linspace(0, 1, shape[1], dtype=F64)[None, :]
        f = torch.zeros(shape, dtype=F64)
        for k in range(4):
            c = torch.rand(4, generator=gen, dtype=F64)
            f = f + (torch.cos(np.pi * (k + 1) * c[0] * ys + 6 * c[1])
                     * torch.cos(np.pi * (k + 1) * c[2] * xs + 6 * c[3]))
        f = (f - f.min()) / (f.max() - f.min())
        faces.append((0.5 * 4.0 ** f).expand(nt, *shape).contiguous())
    return faces


def _l1(x, ref):
    return float((x - ref).abs().sum() / ref.abs().sum())


def _port(r0, r1, nt, levels, weight, barrier, tol):
    clear_solver_cache()
    try:
        out, _, _ = solve_dot(r0, r1, nt, levels,
                              {"tol": tol, "maxit": 60000}, "inPALM",
                              weight, barrier, device="cpu", dtype=F64,
                              verbose=False)
    finally:
        clear_solver_cache()
    return out["rho"], list(out["E"])


@pytest.fixture(scope="module")
def random_weight():
    """The 17^2 x 9 problem: its faces, the reference to 1e-9, the port
    to 1e-10."""
    r0, r1 = _pair(17)
    faces = smooth_weight(9, 17, seed=20240518)
    ref = WR.solve(r0, r1, 9, faces, levels=1, tol=1e-9, maxit=60000)
    weight = Staggered(q0=torch.ones(8, 17, 17, dtype=F64),
                       bs=tuple(faces))
    port = _port(r0, r1, 9, 1, weight, None, 1e-10)
    return r0, r1, faces, ref, port


RANDOM_TOL = {"rho": 1e-6, "E": 1e-6, "energy": 1e-8}


def _misses(answer, ref, tol):
    """The quantities of ``answer`` (rho, E) off ``ref`` beyond ``tol``."""
    rho, Es = answer
    got = {"rho": _l1(rho, ref.rho),
           "E": max(_l1(e, e_ref) for e, e_ref in zip(Es, ref.E)),
           "energy": WR.energy_gap(answer, ref)}
    return {k: v for k, v in got.items() if not v <= tol[k]}, got


def test_weight_is_smooth_and_in_range(random_weight):
    _, _, faces, _, _ = random_weight
    for f in faces:
        assert 0.5 <= float(f.min()) and float(f.max()) <= 2.0
        assert float(f.max() - f.min()) > 1.0


def test_port_matches_the_reference_under_a_random_weight(random_weight):
    _, _, _, ref, port = random_weight
    assert ref.residual < 1e-9
    misses, got = _misses(port, ref, RANDOM_TOL)
    assert not misses, got


def test_tf32_reference_fails_the_tolerances(random_weight):
    """The reference computed in TF32 (the control of a float32 cell), to
    its floor within 3000 iterations: off by ~1e-2 in rho and E."""
    r0, r1, faces, ref, _ = random_weight
    tf = WR.solve(r0, r1, 9, faces, levels=1, tol=1e-9, maxit=3000,
                  rounding="tf32")
    misses, got = _misses((tf.rho, tf.E), ref, RANDOM_TOL)
    assert {"rho", "E"} <= set(misses), got


def test_weight_one_is_the_unweighted_reference():
    r0, r1 = _pair(17)
    ones = [torch.ones(9, 16, 17, dtype=F64), torch.ones(9, 17, 16,
                                                         dtype=F64)]
    a = R.solve(r0, r1, 9, levels=2, tol=1e-7)
    b = WR.solve(r0, r1, 9, ones, levels=2, tol=1e-7)
    assert a.iters == b.iters
    assert float((a.rho - b.rho).abs().max()) <= 1e-10
    for e, f in zip(a.E, b.E):
        assert float((e - f).abs().max()) <= 1e-10


LOVE_HEART_TOL = {"rho": 5e-3, "E": 5e-3, "energy": 5e-3}


def test_port_matches_the_reference_round_the_love_heart():
    barrier = wdot2d.barrier_love_heart()
    r0, r1 = wdot2d.get_example_w2d("love-heart", 33, 33)
    r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
    r0, r1 = torch.tensor(r0), torch.tensor(r1)
    weight = wdot2d.get_weight_by_barrier(33, 33, 17, barrier, dtype=F64)
    ref = WR.solve(r0, r1, 17, list(weight.bs), levels=2, tol=1e-5,
                   maxit=40000)
    assert ref.residual < 1e-5 and len(ref.iters) == 2
    port = _port(r0, r1, 17, 2, weight, barrier, 1e-6)
    misses, got = _misses(port, ref, LOVE_HEART_TOL)
    assert not misses, got
    opt = ref.optimum()
    assert bool(opt.walls.any())
    assert WR.continuity(port, opt) < 1e-5
    assert WR.wall_mass(port, opt) < 1e-5
