"""The plain reference: its operators, its solve against the program's
own float64 solve on the CPU, and the checks it makes of an answer."""
import numpy as np
import pytest
import torch

from benchlib import reference as R
from dotsocp_tpu_torch.multilevel.solve import solve_dot


def _pair(n):
    y, x = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="ij")

    def bump(cy, cx, s):
        return s / ((y - cy) ** 2 + (x - cx) ** 2 + s * s) ** 1.5

    r0 = bump(.3, .3, .1) + .3 * bump(.7, .6, .2)
    r1 = bump(.6, .7, .12) + .5 * bump(.2, .8, .1)
    return r0 / r0.mean(), r1 / r1.mean()


@pytest.fixture(scope="module")
def solved():
    """The reference and the program, both in float64 to 1e-9 at 17^2 x 9,
    one level."""
    r0, r1 = _pair(17)
    ref = R.solve(r0, r1, 9, levels=1, tol=1e-9)
    out, _, _ = solve_dot(torch.tensor(r0), torch.tensor(r1), 9, 1,
                          {"tol": 1e-10, "maxit": 50000}, "inPALM",
                          device="cpu", dtype=torch.float64, verbose=False)
    return ref, (out["rho"], out["E"]), (r0, r1)


def _dot(xs, ys):
    return sum(float((x * y).sum()) for x, y in zip(xs, ys))


def test_operators_are_adjoint():
    g = R.Grid(5, (6, 7), torch.float64, "cpu")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    phi = rnd(5, 6, 7)
    q0, bs = rnd(4, 6, 7), [rnd(5, 5, 7), rnd(5, 6, 6)]
    a0, abs_ = g.grad(phi)
    assert _dot([a0] + abs_, [q0] + bs) == pytest.approx(
        float((phi * g.grad_T(q0, bs)).sum()), rel=1e-12)
    u = rnd(2, 4, 4, 6, 7)
    assert _dot([g.gather(bs)], [u]) == pytest.approx(
        _dot(bs, g.scatter(u)), rel=1e-12)
    # each face lies in four cells, or two on the first and last time node
    ones = g.scatter(torch.ones_like(u))
    assert torch.equal(ones[0][1:-1], torch.full_like(ones[0][1:-1], 4.0))
    assert torch.equal(ones[1][0], torch.full_like(ones[1][0], 2.0))


def test_poisson_inverts_the_laplacian():
    g = R.Grid(5, (6, 7), torch.float64, "cpu")
    rhs = torch.randn((5, 6, 7), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    rhs -= rhs.mean()
    phi = g.poisson(rhs)
    assert torch.allclose(g.grad_T(*g.grad(phi)), rhs, atol=1e-10)
    assert abs(float(phi.mean())) < 1e-12


def _l1_gap(x, ref):
    return float((x - ref).abs().sum() / ref.abs().sum())


def test_the_reference_solves_the_programs_problem(solved):
    ref, (rho, Es), _ = solved
    assert ref.residual < 1e-9
    assert _l1_gap(rho, ref.rho) < 1e-6
    for e, e_ref in zip(Es, ref.E):
        assert _l1_gap(e, e_ref) < 1e-6
    assert R.energy_gap((rho, Es), ref) < 1e-6


def test_coarse_to_fine_reaches_the_same_optimum(solved):
    ref, _, (r0, r1) = solved
    ml = R.solve(r0, r1, 9, levels=2, tol=1e-9)
    assert len(ml.iters) == 2
    assert _l1_gap(ml.rho, ref.rho) < 1e-6


def test_checks_of_wrong_answers(solved):
    ref, (rho, Es), _ = solved
    # one time step late on the interior slabs
    late = rho.clone()
    late[2:-1] = rho[1:-2]
    assert R.energy_gap((late, Es), ref) > 1e-2
    assert R.continuity((late, Es), ref) > 1e-2
    # the straight interpolation between the ends, the momentum kept
    t = torch.linspace(0, 1, rho.shape[0], dtype=rho.dtype)[:, None, None]
    straight = (1 - t) * rho[0] + t * rho[-1]
    assert R.energy_gap((straight, Es), ref) > 1e-2
    # no momentum at all
    assert R.energy_gap((rho, [torch.zeros_like(e) for e in Es]), ref) == 1.0


def test_check_by_name(solved):
    ref, answer, _ = solved
    assert R.check("energy_gap", answer, ref) == R.energy_gap(answer, ref)
    with pytest.raises(KeyError):
        R.check("no_such_check", answer, ref)
    with pytest.raises(ValueError):
        R.check("energy_gap", (answer[0], None), ref)


def test_rounding_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.14159265],
                     dtype=torch.float32)
    y = R.ROUNDINGS["tf32"](x)
    assert y[0] == x[0]
    assert y[1] == 1.0
    assert abs(float(y[2]) - 3.14159265) < 2.0 ** -10 * 4
    assert float(y[2]) != float(x[2])


def test_continuity_holds_on_the_optimum_and_fails_wrong_answers(solved):
    ref, (rho, Es), _ = solved
    assert R.continuity((rho, Es), ref) < 1e-8
    assert R.continuity((ref.rho, ref.E), ref) < 1e-8
    empty = rho.clone()
    empty[1:-1] = 0.0
    assert R.continuity((empty, [torch.zeros_like(e) for e in Es]), ref) \
        == pytest.approx(1.0)
    bent = rho.clone()
    bent[1:-1] *= 1.01
    assert R.continuity((bent, Es), ref) > 1e-3
