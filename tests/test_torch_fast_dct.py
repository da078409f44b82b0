"""The FFT route of the DCT Poisson solve (``ops/poisson.py``: the plan,
its passes, ``torch.fft.rfftn``, the spectral step and the kernels of
``csrc/dct_spectral.cu``), on the CPU, and its kernels and CUDA graphs on
the card.

- The forward transform (the unnormalised DCT-II over the route's axes:
  the forward pass's gather into the route's layout, the real FFT,
  ``spectral_forward``) and the inverse (``spectral_inverse``, the inverse
  FFT, the inverse pass: each axis's unnormalised DCT-III) against
  products with ``dct_matrix(n)`` in float64 at n = 5 to 513, odd and
  even, prime (257) or not, on one space axis at each position, on two at
  each pair of positions and on three, with and without a leading batch
  axis: rtol 1e-12, with an absolute floor of 1e-12 times the largest
  entry (the FFT and the matrix sum in different orders, so entries that
  cancel to near zero need it).
- ``DctPoisson.solve`` with its axes on the FFT route against the matrix
  route, the route forced by ``FAST_DCT_MIN``: in float64 to the same
  1e-12; in float32 both routes within 2e-6 of the largest entry of the
  float64 solve (each rounds its float32 sums, O(log n) of them on the FFT
  route and O(n) on the matrix route: a few 1e-7 of the largest entry at
  these sizes). 1D, 2D and 3D grids, one to three space axes on the
  route, a shorter space axis before or between the route's, a t axis
  longer than the route's (it keeps its matrix), a stack of instances,
  the Helmholtz shift, the IR float64 solve, the flat engine's solve.
- The route is a function of a space axis's length alone; t never takes
  it.
- The device driver's ``fast_dct_iters``: each level's iterations where
  its phi-solve takes the FFT route, else 0 (the sGS sweep has no DCT),
  in a solve on cached drivers and in the lockstep fleet.
- On the card (``cuda``): the spectral kernel against its plain version
  (1e-6 of the largest entry: the twiddles' complex products may round
  differently, one ulp) at 513^2 x 65 and on odd and even grids with one,
  two or three route axes, a shorter axis before the route's, a stack of
  instances, one launch a step; the t axis's kernel (its transform and
  the layout's gather) against the matrix product and the gather, to the
  same 1e-6 (it sums over t in its own order; 1e-6 T / 65 past T = 65),
  on the same grids and at T = 200 and 600 (A past shared memory); the solve on the card against
  the float64 solve, and its refusal of a non-contiguous rhs; a level's
  segments replayed from CUDA graphs, the FFT route on, bit-equal to the
  same segments run eagerly.

The file imports no JAX; on the card:

    python -m pytest --noconftest -o addopts="" tests/test_torch_fast_dct.py -q
"""
import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache, solve_dot
from dotsocp_tpu_torch.ops import poisson
from dotsocp_tpu_torch.ops.engine import OpsFlat
from dotsocp_tpu_torch.ops.geometry import Geometry

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
LENGTHS = (5, 9, 17, 33, 65, 129, 257, 513)


def close(got, want, rtol=1e-12, floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-300))


def _cosines(n):
    """cos(pi k (2j + 1) / (2n)): dct_matrix without its scales."""
    C = poisson.dct_matrix(n, F64, "cpu").numpy()
    return C / np.where(np.arange(n) == 0, np.sqrt(1.0 / n),
                        np.sqrt(2.0 / n))[:, None]


def _along(M, x, ax):
    """M applied along axis ``ax`` of x."""
    return np.moveaxis(np.tensordot(M, x, axes=([1], [ax])), 0, ax)


# (n, the other route axis's length or None, the space shape with n at
# ``*``, the route's space axes, leading batch axes)
TRANSFORMS = ([(n, (n, 4), (1,), lead) for n in LENGTHS
               for lead in ((), (2,))]
              + [(n, (4, n), (2,), lead) for n in LENGTHS
                 for lead in ((), (2,))]
              + [(n, (n,), (1,), lead) for n in LENGTHS
                 for lead in ((), (2,))]
              + [(n, space, axes, ()) for n in LENGTHS
                 for space, axes in (((n, 8, 3), (1, 2)),
                                     ((n, 3, 8), (1, 3)),
                                     ((3, n, 8), (2, 3)),
                                     ((n, 8, 6), (1, 2, 3)))])


@pytest.mark.parametrize("n, space, axes, lead", TRANSFORMS,
                         ids=["x".join(map(str, s)) + "-"
                              + "".join(map(str, a)) + f"-{len(l)}"
                              for n, s, a, l in TRANSFORMS])
def test_fft_transforms_match_the_matrix(n, space, axes, lead):
    """One space axis of n points on the route (first, last or alone;
    the other 4 long), two (n and 8 points, at each pair of places; the
    third 3 long) or three (n, 8 and 6); t 3 long, its matrix the identity
    here, so the passes only lay the points out."""
    shape = (3,) + space
    rng = np.random.default_rng(n + 10 * sum(axes) + len(lead))
    x = rng.standard_normal(lead + shape)
    plan = poisson._fft_plan(np.ones(shape), axes, F64, "cpu",
                             torch.eye(3, dtype=F64))
    lead_ax = len(lead)
    rest = [a for a in range(len(shape)) if a not in axes]
    perm = tuple(range(lead_ax)) + tuple(lead_ax + a for a in rest + list(axes))

    # forward: the DCT-II over the route's axes, the rest in place, then
    # the route's axes last (the plan's layout)
    want = x
    for a in axes:
        want = _along(_cosines(shape[a]), want, lead_ax + a)
    want = np.transpose(want, perm)
    v = poisson.t_gather_plain(torch.from_numpy(x), plan, 0)
    assert tuple(v.shape) == lead + (3,) + plan.layout
    V = torch.fft.rfftn(v, dim=poisson._dims(plan))
    F = poisson.spectral_forward(V, plan).numpy()
    last = shape[axes[-1]]
    h = last // 2 + 1
    close(F.real, want[..., :h])
    close(-F.imag[..., 1:], want[..., last - np.arange(1, h)])
    assert np.abs(F.imag[..., 0]).max() <= 1e-12 * np.abs(want).max()

    # inverse: each axis's unnormalised DCT-III (Y_0 + 2 sum_k Y_k cos) of
    # coefficients Y held as the forward pass holds them
    Y = rng.standard_normal(want.shape)
    k = np.arange(h)
    Fy = Y[..., :h] - 1j * np.where(k == 0, 0.0, Y[..., (last - k) % last])
    back = poisson.t_gather_plain(poisson._inverse_fft(
        poisson.spectral_inverse(torch.from_numpy(Fy), plan), plan), plan, 1)
    assert back.is_contiguous() and tuple(back.shape) == lead + shape
    inv = np.transpose(Y, np.argsort(perm))
    for a in axes:
        na = shape[a]
        w = np.where(np.arange(na) == 0, 1.0, 2.0)
        inv = _along(_cosines(na).T * w, inv, lead_ax + a)
    close(back.numpy(), inv)


def _pair(monkeypatch, geom, fast_min, **kw):
    """The solver on the matrix route everywhere, and on the FFT route for
    every axis of at least ``fast_min`` points."""
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", 10 ** 9)
    mat = poisson.make_dct_poisson(geom, device="cpu", **kw)
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", fast_min)
    fft = poisson.make_dct_poisson(geom, device="cpu", **kw)
    return mat, fft


CASES = {
    "2d": (Geometry(5, (17, 16)), 2, (), None),
    "2d_space_only": (Geometry(9, (33, 17)), 17, (), None),
    "1d": (Geometry(6, (65,)), 2, (), None),
    "3d": (Geometry(4, (9, 8, 5)), 2, (), None),
    "3d_mixed": (Geometry(4, (9, 5, 8)), 8, (), None),
    "stack": (Geometry(5, (17, 9)), 9, (3,), None),
    "not_last": (Geometry(5, (33, 9)), 33, (2,), None),
    "long_t": (Geometry(40, (9, 12)), 9, (), None),
    "helmholtz": (Geometry(5, (9, 12)), 2, (), 2.5),
}


def _route(geom, fast_min):
    """The space axes of at least ``fast_min`` points; never t."""
    return tuple(ax for ax, n in enumerate(geom.space, 1) if n >= fast_min)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_fft_route_matches_matrix_route_f64(monkeypatch, name):
    geom, fast_min, lead, eps = CASES[name]
    mat, fft = _pair(monkeypatch, geom, fast_min, D=1.3, epsilon=eps,
                     dtype=F64)
    assert fft.fast_axes == _route(geom, fast_min)
    assert mat.fast_axes == () and mat.fft is None
    # one eager inverse kernel a route: the FFT route's on its plan alone
    assert fft.inv_kernel is None and mat.inv_kernel is not None
    rhs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        lead + (geom.nt,) + geom.space))
    for scale in (None, 0.7):
        close(fft.solve(rhs, scale), mat.solve(rhs, scale))


@pytest.mark.parametrize("name", ["2d", "3d", "3d_mixed", "stack",
                                  "not_last"])
def test_solve_fft_route_matches_matrix_route_f32(monkeypatch, name):
    """Both float32 routes within 2e-6 of the largest entry of the float64
    solve (module docstring)."""
    geom, fast_min, lead, eps = CASES[name]
    mat, fft = _pair(monkeypatch, geom, fast_min, D=1.3, dtype=F32)
    exact = poisson.make_dct_poisson(geom, D=1.3, dtype=F64, device="cpu")
    rhs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        lead + (geom.nt,) + geom.space))
    want = exact.solve(rhs, 0.7).numpy()
    for p in (fft, mat):
        got = p.solve(rhs.to(F32), 0.7)
        assert got.dtype == F32
        close(got.double().numpy(), want, rtol=0.0, floor=2e-6)


def test_ir_solve_on_the_fft_route(monkeypatch):
    """The IR float64 solve with its float32 preconditioner on the FFT
    route: two rounds within 1e-11 of the exact solve, as on the matrix
    route (``tests/test_torch_refine.py``)."""
    geom = Geometry(9, (33, 33))
    exact = poisson.make_dct_poisson(geom, dtype=F64, device="cpu")
    _, ir = _pair(monkeypatch, geom, 33, split="ir")
    assert ir.fast_axes == (1, 2) and ir.fft.kernel.dtype == F32
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (geom.nt,) + geom.space))
    want = exact.solve(rhs, 0.5)
    close(ir.solve(rhs, 0.5), want, rtol=0.0, floor=1e-11)


def test_flat_engine_solve_on_the_fft_route(monkeypatch):
    """The flat engine's solve (fields ``(..., nt, S)``) on the FFT route
    against the matrix route; it reports the FFT axes."""
    geom = Geometry(5, (17, 17))
    ops = OpsFlat(geom, F64, "cpu")
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", 10 ** 9)
    mat = ops.make_poisson(1.0)
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", 17)
    fft = ops.make_poisson(1.0)
    assert fft.fast_axes == (1, 2) and mat.fast_axes == ()
    rhs = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, geom.nt, ops.S)))
    close(fft.solve(rhs, 0.3), mat.solve(rhs, 0.3))


def test_route_by_length_alone():
    """A space axis takes the FFT route at ``FAST_DCT_MIN`` points or
    more, whatever its place and whatever the other axes; the t axis keeps
    its matrix at any length."""
    m = poisson.FAST_DCT_MIN
    assert not poisson.fast_axis(m - 1) and poisson.fast_axis(m)
    assert poisson.fast_axis(2 * m + 1)
    for ns, want in [((m, 5, m - 1), ()), ((5, m - 1, m), (2,)),
                     ((m - 1, 3, 5), ()), ((3, m, m), (1, 2)),
                     ((2 * m, m), (1,)), ((3, m, 4), (1,))]:
        geom = Geometry(ns[0], ns[1:])
        p = poisson.make_dct_poisson(geom, dtype=F64, device="cpu")
        assert p.fast_axes == want == _route(geom, m)


@pytest.mark.parametrize("mode, method", [("solve_dot", "inPALM"),
                                          ("solve_dot", "sGS-inPALM"),
                                          ("lockstep", "inPALM")])
def test_drivers_count_fast_dct_iters(monkeypatch, mode, method):
    """Each level's ``driver`` dict has ``fast_dct_iters``: the level's
    iterations where its phi-solve takes the FFT route (here the 17^2
    level, FAST_DCT_MIN 17), 0 on the 9^2 level and under the sGS sweep
    (sGS-inPALM's finest level); the same on a second solve, from the
    cached drivers."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    monkeypatch.setattr(poisson, "FAST_DCT_MIN", 17)
    r0, r1 = get_example_2d("example2", 17, 17)
    clear_solver_cache()
    try:
        for _ in range(2):
            if mode == "solve_dot":
                out, _, _ = solve_dot(r0, r1, 5, 2, {"tol": 1e-3}, method,
                                      device="cpu", verbose=False)
            else:
                out = solve_fleet([r0, r1], [r1, r0], 5, {"tol": 1e-3},
                                  method, dtype=F32, level_n=2,
                                  mode="lockstep", verbose=False,
                                  device="cpu")
            levels = out["levels"]
            assert [lv["geom"].space for lv in levels] == [(9, 9), (17, 17)]
            coarse, fine = (lv["driver"]["fast_dct_iters"] for lv in levels)
            assert coarse == 0 and levels[1]["iters"] > 0
            assert fine == (0 if method == "sGS-inPALM"
                            else levels[1]["iters"])
    finally:
        clear_solver_cache()


# -- the card --------------------------------------------------------------------

KERNEL_CASES = {
    "513x65": (65, (513, 513), 513, ()),
    "even": (9, (17, 16), 16, ()),
    "stack": (7, (12, 9), 9, (3,)),
    "one_axis": (5, (64,), 64, ()),
    "one_axis_stack": (5, (9, 33), 33, (2,)),
    "not_last": (5, (33, 9), 33, ()),
    "three_axes": (3, (9, 8, 6), 6, ()),
    "three_axes_stack": (4, (7, 9, 5), 5, (2,)),
    # A past shared memory: read through L1, a tile of 128, then of 64
    "long_t": (200, (40,), 40, ()),
    "longer_t": (600, (33,), 33, ()),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_spectral_kernel_matches_plain(dev, monkeypatch, name):
    """One launch of the spectral kernel, in place, against its plain
    version on the same half spectrum, within 1e-6 of the largest entry
    (module docstring)."""
    nt, space, fast_min, lead = KERNEL_CASES[name]
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", fast_min)
    plan = poisson.make_dct_poisson(Geometry(nt, space), D=1.3, dtype=F32,
                                    device=dev).fft
    rest = tuple(plan.kernel.shape[:-1 - len(plan.n)])
    gen = torch.Generator().manual_seed(nt)
    V = torch.view_as_complex(torch.randn(
        lead + rest + tuple(plan.twiddle.shape) + (2,), generator=gen)).to(dev)
    want = poisson.spectral_multiply_plain(V.clone(), plan, 0.37)
    before = poisson.LAUNCHES["dct_spectral"]
    got = poisson.spectral_multiply(V.clone(), plan, 0.37)
    torch.cuda.synchronize()
    assert poisson.LAUNCHES["dct_spectral"] == before + 1
    close(got.cpu().numpy(), want.cpu().numpy(), rtol=0.0, floor=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_t_gather_kernel_matches_plain(dev, monkeypatch, name):
    """The t axis's transform and the layout's gather in one launch, each
    way, against the matrix product along t and the gather (rtol 0, 1e-6
    of the largest entry: the kernel sums over t in its own order; past
    T = 65, 1e-6 T / 65, as the rounding of a sum of T terms grows); a
    solve launches each kernel once a way, and where T <= 65 it is within
    2e-6 of the largest entry of the float64 solve (module docstring); a
    non-contiguous rhs that reaches a pass raises."""
    nt, space, fast_min, lead = KERNEL_CASES[name]
    monkeypatch.setattr(poisson, "FAST_DCT_MIN", fast_min)
    geom = Geometry(nt, space)
    p = poisson.make_dct_poisson(geom, D=1.3, dtype=F32, device=dev)
    plan = p.fft
    gen = torch.Generator().manual_seed(nt + 1)
    x = torch.randn(lead + (nt,) + space, generator=gen).to(dev)
    for which, v in ((0, x), (1, x.reshape(lead + (nt,) + plan.layout))):
        want = poisson.t_gather_plain(v, plan, which)
        got = poisson.t_gather(v, plan, which)
        close(got.cpu().numpy(), want.cpu().numpy(), rtol=0.0,
              floor=1e-6 * max(1.0, nt / 65))
    poisson.reset_launches()
    got = p.solve(x, 0.5)
    torch.cuda.synchronize()
    assert poisson.LAUNCHES == dict(dict.fromkeys(poisson.LAUNCHES, 0),
                                    dct_spectral=1, dct_t_gather=2)
    if nt <= 65:
        exact = poisson.make_dct_poisson(geom, D=1.3, dtype=F64,
                                         device="cpu")
        close(got.double().cpu().numpy(),
              exact.solve(x.double().cpu(), 0.5).numpy(), rtol=0.0,
              floor=2e-6)
    if len(plan.axes) == len(space):
        # every space axis on the route: the rhs goes to the pass as it is
        strided = torch.randn(lead + (nt,) + space + (2,),
                              device=dev)[..., 0]
        with pytest.raises(ValueError, match="contiguous"):
            p.solve(strided, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ca", "acc"])
def test_graph_replay_matches_eager_on_the_fft_route(dev, monkeypatch, name):
    """40 iterations replayed from CUDA graphs against the same run eager,
    then after a rescale and a sigma change, with the 33^2 x 9 level's
    spatial axes on the FFT route (cuFFT and the spectral kernel inside
    the graphs): bit-equal."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.device_driver import (
        AccDeviceDriver, DeviceDriver, replay_against_eager)
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.algorithms.variants import AccADMMKernels
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import (initial_scaling,
                                                    initialize)

    monkeypatch.setattr(poisson, "FAST_DCT_MIN", 33)
    r0, r1 = get_example_2d("example2", 33, 33)
    lv = initialize(r0, r1, 9, dtype=F32, device=dev)
    initial_scaling(lv, True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=str(dev),
                      tau=1.9, dtype=F32)
    o = SolveOptions()
    if name == "acc":
        def make():
            return AccDeviceDriver(AccADMMKernels(cfg), o)
        counter = 80
    else:
        def make():
            return DeviceDriver(Kernels(cfg), o)
        counter = None
    assert make().k.fast_dct
    for what, gap, first, _ in replay_against_eager(make, lv.as_dict(), 40,
                                                    counter):
        assert first is None, f"{what}: tensor {first} differs by {gap}"
