"""The matrix route's three passes of the DCT Poisson solve
(``ops/poisson.py``: :func:`dense_route`, :func:`dense_passes` and its
plain version, ``csrc/dct_dense.cu``), on the CPU, and the kernels and
their CUDA graphs on the card.

- The route: the passes for a float32 rhs on a CUDA device over a grid
  of three axes (t, y, x) with no space axis on the FFT route and no axis
  longer than ``DENSE_PASS_MAX``; the matmuls for the CPU, float64, 1D and
  3D grids, a solver with FFT axes, and longer axes. The rule reads
  metadata alone, so the CPU tests ask it about CUDA devices.
- The plain version follows the passes' arithmetic (the slab product
  C_y X C_x^T, the t axis's transform, kernel and inverse a column, the
  inverse slab product); in float64 it matches the matmul composition
  (one product an axis each way) to rtol 1e-12, with an absolute floor of
  1e-12 times the largest entry, at 5x7x9, 33^2 x 9, 33^3 and 129^2 x 17,
  with and without a leading batch axis and the Helmholtz shift.
- The CPU solves (float32 and float64, 1D, 2D, 3D) run the matmul
  composition as before, bit for bit, and never reach the passes.
- The device drivers' ``dct_kernel_iters``, 0 on the CPU, in a solve and
  in the lockstep fleet.
- On the card (``cuda``): the passes against the float64 solve within
  2e-6 of its largest entry at every matrix-route level shape of the
  benchmark's cells (33^2 x 9, 65^2 x 17, 129^2 x 17, 129^2 x 33, 33^3,
  65^3, 129^3), an odd 37 x 50 x 11 and a stack of 3 at 33^2 x 9, in three
  launches a solve; an unaligned contiguous rhs; the refusal of a
  non-contiguous rhs; a level's
  segments replayed from CUDA graphs bit-equal to the same segments run
  eagerly.

The file imports no JAX; on the card:

    python -m pytest --noconftest -o addopts="" tests/test_torch_dense_dct.py -q
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
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
PASSES = ("dct_slab_fwd", "dct_t_spectral", "dct_slab_inv")


def close(got, want, rtol=1e-12, floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-300))


M = poisson.DENSE_PASS_MAX
# (grid, dtype, device, the solver's FFT axes, passes?)
ROUTES = {
    "cuda_f32_2d": ((33, 129, 129), F32, CUDA, (), True),
    "cuda_f32_129_cube": ((129, 129, 129), F32, CUDA, (), True),
    "cuda_f32_odd": ((11, 37, 50), F32, CUDA, (), True),
    "cpu_f32_2d": ((33, 129, 129), F32, CPU, (), False),
    "cuda_f64_2d": ((33, 129, 129), F64, CUDA, (), False),
    "cuda_f32_1d": ((33, 1025), F32, CUDA, (), False),
    "cuda_f32_3d": ((9, 17, 17, 17), F32, CUDA, (), False),
    "cuda_f32_fft": ((33, 257, 257), F32, CUDA, (1, 2), False),
    "cuda_f32_fft_short_axis": ((9, 33, 257), F32, CUDA, (2,), False),
    "cuda_f32_longest": ((M, M, M), F32, CUDA, (), True),
    "cuda_f32_space_past_max": ((9, M + 1, 33), F32, CUDA, (), False),
    "cuda_f32_t_past_max": ((M + 1, 33, 33), F32, CUDA, (), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_dense_route(name):
    grid, dtype, device, fast, want = ROUTES[name]
    assert poisson.dense_route(grid, dtype, device, fast) is want
    assert poisson.dense_route(grid, dtype, str(device), fast) is want


def test_dense_pass_max_fits_shared_memory():
    """At ``DENSE_PASS_MAX``, below ``FAST_DCT_MIN``, a slab (with the
    smallest run of 4 rows) and the t matrix (with the narrowest tile of 8
    columns) fit the 227 KB a block of the H100 may opt in to, with room:
    the kernels' own sizes in floats."""
    def pad4(n):
        return -(-n // 4) * 4

    def slab(n):
        return 4 * (n * pad4(n) + 2 * n * 4)

    def t_pass(n):
        return 4 * (n * pad4(n) + 2 * n * 8)

    optin = 232448
    assert M < poisson.FAST_DCT_MIN
    assert max(slab(M), t_pass(M)) <= 0.8 * optin
    # the matrix route's longest space axis does not fit: the rule's reason
    assert slab(poisson.FAST_DCT_MIN - 1) > optin


def test_solver_route_reads_its_build():
    """A solver asks the rule with its own grid and FFT axes; an IR
    build's float64 rhs runs its float32 preconditioner on the passes; the
    flat engine's solve asks its inner solver."""
    geom = Geometry(9, (33, 33))
    p = poisson.make_dct_poisson(geom, dtype=F32, device="cpu")
    assert p.on_passes(F32, CUDA) and not p.on_passes(F32, CPU)
    assert not p.on_passes(F64, CUDA) and p.dense is None
    ir = poisson.make_dct_poisson(geom, split="ir", device="cpu")
    assert ir.on_passes(F64, CUDA)
    fft = poisson.make_dct_poisson(Geometry(9, (33, 257)), dtype=F32,
                                   device="cpu")
    assert fft.fast_axes == (2,) and not fft.on_passes(F32, CUDA)
    flat = OpsFlat(geom, F32, "cpu").make_poisson(1.0)
    assert flat.on_passes(F32, CUDA) and not flat.on_passes(F32, CPU)


# (T, ny, nx)
PLAIN_SHAPES = {"5x7x9": (5, 7, 9), "33sq_x9": (9, 33, 33),
                "33cube": (33, 33, 33), "129sq_x17": (17, 129, 129)}
PLAIN_CASES = [(s, lead, eps) for s in PLAIN_SHAPES for lead in ((), (2,))
               for eps in (None, 2.5)]


@pytest.mark.parametrize("shape, lead, eps", PLAIN_CASES,
                         ids=[f"{s}-{len(lead)}-{eps}"
                              for s, lead, eps in PLAIN_CASES])
def test_plain_passes_match_the_matmuls_f64(shape, lead, eps):
    T, ny, nx = PLAIN_SHAPES[shape]
    p = poisson.make_dct_poisson(Geometry(T, (ny, nx)), D=1.3, epsilon=eps,
                                 dtype=F64, device="cpu")
    rhs = torch.from_numpy(np.random.default_rng(T + ny).standard_normal(
        lead + (T, ny, nx)))
    for scale in (None, 0.7):
        close(poisson.dense_passes_plain(rhs, p, scale),
              p._matmuls(rhs, scale))


# (grid, leading axes)
CPU_SOLVES = {"1d": ((9, 33), ()), "2d": ((9, 33, 17), (2,)),
              "3d": ((5, 9, 8, 7), ())}


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", list(CPU_SOLVES))
def test_cpu_solves_keep_the_matmuls(monkeypatch, name, dtype):
    """On the CPU every solve is the matmul composition, bit for bit, and
    never reaches the passes."""
    grid, lead = CPU_SOLVES[name]

    def refuse(*args):
        raise AssertionError("the passes ran on the CPU")

    monkeypatch.setattr(poisson, "dense_passes", refuse)
    p = poisson.make_dct_poisson(Geometry(grid[0], grid[1:]), D=1.3,
                                 dtype=dtype, device="cpu")
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        lead + grid)).to(dtype)
    assert torch.equal(p.solve(rhs, 0.7), p._matmuls(rhs, 0.7))


@pytest.mark.parametrize("mode", ["solve_dot", "lockstep"])
def test_drivers_report_dct_kernel_iters(mode):
    """Each level's ``driver`` dict has ``dct_kernel_iters``, 0 on the
    CPU (no level runs the passes), beside ``fast_dct_iters``; the same on
    a second solve, from the cached drivers."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    r0, r1 = get_example_2d("example2", 17, 17)
    clear_solver_cache()
    try:
        for _ in range(2):
            if mode == "solve_dot":
                out, _, _ = solve_dot(r0, r1, 5, 2, {"tol": 1e-3}, "inPALM",
                                      device="cpu", verbose=False)
            else:
                out = solve_fleet([r0, r1], [r1, r0], 5, {"tol": 1e-3},
                                  "inPALM", dtype=F32, level_n=2,
                                  mode="lockstep", verbose=False,
                                  device="cpu")
            levels = out["levels"]
            assert len(levels) == 2 and all(lv["iters"] > 0 for lv in levels)
            assert [lv["driver"]["dct_kernel_iters"] for lv in levels] == [0,
                                                                          0]
    finally:
        clear_solver_cache()


def test_kernels_report_the_route():
    """``Kernels.dct_kernel`` reads the route for the level's dtype and
    device: False on the CPU; the sGS sweep's kernels have no DCT."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.variants import SgsKernels

    geom = Geometry(5, (9, 9))
    cfg = LevelConfig(geom=geom, D=1.0, E=1.0, device="cpu", tau=1.9,
                      dtype=F32)
    k = Kernels(cfg)
    assert not k.dct_kernel and k.poisson.on_passes(F32, CUDA)
    assert SgsKernels.dct_kernel is False


# -- the card --------------------------------------------------------------------

# (T, ny, nx, leading axes)
CARD_SHAPES = {
    "33sq_x9": (9, 33, 33, ()),
    "65sq_x17": (17, 65, 65, ()),
    "129sq_x17": (17, 129, 129, ()),
    "129sq_x33": (33, 129, 129, ()),
    "33cube": (33, 33, 33, ()),
    "65cube": (65, 65, 65, ()),
    "129cube": (129, 129, 129, ()),
    "odd": (11, 37, 50, ()),
    "stack": (9, 33, 33, (3,)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_passes_match_the_f64_solve(dev, name):
    """Three launches a solve (one of each pass, none of the FFT route's),
    within 2e-6 of the largest entry of the float64 solve, with and
    without the Helmholtz shift."""
    T, ny, nx, lead = CARD_SHAPES[name]
    geom = Geometry(T, (ny, nx))
    gen = torch.Generator().manual_seed(T + ny + nx)
    rhs = torch.randn(lead + (T, ny, nx), generator=gen)
    for eps in (None, 2.5):
        p = poisson.make_dct_poisson(geom, D=1.3, epsilon=eps, dtype=F32,
                                     device=dev)
        exact = poisson.make_dct_poisson(geom, D=1.3, epsilon=eps,
                                         dtype=F64, device="cpu")
        poisson.reset_launches()
        got = p.solve(rhs.to(dev), 0.7)
        torch.cuda.synchronize()
        assert poisson.LAUNCHES == dict(dict.fromkeys(poisson.LAUNCHES, 0),
                                        **dict.fromkeys(PASSES, 1))
        assert got.dtype == F32 and got.is_contiguous()
        close(got.double().cpu().numpy(),
              exact.solve(rhs.double(), 0.7).numpy(), rtol=0.0, floor=2e-6)


@pytest.mark.cuda
def test_passes_take_an_unaligned_rhs(dev):
    """A contiguous rhs one float past a 16-byte boundary (rows of a
    multiple of 4 floats, which the passes would otherwise copy 16 bytes
    at a time): bit-equal to the same rhs aligned."""
    p = poisson.make_dct_poisson(Geometry(5, (9, 16)), dtype=F32, device=dev)
    rhs = torch.randn((5, 9, 16), device=dev)
    shifted = torch.empty(rhs.numel() + 1, device=dev)[1:].view(rhs.shape)
    shifted.copy_(rhs)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(p.solve(shifted, 0.5), p.solve(rhs, 0.5))


@pytest.mark.cuda
def test_passes_refuse_a_non_contiguous_rhs(dev):
    p = poisson.make_dct_poisson(Geometry(9, (33, 33)), dtype=F32,
                                 device=dev)
    strided = torch.randn((9, 33, 33, 2), device=dev)[..., 0]
    with pytest.raises(ValueError, match="contiguous"):
        p.solve(strided, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ca", "acc"])
def test_graph_replay_matches_eager_on_the_passes(dev, name):
    """40 iterations replayed from CUDA graphs against the same run eager,
    then after a rescale and a sigma change, at 33^2 x 9 with the
    phi-solve on the passes (inside the graphs): bit-equal."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.device_driver import (
        AccDeviceDriver, DeviceDriver, replay_against_eager)
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.algorithms.variants import AccADMMKernels
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import (initial_scaling,
                                                    initialize)

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
    assert make().k.dct_kernel
    poisson.reset_launches()
    for what, gap, first, _ in replay_against_eager(make, lv.as_dict(), 40,
                                                    counter):
        assert first is None, f"{what}: tensor {first} differs by {gap}"
    assert poisson.LAUNCHES["dct_t_spectral"] > 0
