"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``: rtol 2e-5 / atol 2e-6 for a kernel
against its plain version (FMA contraction and the association of the
four-term face sum differ, a few ulp), and 2e-6 / 2e-6 for a 4-iteration
CA segment against 4 plain steps at 17^2 x 7 (``tests/test_pallas.py``).
The weighted q-steps and every 3D q-step round as their plain versions
do, operation by operation, and so does the cone projection (its plain version sums the
squares left to right): all three are held to the same rtol 2e-5 /
atol 2e-6, and the weighted q-step to bit-equality. ``run_one`` (the
single-step kernels) is held against plain steps as the CA segment is.
The DIM = 3 forms (C = 14) run on a grid with a different size on each
axis; in 3D the CA segment and ``run_one`` are held to 1e-5 of the largest
entry (``chip_smoke.SEG_REL_3D``). The flat shift is bit-equal to its
plain version. The sweep kernel (one launch a sweep) is also held on grids
its tiles and halos do not divide. float64 on the card takes the plain
route: an f64 solve checks KKT at the CPU's iterations, with residuals
within 1e-6, and launches nothing; float16 and mixed dtypes raise. The
refine tail: the IR-DCT solve on the card against the float64 CPU solve at
129^2 x 33 and 513^2 x 65, and a small solve whose float64 tail launches
no kernel and reaches its refine_tol. The device driver: 40 iterations replayed from
its CUDA graphs bit-equal to the same iterations eager (inPALM's x-carry
segment, acc-ADMM across an anchor restart, sGS-inPALM, the float64 plain
route), also after a rescale and after a sigma change; no host sync inside
its loop but one a check; ``LAUNCHES`` counting each replay's kernels
(folded at the end of a segment, a warm and a cached solve); a
capture that fails raising; the kernels that take sd bit-equal with sd
read from memory (the ``*_dev`` entries the graphs launch). The phi-step
rhs kernel (``phi_rhs``, weighted or not, one instance or a stack) is
bit-equal to its plain version at 1025 x 33, 129^2 x 33, 65^2 x 17,
33^2 x 9, 17^3 x 9 and two grids whose spacings are not powers of two,
counted once an iteration (from graphs too) and
never in a check; a 129^2 x 33 solve takes the same iterations and gives
the same rho with the plain rhs forced in its place. ``make_sharded_step``
over a one-rank ("batch",) mesh launches the single-step kernels for each
instance, bit-equal to each instance's own ``run_one``.
"""
import math

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.algorithms import core
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.algorithms.variants import AccADMMKernels, SgsKernels
from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.models.examples import (get_example_1d,
                                               get_example_2d,
                                               get_example_3d)
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.multilevel.solve import solve_dot
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops import sgs_sweep, shift
from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.poisson import make_dct_poisson
from dotsocp_tpu_torch.ops.sgs import make_sgs
from dotsocp_tpu_torch.ops.staggered import Staggered

pytestmark = pytest.mark.cuda

F32 = torch.float32
SHAPES = {"2d": (9, (33, 33)), "1d": (9, (129,)), "3d": (9, (9, 17, 33))}
CA_KERNELS = ("x_step", "qx_step", "cx_step", "cx_final")
SINGLE_STEP_KERNELS = ("z_step", "q_step", "q_step_w", "beta_step",
                       "cone_project_diff")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def close(got, want, rtol=2e-5, atol=2e-6):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _inputs(name, dev, seed=0):
    nt, space = SHAPES[name]
    geom = Geometry(nt, space)
    ops = OpsFlat(geom, F32, dev)
    rng = np.random.default_rng(seed)
    S, d, C = ops.S, geom.ndim_space, geom.cone_cols

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def stag():
        return Staggered(rand(nt - 1, S), rand(d, nt, S) * ops.masks)

    D = math.sqrt(2.0) * math.sqrt(geom.h_mean)
    E = D / math.sqrt(2.0)
    d_in, d_bd = diag_values(D, E)
    return ops, dict(q=stag(), alpha=stag(), phi=rand(nt, S),
                     beta=rand(C, nt - 1, S), x=rand(C, nt - 1, S), D=D,
                     sbf=E / D, sd=1.0, tau=1.9,
                     dinv=(1.0 / d_in, 1.0 / d_bd))


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernels_match_plain(dev, name):
    ops, v = _inputs(name, dev)
    before = dict(fs.LAUNCHES)
    close(fs.x_step(ops, v["q"], v["beta"], v["sbf"], v["sd"]),
          fs.x_step_plain(ops, v["q"], v["beta"], v["sbf"], v["sd"]))
    want_q, want_a = fs.qx_step_plain(ops, v["phi"], v["x"], v["alpha"],
                                      v["dinv"], v["D"], v["sbf"], v["tau"])
    q, a = fs.qx_step(ops, v["phi"], v["x"], v["alpha"].clone(), v["dinv"],
                      v["D"], v["sbf"], v["tau"])
    for got, want in zip(q.blocks() + a.blocks(),
                         want_q.blocks() + want_a.blocks()):
        close(got, want)
        # the 3D q-steps round as their plain versions do
        assert name != "3d" or torch.equal(got, want)
    assert float((q.bs * (1.0 - ops.masks)).abs().max()) == 0.0
    for final in (False, True):
        want = fs.cx_step_plain(ops, v["beta"], v["x"], v["q"], v["sbf"],
                                v["sd"], v["tau"], final)
        fn = fs.cx_final if final else fs.cx_step
        got = fn(ops, v["beta"].clone(), v["x"].clone(), v["q"], v["sbf"],
                 v["sd"], v["tau"])
        close(got[0], want[0])
        close(got[1], want[1])
    torch.cuda.synchronize()
    # one launch of each unweighted x-carry kernel, none of the others
    assert all(fs.LAUNCHES[k] == before[k] + (k in CA_KERNELS)
               for k in fs.LAUNCHES)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ops, v = _inputs("2d", dev)
    with pytest.raises(TypeError, match="float32"):
        fs.x_step(ops, v["q"], v["beta"].double(), v["sbf"], v["sd"])
    with pytest.raises(ValueError, match="contiguous"):
        fs.x_step(ops, v["q"], v["beta"].transpose(1, 2), v["sbf"], v["sd"])
    with pytest.raises(ValueError, match="shape"):
        fs.x_step(ops, v["q"], v["beta"][:, :-1].contiguous(), v["sbf"],
                  v["sd"])
    with pytest.raises(ValueError, match="share storage"):
        fs.cx_step(ops, v["beta"], v["beta"], v["q"], v["sbf"], v["sd"],
                   v["tau"])


@pytest.mark.parametrize("k", [1, 4])
def test_ca_segment_matches_plain_steps(dev, k):
    r0, r1 = get_example_2d("example2", 17, 17)
    lv = initialize(r0, r1, 7, dtype=F32, device=dev)
    initial_scaling(lv, scaling=True)
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=dev,
                               dtype=F32))
    s = kern.prep(lv.as_dict(), 1.0)
    plain = s.clone()
    for _ in range(k):
        plain = kern._step_plain(plain)
    seg = kern.run_segment(s.clone(), k)
    for name in ("phi", "z", "beta"):
        close(getattr(seg, name), getattr(plain, name), 2e-6, 2e-6)
    for name in ("q", "alpha"):
        for got, want in zip(getattr(seg, name).blocks(),
                             getattr(plain, name).blocks()):
            close(got, want, 2e-6, 2e-6)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_solve_on_card_matches_cpu(dev, dim):
    """The same small f32 solve on the card and on the CPU: equal iteration
    counts on every level, densities within f32 rounding."""
    if dim == 1:
        r0, r1 = get_example_1d("gaussian", 65)
    elif dim == 2:
        r0, r1 = get_example_2d("example2", 33, 33)
    else:
        r0, r1 = get_example_3d("gaussian", 9, 9, 9)
    runs = {}
    for device in ("cpu", dev):
        fs.reset_launches()
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-3}, "inPALM",
                              device=device, verbose=False)
        runs[str(device)] = out, dict(fs.LAUNCHES)
    (cpu, cpu_n), (gpu, gpu_n) = runs["cpu"], runs[str(dev)]
    assert ([lv["iters"] for lv in gpu["levels"]]
            == [lv["iters"] for lv in cpu["levels"]])
    assert set(cpu_n.values()) == {0}
    assert all(gpu_n[k] > 0 for k in CA_KERNELS)
    assert all(gpu_n[k] == 0 for k in SINGLE_STEP_KERNELS + ("qx_step_w",))
    # the rhs once a CA iteration, none in the checks
    assert gpu_n["phi_rhs"] == gpu_n["qx_step"]
    close(gpu["rho"].cpu(), cpu["rho"], 1e-3, 1e-4)
    assert gpu["mass_ok"] and cpu["mass_ok"]


# -- the sGS sweep kernel ----------------------------------------------------------

# shapes where the sweep kernel's tiles and 3-cell halos do not divide the
# grid: axes of 3 to 5 cells, nt = 3 and 5, a 1D field below one tile
SWEEP_SHAPES = dict(SHAPES, **{
    "1d-short": (3, (5,)), "1d-ragged": (5, (251,)), "2d-thin": (3, (4, 3)),
    "2d-ragged": (5, (3, 70)), "3d-small": (3, (5, 4, 3)),
    "3d-ragged": (5, (3, 17, 30))})


@pytest.mark.parametrize("name", list(SWEEP_SHAPES))
@pytest.mark.parametrize("its", [1, 2])
def test_sweep_kernel_matches_plain(dev, name, its):
    """Within the kernel tolerance, for ``its`` sweeps in one call and for
    two chained calls; the input phi is left as it was and each sweep is
    one launch."""
    nt, space = SWEEP_SHAPES[name]
    geom = Geometry(nt, space)
    rng = np.random.default_rng(5)
    phi, rhs = (torch.from_numpy(rng.standard_normal(
        geom.phi_shape, dtype=np.float32)).to(dev) for _ in range(2))
    sgs = make_sgs(geom, dtype=F32, device=dev)
    before = phi.clone()
    n0 = sgs_sweep.LAUNCHES["rb_sweep"]
    got = sgs_sweep.rb_sweep(sgs, phi, rhs, 0.3, its)
    torch.cuda.synchronize()
    assert sgs_sweep.LAUNCHES["rb_sweep"] == n0 + its
    close(got, sgs.sweep(phi, rhs, its, d2=0.3))
    chained = phi
    for _ in range(its):
        chained = sgs_sweep.rb_sweep(sgs, chained, rhs, 0.3)
    close(chained, sgs.sweep(phi, rhs, its, d2=0.3))
    assert torch.equal(phi, before)


def test_sweep_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """Aliased operands, wrong shapes and a dtype the card has no route for
    (float16, or float32 mixed with float64) raise; float64 takes the plain
    version without a launch."""
    geom = Geometry(*SHAPES["2d"])
    sgs = make_sgs(geom, dtype=F32, device=dev)
    phi = torch.zeros(geom.phi_shape, dtype=F32, device=dev)
    with pytest.raises(ValueError, match="share storage"):
        sgs_sweep.rb_sweep(sgs, phi, phi, 0.3)
    with pytest.raises(ValueError, match="shape"):
        sgs_sweep.rb_sweep(sgs, phi[:-1], phi[1:].clone(), 0.3)
    with pytest.raises(TypeError, match="float32"):
        sgs_sweep.rb_sweep(sgs, phi.half(), phi.half() + 1, 0.3)
    with pytest.raises(TypeError, match="float32"):
        sgs_sweep.rb_sweep(sgs, phi, phi.double() + 1, 0.3)
    n0 = sgs_sweep.LAUNCHES["rb_sweep"]
    rhs = torch.ones(geom.phi_shape, dtype=torch.float64, device=dev)
    got = sgs_sweep.rb_sweep(sgs, phi.double(), rhs, 0.3)
    assert got.dtype == torch.float64
    assert sgs_sweep.LAUNCHES["rb_sweep"] == n0


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_solve_on_card_matches_cpu(dev, method):
    """The same small f32 sGS solve on the card and on the CPU: equal
    iteration counts on every level; the card's sGS level swept with the
    kernel, one launch per iteration."""
    r0, r1 = get_example_2d("example2", 17, 17)
    runs = {}
    for device in ("cpu", dev):
        sgs_sweep.reset_launches()
        out, _, _ = solve_dot(r0, r1, 7, 2, {"tol": 1e-3}, method,
                              device=device, verbose=False)
        runs[str(device)] = out, sgs_sweep.LAUNCHES["rb_sweep"]
    (cpu, cpu_n), (gpu, gpu_n) = runs["cpu"], runs[str(dev)]
    iters = [lv["iters"] for lv in gpu["levels"]]
    assert iters == [lv["iters"] for lv in cpu["levels"]]
    assert cpu_n == 0 and gpu_n == iters[-1]
    close(gpu["rho"].cpu(), cpu["rho"], 1e-3, 1e-4)


# -- float64 on the card -----------------------------------------------------------

def _reset_all_launches():
    fs.reset_launches()
    sgs_sweep.reset_launches()
    shift.reset_launches()


def _all_launches():
    return dict(fs.LAUNCHES, **sgs_sweep.LAUNCHES, **shift.LAUNCHES)


@pytest.mark.parametrize("method", ["inPALM", "sGS-inPALM", "acc-ADMM"])
def test_f64_solve_on_card_matches_cpu(dev, method):
    """float64 on the card takes the plain route, by dtype: the same small
    float64 solve on the card and on the CPU checks KKT at the same
    iterations, with the same counts on every level and residuals that
    agree to 1e-6, and launches no kernel."""
    r0, r1 = get_example_2d("example2", 17, 17)
    runs = {}
    for device in ("cpu", dev):
        _reset_all_launches()
        out, hist, _ = solve_dot(r0, r1, 7, 2, {"tol": 1e-4}, method,
                                 device=device, dtype=torch.float64,
                                 verbose=False)
        runs[str(device)] = out, hist, _all_launches()
    (cpu, cpu_h, _), (gpu, gpu_h, gpu_n) = runs["cpu"], runs[str(dev)]
    assert ([lv["iters"] for lv in gpu["levels"]]
            == [lv["iters"] for lv in cpu["levels"]])
    assert np.array_equal(gpu_h["iter"], cpu_h["iter"])
    np.testing.assert_allclose(gpu_h["kkt"], cpu_h["kkt"], rtol=1e-6,
                               atol=1e-12)
    assert set(gpu_n.values()) == {0}
    assert gpu["rho"].dtype == torch.float64 and gpu["mass_ok"]


def test_wrappers_refuse_float16_and_mixed_dtypes(dev):
    """float32 launches and float64 takes the plain route; float16 on the
    card, and float32 mixed with float64, raise in every wrapper."""
    ops, v = _inputs("2d", dev)
    h = v["beta"].half()
    with pytest.raises(TypeError, match="float32"):
        fs.cone_project_diff(h, h.clone())
    with pytest.raises(TypeError, match="float32"):
        fs.cone_project_diff(v["x"], v["beta"].double())
    with pytest.raises(TypeError, match="float32"):
        shift.flat_shift(v["phi"].half(), 1, True)
    with pytest.raises(TypeError, match="float32"):
        fs.z_step(ops, v["q"], h, v["sbf"], v["sd"])
    _reset_all_launches()
    z2, beta = v["x"].double(), v["beta"].double()
    torch.testing.assert_close(fs.cone_project_diff(z2, beta),
                               fs.cone_project_diff_plain(z2, beta),
                               rtol=0, atol=0)
    assert set(_all_launches().values()) == {0}


# -- the weighted q-step ---------------------------------------------------------

def _weight(name, dev, seed=0):
    """Love-heart barrier weights in 2D; in 1D and 3D seeded weights in
    [0.5, 2] with about one face in eight at the wall weight."""
    nt, space = SHAPES[name]
    if name == "2d":
        return wdot2d.get_weight_by_barrier(space[1], space[0], nt,
                                            wdot2d.barrier_love_heart(),
                                            dtype=F32, device=dev)
    geom = Geometry(nt, space)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=F32, device=dev)
    bs = []
    for a in range(geom.ndim_space):
        b = rng.uniform(0.5, 2.0, geom.b_shape(a))
        b[rng.random(b.shape) < 0.125] = wdot2d.BARRIER_WEIGHT
        bs.append(torch.tensor(b, **f32))
    return Staggered(torch.tensor(rng.uniform(0.5, 2.0, geom.q0_shape), **f32),
                     tuple(bs))


@pytest.mark.parametrize("name", list(SHAPES))
def test_weighted_qx_matches_plain(dev, name):
    """One launch counted under qx_step_w; ghost face slots exactly zero."""
    ops, v = _inputs(name, dev)
    E = v["sbf"] * v["D"]
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(_weight(name, dev)),
                             v["D"], E)
    want_q, want_a = fs.qx_step_plain(ops, v["phi"], v["x"], v["alpha"],
                                      wdinv, v["D"], v["sbf"], v["tau"])
    before = dict(fs.LAUNCHES)
    q, a = fs.qx_step(ops, v["phi"], v["x"], v["alpha"].clone(), wdinv,
                      v["D"], v["sbf"], v["tau"])
    torch.cuda.synchronize()
    for got, want in zip(q.blocks() + a.blocks(),
                         want_q.blocks() + want_a.blocks()):
        close(got, want)
    assert float((q.bs * (1.0 - ops.masks)).abs().max()) == 0.0
    assert fs.LAUNCHES["qx_step_w"] == before["qx_step_w"] + 1
    assert fs.LAUNCHES["qx_step"] == before["qx_step"]


@pytest.mark.parametrize("k", [1, 4])
def test_weighted_ca_segment_matches_plain_steps(dev, k):
    barrier = wdot2d.barrier_love_heart()
    r0, r1 = wdot2d.get_example_w2d("love-heart", 17, 17)
    r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
    weight = wdot2d.get_weight_by_barrier(17, 17, 7, barrier, dtype=F32,
                                          device=dev)
    lv = initialize(r0, r1, 7, dtype=F32, device=dev, weight=weight)
    initial_scaling(lv, scaling=True)
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=dev,
                               dtype=F32), lv.weight)
    s = kern.prep(lv.as_dict(), 1.0)
    plain = s.clone()
    for _ in range(k):
        plain = kern._step_plain(plain)
    n0 = fs.LAUNCHES["qx_step_w"]
    seg = kern.run_segment(s.clone(), k)
    assert fs.LAUNCHES["qx_step_w"] == n0 + k
    for name in ("phi", "z", "beta"):
        close(getattr(seg, name), getattr(plain, name), 2e-6, 2e-6)
    for name in ("q", "alpha"):
        for got, want in zip(getattr(seg, name).blocks(),
                             getattr(plain, name).blocks()):
            close(got, want, 2e-6, 2e-6)


@pytest.mark.parametrize("method", ["inPALM", "acc-ADMM"])
def test_weighted_solve_on_card_matches_cpu(dev, method):
    """The same small weighted f32 solve on the card and on the CPU: both
    reach the tolerance with mass conserved and densities that agree to
    5e-2 in relative L2 (two solves to KKT 1e-3); inPALM's q-steps on the
    weighted kernel, one launch per iteration, the unweighted one never.
    The iteration counts are not held equal: with the 1e6 walls the float32
    trajectory turns on the last bits of the DCT's sums (acc-ADMM at
    17^2 x 9 took 729 + 769 iterations on an H100 and 1089 + 769 on the
    CPU; the JAX package's own float32 and float64 runs of love-heart
    33^2 x 9 take 809 and 144)."""
    barrier = wdot2d.barrier_love_heart()
    r0, r1 = wdot2d.get_example_w2d("love-heart", 17, 17)
    r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
    weight = wdot2d.get_weight_by_barrier(17, 17, 9, barrier, dtype=F32)
    runs = {}
    for device in ("cpu", dev):
        fs.reset_launches()
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-3}, method, weight,
                              barrier, device=device, verbose=False)
        runs[str(device)] = out, dict(fs.LAUNCHES)
    (cpu, cpu_n), (gpu, gpu_n) = runs["cpu"], runs[str(dev)]
    iters = [lv["iters"] for lv in gpu["levels"]]
    assert set(cpu_n.values()) == {0} and gpu_n["qx_step"] == 0
    assert gpu_n["qx_step_w"] == (sum(iters) if method == "inPALM" else 0)
    assert gpu_n["cone_project_diff"] == (sum(iters) if method == "acc-ADMM"
                                          else 0)
    for out in (cpu, gpu):
        assert out["mass_ok"]
        assert all(max(lv["final_kkt"][[0, 2, 5]]) < 1e-3
                   for lv in out["levels"][-1:])
    diff = torch.linalg.norm(gpu["rho"].cpu() - cpu["rho"])
    assert float(diff / torch.linalg.norm(cpu["rho"])) < 5e-2


# -- the single-step kernels -------------------------------------------------------

def _blocks(*fields):
    out = []
    for f in fields:
        out += f.blocks() if isinstance(f, Staggered) else [f]
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_single_step_kernels_match_plain(dev, name):
    """z_step, q_step (unweighted and weighted), beta_step and
    cone_project_diff: within the kernel tolerance, the weighted q-step
    bit-equal, ghost face slots exactly zero, one launch each, and every
    input left as it was."""
    ops, v = _inputs(name, dev)
    E = v["sbf"] * v["D"]
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(_weight(name, dev)),
                             v["D"], E)
    q, alpha, phi, beta, z = v["q"], v["alpha"], v["phi"], v["beta"], v["x"]
    inputs = _blocks(q, alpha, wdinv.w, phi, beta, z)
    kept = [t.clone() for t in inputs]
    sbf, sd, tau, D = v["sbf"], v["sd"], v["tau"], v["D"]
    before = dict(fs.LAUNCHES)
    close(fs.z_step(ops, q, beta, sbf, sd),
          fs.z_step_plain(ops, q, beta, sbf, sd))
    for dinv in (v["dinv"], wdinv):
        got = fs.q_step(ops, phi, z, beta, alpha, dinv, D, sbf, tau)
        want = fs.q_step_plain(ops, phi, z, beta, alpha, dinv, D, sbf, tau)
        for g, w in zip(_blocks(*got), _blocks(*want)):
            close(g, w)
            if dinv is wdinv or name == "3d":
                assert torch.equal(g, w)
        assert float((got[0].bs * (1.0 - ops.masks)).abs().max()) == 0.0
    close(fs.beta_step(ops, beta, z, q, sbf, sd, tau),
          fs.beta_step_plain(ops, beta, z, q, sbf, sd, tau))
    close(fs.cone_project_diff(z, beta), fs.cone_project_diff_plain(z, beta))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(inputs, kept))
    assert all(fs.LAUNCHES[k] == before[k] + (k in SINGLE_STEP_KERNELS)
               for k in fs.LAUNCHES)


def test_cone_kernel_takes_any_width(dev):
    """A cone width outside the solver's (6, 10, 14) takes the generic
    path of the kernel."""
    rng = np.random.default_rng(3)
    z2, beta = (torch.from_numpy(rng.standard_normal((7, 5, 301),
                                                     dtype=np.float32)).to(dev)
                for _ in range(2))
    close(fs.cone_project_diff(z2, beta), fs.cone_project_diff_plain(z2, beta))


def test_single_step_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ops, v = _inputs("2d", dev)
    with pytest.raises(ValueError, match="shape"):
        fs.z_step(ops, v["q"], v["beta"][:, :-1].contiguous(), v["sbf"],
                  v["sd"])
    with pytest.raises(TypeError, match="float32"):
        fs.beta_step(ops, v["beta"].double(), v["x"].double(), v["q"],
                     v["sbf"], v["sd"], v["tau"])
    with pytest.raises(ValueError, match="contiguous"):
        fs.q_step(ops, v["phi"], v["x"].transpose(1, 2), v["beta"],
                  v["alpha"], v["dinv"], v["D"], v["sbf"], v["tau"])
    with pytest.raises(ValueError, match="shape"):
        fs.cone_project_diff(v["x"], v["beta"][:, :-1].contiguous())


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_run_one_matches_plain_steps(dev, weighted):
    """4 run_one steps (the single-step kernels) against 4 plain steps at
    17^2 x 7 within 2e-6, as the CA segment; run_one never writes the state
    it was given."""
    r0, r1 = get_example_2d("example2", 17, 17)
    weight = None
    if weighted:
        barrier = wdot2d.barrier_love_heart()
        r0, r1 = wdot2d.get_example_w2d("love-heart", 17, 17)
        r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
        weight = wdot2d.get_weight_by_barrier(17, 17, 7, barrier, dtype=F32,
                                              device=dev)
    lv = initialize(r0, r1, 7, dtype=F32, device=dev, weight=weight)
    initial_scaling(lv, scaling=True)
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=dev,
                               dtype=F32), lv.weight)
    s = kern.prep(lv.as_dict(), 1.0)
    start = s.clone()
    plain, one = s.clone(), s
    fs.reset_launches()
    for _ in range(4):
        plain = kern._step_plain(plain)
        one = kern.run_one(one)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["q_step_w" if weighted else "q_step"] == 4
    assert fs.LAUNCHES["phi_rhs_w" if weighted else "phi_rhs"] == 4
    assert fs.LAUNCHES["z_step"] == fs.LAUNCHES["beta_step"] == 4
    for a, b in zip(_blocks(s.phi, s.z, s.beta, s.q, s.alpha),
                    _blocks(start.phi, start.z, start.beta, start.q,
                            start.alpha)):
        assert torch.equal(a, b)
    for g, w in zip(_blocks(one.phi, one.z, one.beta, one.q, one.alpha),
                    _blocks(plain.phi, plain.z, plain.beta, plain.q,
                            plain.alpha)):
        close(g, w, 2e-6, 2e-6)


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-ADMM"])
def test_segment_launch_counts(dev, method):
    """A 5-iteration segment: sGS-inPALM runs one sweep (one launch) and one
    z_step, q_step and beta_step an iteration; acc-ADMM one
    cone_project_diff an iteration; both one phi_rhs an iteration; neither
    runs a plain version."""
    r0, r1 = get_example_2d("example2", 17, 17)
    lv = initialize(r0, r1, 7, dtype=F32, device=dev)
    initial_scaling(lv, scaling=True)
    if method == "sGS-inPALM":
        kern = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                      device=dev, dtype=F32))
    else:
        kern = AccADMMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                          device=dev, dtype=F32, tau=1.0))
    state = kern.prep(lv.as_dict(), 1.0)
    fs.reset_launches()
    sgs_sweep.reset_launches()
    kern.run_segment(state, 5)
    torch.cuda.synchronize()
    want = dict(dict.fromkeys(fs.LAUNCHES, 0), phi_rhs=5)
    if method == "sGS-inPALM":
        want.update(z_step=5, q_step=5, beta_step=5)
        assert sgs_sweep.LAUNCHES["rb_sweep"] == 5
    else:
        want.update(cone_project_diff=5)
    assert fs.LAUNCHES == want


# -- the 3D path and the flat shift ------------------------------------------------

@pytest.mark.parametrize("run", ["segment", "run_one"])
def test_3d_steps_match_plain_steps(dev, run):
    """A 4-iteration CA segment, or 4 run_one steps, against 4 plain steps
    at gaussian 9^3 x 5, within 1e-5 of the largest entry; the kernels of
    each path launched as many times as it has iterations or segments."""
    r0, r1 = get_example_3d("gaussian", 9, 9, 9)
    lv = initialize(r0, r1, 5, dtype=F32, device=dev)
    initial_scaling(lv, scaling=True)
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=dev,
                               dtype=F32))
    s = kern.prep(lv.as_dict(), 1.0)
    plain = s.clone()
    for _ in range(4):
        plain = kern._step_plain(plain)
    fs.reset_launches()
    if run == "segment":
        got = kern.run_segment(s.clone(), 4)
        want = dict(x_step=1, qx_step=4, cx_step=3, cx_final=1, phi_rhs=4)
    else:
        got = s
        for _ in range(4):
            got = kern.run_one(got)
        want = dict(z_step=4, q_step=4, beta_step=4, phi_rhs=4)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == dict(dict.fromkeys(fs.LAUNCHES, 0), **want)
    pairs = list(zip(_blocks(got.phi, got.z, got.beta, got.q, got.alpha),
                     _blocks(plain.phi, plain.z, plain.beta, plain.q,
                             plain.alpha)))
    scale = max(float(w.abs().max()) for _, w in pairs)
    err = max(float((g - w).abs().max()) for g, w in pairs)
    assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("name", list(SHAPES))
def test_flat_shift_kernel_matches_plain(dev, name):
    """Bit-equal to the engine's shift at every axis stride, both ways, on
    phi and on a plane of a cone array; one launch each."""
    ops, v = _inputs(name, dev)
    n0 = shift.LAUNCHES["flat_shift"]
    count = 0
    for a, k in enumerate(ops.strides):
        for forward in (True, False):
            plain = ops._sfwd if forward else ops._sbwd
            assert torch.equal(shift.flat_shift(v["phi"], k, forward),
                               plain(v["phi"], a))
            assert torch.equal(shift.flat_shift(v["beta"], k, forward, 3),
                               plain(v["beta"][3], a))
            count += 2
    # a stride beyond the field: all zeros
    S = ops.S
    assert torch.equal(shift.flat_shift(v["phi"], S + 5, True),
                       torch.zeros_like(v["phi"]))
    torch.cuda.synchronize()
    assert shift.LAUNCHES["flat_shift"] == n0 + count + 1


# -- the refine tail -------------------------------------------------------------

@pytest.mark.parametrize("split,bound", [("ir", 1e-11), ("ir1", 1e-8)])
@pytest.mark.parametrize("nt,n", [(33, 129), (65, 513)])
def test_ir_solve_on_card_matches_f64_cpu(dev, nt, n, split, bound):
    """The IR solve of a float64 rhs on the card (float32 transforms, the
    float64 stencil residual) against the plain float64 solve on the CPU,
    relative to its largest entry, with a use-time scale (as tests/
    test_torch_refine.py on the CPU)."""
    rhs = torch.from_numpy(
        np.random.default_rng(nt).standard_normal((nt, n, n)))
    scale = 1.0 / 0.37 ** 2
    geom = Geometry(nt, (n, n))
    want = make_dct_poisson(geom, dtype=torch.float64,
                            device="cpu").solve(rhs, scale=scale)
    ir = make_dct_poisson(geom, split=split, device=dev)
    assert ir.mats[0].dtype == F32 and ir.mats[0].device.type == dev.type
    got = ir.solve(rhs.to(dev), scale=scale)
    assert got.dtype == torch.float64
    err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    assert err < bound, err


@pytest.mark.parametrize("split", ["auto", "ir"])
def test_refine_tail_on_card_launches_nothing(dev, split):
    """A float32 solve on the card, and the same solve with a float64 tail:
    the levels take the same iterations and every kernel is launched as
    often, so the tail (the plain route by dtype) launched none; the tail
    reaches its refine_tol, with float64 rho and mass conserved."""
    r0, r1 = get_example_2d("example2", 33, 33)
    runs = []
    levels = {"tol": 1e-4, "maxit": 10000}
    for opts in (levels,
                 dict(levels, refine_tol=1e-5, refine_dct_split=split)):
        _reset_all_launches()
        out, _, last = solve_dot(r0, r1, 9, 2, opts, "inPALM", device=dev,
                                 verbose=False)
        torch.cuda.synchronize()
        runs.append((out, last, _all_launches()))
    (base, _, n_base), (ref, last, n_ref) = runs
    assert ([lv["iters"] for lv in ref["levels"][:-1]]
            == [lv["iters"] for lv in base["levels"]])
    assert n_ref == n_base and n_base["qx_step"] > 0
    assert ref["levels"][-1]["refine"] is True
    assert max(last["kkt"][-1][[0, 2, 5, 6]]) < 1e-5
    assert ref["rho"].dtype == torch.float64 and ref["mass_ok"]


# -- the device driver's CUDA graphs ---------------------------------------------

def _driver_case(name, dev):
    """(make, var, counter) of a device driver at example2 33^2 x 9."""
    from dotsocp_tpu_torch.algorithms.device_driver import (AccDeviceDriver,
                                                            DeviceDriver)
    from dotsocp_tpu_torch.algorithms.device_sgs import SgsDeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions

    dtype = torch.float64 if name == "f64" else F32
    r0, r1 = get_example_2d("example2", 33, 33)
    lv = initialize(r0, r1, 9, dtype=dtype, device=dev)
    initial_scaling(lv, True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=str(dev),
                      tau=1.9, dtype=dtype)
    o = SolveOptions()
    if name == "acc":
        return (lambda: AccDeviceDriver(AccADMMKernels(cfg), o),
                lv.as_dict(), 80)
    if name == "sgs":
        return lambda: SgsDeviceDriver(SgsKernels(cfg), o), lv.as_dict(), None
    return lambda: DeviceDriver(Kernels(cfg), o), lv.as_dict(), None


@pytest.mark.parametrize("name", ["ca", "acc", "sgs", "f64"])
def test_graph_replay_matches_eager(dev, name):
    """40 iterations replayed from CUDA graphs against the same run eager,
    then again after a rescale and after a sigma change (the scalars the
    kernels read from memory, not frozen in the graph); acc-ADMM crosses an
    anchor restart. Bit-equal."""
    from dotsocp_tpu_torch.algorithms.device_driver import replay_against_eager

    make, var, counter = _driver_case(name, dev)
    for what, gap, first, _ in replay_against_eager(make, var, 40, counter):
        assert first is None, f"{what}: tensor {first} differs by {gap}"


def test_device_driver_syncs_once_per_check(dev):
    """A 2-level solve under torch.cuda.set_sync_debug_mode('error') inside
    the level loops: no host sync but the one read of each check."""
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver

    r0, r1 = get_example_2d("example2", 33, 33)
    DeviceDriver.sync_debug = "error"
    try:
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-4}, "inPALM",
                              device=dev, verbose=False)
    finally:
        DeviceDriver.sync_debug = None
    for lv in out["levels"]:
        stats = lv["driver"]
        assert stats["syncs"] == stats["checks"] > 0
        assert stats["replays"] > stats["captures"] > 0


def test_launches_count_replays(dev):
    """A k-iteration CA segment from graphs adds one x_step and one
    cx_final, k qx_step, k-1 cx_step and k phi_rhs, as the eager segment
    does."""
    make, var, _ = _driver_case("ca", dev)
    d = make()
    d.prepare(var)
    d.segment(3)    # each kind's first use (eager), then capture
    torch.cuda.synchronize()
    for k in (5, 9):
        before = dict(fs.LAUNCHES)
        d.segment(k)
        torch.cuda.synchronize()
        got = {n: fs.LAUNCHES[n] - before[n]
               for n in CA_KERNELS + ("phi_rhs",)}
        assert got == {"x_step": 1, "qx_step": k, "cx_step": k - 1,
                       "cx_final": 1, "phi_rhs": k}
    assert d.graphs.replays > 0


def test_cached_solve_launches_match_replay_accounting(dev, monkeypatch):
    """Two 2-level solves on cached, prewarmed drivers leave ``LAUNCHES``
    where counting each replay's launches as it runs leaves them: the
    replays' counts, folded at the end of each warm and solve, lose none."""
    from dotsocp_tpu_torch.algorithms import graphs
    from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache

    counted = dict.fromkeys(fs.LAUNCHES, 0)
    run = graphs.SegmentGraphs.run

    def counting_run(self, kind, fn):
        before, replays = dict(fs.LAUNCHES), self.replays
        run(self, kind, fn)
        if self.replays > replays:
            delta = self._graphs[kind].deltas[0]
        else:   # an eager first run (and a capture, which counts nothing)
            delta = {k: fs.LAUNCHES[k] - before[k] for k in fs.LAUNCHES}
        for k, n in delta.items():
            counted[k] += n

    monkeypatch.setattr(graphs.SegmentGraphs, "run", counting_run)
    r0, r1 = get_example_2d("example2", 33, 33)
    clear_solver_cache()
    try:
        start = dict(fs.LAUNCHES)
        for _ in range(2):
            out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-4,
                                                 "prewarm": True},
                                  "inPALM", device=dev, verbose=False)
        torch.cuda.synchronize()
        got = {k: fs.LAUNCHES[k] - start[k] for k in fs.LAUNCHES}
    finally:
        clear_solver_cache()
    assert got == counted
    assert got["qx_step"] > 0
    assert all(lv["driver"]["replays"] > 0 and lv["driver"]["captures"] == 0
               for lv in out["levels"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_sd_from_memory_matches_sd_by_value(dev, name):
    """The ``*_dev`` entries (sd read from a float32 tensor on the card, as
    the device driver's graphs launch them) bit-equal to the by-value
    entries with the same float."""
    ops, v = _inputs(name, dev)
    sbf, tau = 0.9, 1.9
    sd_t = torch.full((), 0.37, dtype=F32, device=dev)
    sd = float(sd_t)
    q, beta, x = v["q"], v["beta"], v["x"]
    for run in (lambda s: [fs.x_step(ops, q, beta, sbf, s)],
                lambda s: [fs.z_step(ops, q, beta, sbf, s)],
                lambda s: [fs.beta_step(ops, beta, x, q, sbf, s, tau)],
                lambda s: fs.cx_step(ops, beta.clone(), x.clone(), q, sbf, s,
                                     tau),
                lambda s: fs.cx_final(ops, beta.clone(), x.clone(), q, sbf, s,
                                      tau)):
        for a, b in zip(run(sd), run(sd_t)):
            assert torch.equal(a, b)


def test_failing_capture_raises(dev):
    """A piece that reads a value back to the host cannot be captured: the
    capture raises, and the stream takes work again after it."""
    from dotsocp_tpu_torch.algorithms.graphs import SegmentGraphs

    graphs = SegmentGraphs(dev)
    x = torch.ones(4, device=dev)

    def reads_back():
        x.add_(float(x.sum()))

    with graphs.context():
        graphs.run("reads", reads_back)      # the eager first use
        with pytest.raises(RuntimeError):
            graphs.run("reads", reads_back)  # the capture
        graphs.run("fine", lambda: x.mul_(2.0))
        graphs.run("fine", lambda: x.mul_(2.0))
    torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == 1


# -- the phi-step's right-hand side ------------------------------------------------

# the main path's shapes, whose spacings are powers of two, and two grids
# whose 1/h is rounded (there a division would differ from PyTorch's
# multiplication by the float32 reciprocal)
RHS_SHAPES = {"1d-1025x33": (33, (1025,)), "2d-129x33": (33, (129, 129)),
              "2d-65x17": (17, (65, 65)), "2d-33x9": (9, (33, 33)),
              "3d-17x9": (9, (17, 17, 17)), "2d-9x17x7": (7, (9, 17)),
              "3d-5x7x11x9": (9, (5, 7, 11))}


def _rhs_inputs(name, dev, lead=(), seed=0):
    """(ops, q, alpha, c, D, w): seeded fields with ghost face slots zero,
    a weight in [0.5, 2] with about one entry in eight at the wall weight
    (its ghost slots 1.0)."""
    nt, space = RHS_SHAPES[name]
    geom = Geometry(nt, space)
    ops = OpsFlat(geom, F32, dev)
    rng = np.random.default_rng(seed)
    S, d = ops.S, geom.ndim_space

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(lead + shape, dtype=np.float32)).to(dev)

    def stag():
        return Staggered(rand(nt - 1, S), rand(d, nt, S) * ops.masks)

    def weight(*shape):
        w = rng.uniform(0.5, 2.0, shape)
        w[rng.random(shape) < 0.125] = wdot2d.BARRIER_WEIGHT
        return torch.tensor(w, dtype=F32, device=dev)

    w = Staggered(weight(nt - 1, S),
                  weight(d, nt, S) * ops.masks + (1.0 - ops.masks))
    D = math.sqrt(2.0) * math.sqrt(geom.h_mean)
    return ops, stag(), stag(), rand(nt, S), D, w


@pytest.mark.parametrize("lead", [(), (3,)], ids=["B1", "B3"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", list(RHS_SHAPES))
def test_phi_rhs_kernel_is_bit_equal_to_plain(dev, name, weighted, lead):
    """One launch (under phi_rhs or phi_rhs_w), bit-equal to the plain
    composition on the card, every input left as it was."""
    ops, q, alpha, c, D, w = _rhs_inputs(name, dev, lead)
    w = w if weighted else None
    inputs = _blocks(q, alpha, c) + (w.blocks() if weighted else [])
    kept = [t.clone() for t in inputs]
    key = "phi_rhs_w" if weighted else "phi_rhs"
    before = dict(fs.LAUNCHES)
    got = fs.phi_rhs(ops, q, alpha, c, D, w)
    torch.cuda.synchronize()
    assert all(fs.LAUNCHES[k] == before[k] + (k == key) for k in fs.LAUNCHES)
    want = fs.phi_rhs_plain(ops, q, alpha, c, D, w)
    assert got.shape == c.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    assert all(torch.equal(a, b) for a, b in zip(inputs, kept))


def test_phi_rhs_refuses_what_the_kernel_does_not_take(dev):
    """A non-contiguous or mixed-dtype operand, a wrong shape and a tensor
    D raise; float64 takes the plain route without a launch."""
    ops, q, alpha, c, D, w = _rhs_inputs("2d-33x9", dev)
    nt, S = c.shape
    odd = c.t().contiguous().t()  # (nt, S), strides of the transpose
    with pytest.raises(ValueError, match="contiguous"):
        fs.phi_rhs(ops, q, alpha, odd, D)
    with pytest.raises(TypeError, match="float32"):
        fs.phi_rhs(ops, q, alpha, c.double(), D)
    with pytest.raises(TypeError, match="float32"):
        fs.phi_rhs(ops, q, alpha, c, D, w.map(lambda t: t.double()))
    with pytest.raises(ValueError, match="shape"):
        fs.phi_rhs(ops, q, alpha, c[:-1].contiguous(), D)
    with pytest.raises(ValueError, match="float"):
        fs.phi_rhs(ops, q, alpha, c, torch.tensor(D, device=dev))
    f64 = [x.map(lambda t: t.double()) for x in (q, alpha)]
    before = dict(fs.LAUNCHES)
    got = fs.phi_rhs(ops, *f64, c.double(), D)
    assert got.dtype == torch.float64
    assert torch.equal(got, fs.phi_rhs_plain(ops, *f64, c.double(), D))
    assert fs.LAUNCHES == before


@pytest.mark.parametrize("name", ["sgs", "acc"])
def test_phi_rhs_launches_count_replays(dev, name):
    """k single steps of sGS-inPALM or acc-ADMM replayed from graphs add k
    phi_rhs launches, as the eager segment does (the CA segment:
    ``test_launches_count_replays``)."""
    make, var, _ = _driver_case(name, dev)
    d = make()
    d.prepare(var)
    d.segment(3)    # each kind's first use (eager), then capture
    torch.cuda.synchronize()
    for k in (5, 9):
        n0 = fs.LAUNCHES["phi_rhs"]
        d.segment(k)
        torch.cuda.synchronize()
        assert fs.LAUNCHES["phi_rhs"] - n0 == k
    assert d.graphs.replays > 0


def test_solve_with_the_rhs_kernel_matches_the_plain_rhs(dev, monkeypatch):
    """DOTmark 129^2 x 33, 3 levels, tol 1e-4 (the headline): the same
    iterations on every level and the same rho, bit for bit, with
    ``phi_rhs_plain`` forced in the kernel's place; the kernel launched
    once an iteration, the plain run launching none."""
    from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    runs = []
    try:
        for forced in (False, True):
            if forced:
                monkeypatch.setattr(core, "phi_rhs", fs.phi_rhs_plain)
            clear_solver_cache()
            fs.reset_launches()
            out, _, _ = solve_dot(r0, r1, 33, 3, {"tol": 1e-4}, "inPALM",
                                  device=dev, verbose=False)
            torch.cuda.synchronize()
            runs.append((out, dict(fs.LAUNCHES)))
    finally:
        clear_solver_cache()
    (kern, kern_n), (plain, plain_n) = runs
    iters = [lv["iters"] for lv in kern["levels"]]
    assert iters == [lv["iters"] for lv in plain["levels"]]
    assert torch.equal(kern["rho"], plain["rho"])
    assert kern_n["phi_rhs"] == kern_n["qx_step"] == sum(iters)
    assert plain_n["phi_rhs"] == 0 and plain_n["qx_step"] == sum(iters)


def test_sharded_step_on_a_batch_mesh_runs_the_kernels(dev):
    """``make_sharded_step`` over a one-rank ("batch",) mesh: two float32
    instances stacked, each instance's 2 steps bit-equal to its own
    ``run_one`` steps (its scalars in memory, as the device driver's), and
    the rhs, z-, q- and beta-step kernels launched once a step for each
    instance."""
    from dotsocp_tpu_torch.parallel.batch import stack_states
    from dotsocp_tpu_torch.parallel.sharding import (make_mesh,
                                                     make_sharded_step)

    lvs = []
    for name in ("example2", "example3"):
        lv = initialize(*get_example_2d(name, 17, 17), 7, dtype=F32,
                        device=dev)
        initial_scaling(lv, scaling=True)
        lvs.append(lv)
    kern = Kernels(LevelConfig(geom=lvs[0].geom, D=lvs[0].D, E=lvs[0].E,
                               device=dev, dtype=F32))
    state = stack_states([kern.prep(lv.as_dict(), 1.0) for lv in lvs])
    step = make_sharded_step(kern, make_mesh(axis_names=("batch",),
                                             device=dev))
    fs.reset_launches()
    got = step(step(state))
    for k in ("phi_rhs", "z_step", "q_step", "beta_step"):
        assert fs.LAUNCHES[k] == 4, (k, dict(fs.LAUNCHES))
    ev = kern.e_scalars(state.D, state.E)
    for b in range(2):
        want = core.instance(state, b).replace(ev=ev, E=ev.E)
        want = kern.run_one(kern.run_one(want))
        mine = core.instance(got, b)
        for a, w in zip([mine.phi, mine.z, mine.beta, *mine.q.blocks()],
                        [want.phi, want.z, want.beta, *want.q.blocks()]):
            assert torch.equal(a, w)
