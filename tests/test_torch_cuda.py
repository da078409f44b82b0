"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``: rtol 2e-5 / atol 2e-6 for a kernel
against its plain version (FMA contraction and the association of the
four-term face sum differ, a few ulp), and 2e-6 / 2e-6 for a 4-iteration
CA segment against 4 plain steps at 17^2 x 7 (``tests/test_pallas.py``).
"""
import math

import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.models.examples import get_example_1d, get_example_2d
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.multilevel.solve import solve_dot
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops import sgs_sweep
from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.sgs import make_sgs
from dotsocp_tpu_torch.ops.staggered import Staggered

pytestmark = pytest.mark.cuda

F32 = torch.float32
SHAPES = {"2d": (9, (33, 33)), "1d": (9, (129,))}


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
    assert all(fs.LAUNCHES[k] == before[k] + 1 for k in fs.LAUNCHES)


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
        plain = kern._step(plain)
    seg = kern.run_segment(s.clone(), k)
    for name in ("phi", "z", "beta"):
        close(getattr(seg, name), getattr(plain, name), 2e-6, 2e-6)
    for name in ("q", "alpha"):
        for got, want in zip(getattr(seg, name).blocks(),
                             getattr(plain, name).blocks()):
            close(got, want, 2e-6, 2e-6)


@pytest.mark.parametrize("dim", [1, 2])
def test_solve_on_card_matches_cpu(dev, dim):
    """The same small f32 solve on the card and on the CPU: equal iteration
    counts on every level, densities within f32 rounding."""
    if dim == 1:
        r0, r1 = get_example_1d("gaussian", 65)
    else:
        r0, r1 = get_example_2d("example2", 33, 33)
    runs = {}
    for device in ("cpu", dev):
        fs.reset_launches()
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-3}, "inPALM",
                              device=device, verbose=False)
        runs[str(device)] = out, dict(fs.LAUNCHES)
    (cpu, cpu_n), (gpu, gpu_n) = runs["cpu"], runs[str(dev)]
    assert ([lv["iters"] for lv in gpu["levels"]]
            == [lv["iters"] for lv in cpu["levels"]])
    assert set(cpu_n.values()) == {0} and min(gpu_n.values()) > 0
    close(gpu["rho"].cpu(), cpu["rho"], 1e-3, 1e-4)
    assert gpu["mass_ok"] and cpu["mass_ok"]


# -- the sGS sweep kernel ----------------------------------------------------------

@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("its", [1, 2])
def test_sweep_kernel_matches_plain(dev, name, its):
    """Within the kernel tolerance; the input phi is left as it was and
    each sweep is three launches."""
    nt, space = SHAPES[name]
    geom = Geometry(nt, space)
    rng = np.random.default_rng(5)
    phi, rhs = (torch.from_numpy(rng.standard_normal(
        geom.phi_shape, dtype=np.float32)).to(dev) for _ in range(2))
    sgs = make_sgs(geom, dtype=F32, device=dev)
    before = phi.clone()
    n0 = sgs_sweep.LAUNCHES["rb_sweep"]
    got = sgs_sweep.rb_sweep(sgs, phi, rhs, 0.3, its)
    torch.cuda.synchronize()
    assert sgs_sweep.LAUNCHES["rb_sweep"] == n0 + 3 * its
    close(got, sgs.sweep(phi, rhs, its, d2=0.3))
    assert torch.equal(phi, before)


def test_sweep_wrapper_refuses_what_the_kernel_does_not_take(dev):
    geom = Geometry(*SHAPES["2d"])
    sgs = make_sgs(geom, dtype=F32, device=dev)
    phi = torch.zeros(geom.phi_shape, dtype=F32, device=dev)
    with pytest.raises(ValueError, match="share storage"):
        sgs_sweep.rb_sweep(sgs, phi, phi, 0.3)
    with pytest.raises(ValueError, match="shape"):
        sgs_sweep.rb_sweep(sgs, phi[:-1], phi[1:].clone(), 0.3)
    with pytest.raises(TypeError, match="float32"):
        sgs_sweep.rb_sweep(sgs, phi.double(), phi.double() + 1, 0.3)


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_solve_on_card_matches_cpu(dev, method):
    """The same small f32 sGS solve on the card and on the CPU: equal
    iteration counts on every level; the card's sGS level swept with the
    kernel, three launches per iteration."""
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
    assert cpu_n == 0 and gpu_n == 3 * iters[-1]
    close(gpu["rho"].cpu(), cpu["rho"], 1e-3, 1e-4)
