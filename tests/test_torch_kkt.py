"""The KKT battery's sums (``Kernels._kkt_parts``): one pass of
``fused_step.kkt_sums`` (``kkt_kernel`` in ``csrc/fused_step.cu``) on the
flat engine's float32 CUDA state, the plain PyTorch sums
(``Kernels._kkt_parts_plain``) everywhere else.

The file imports no JAX, so it runs on a machine that has only PyTorch; the
tests marked ``cuda`` need a card and skip without one:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kkt.py -q

On the CPU: the route (the plain sums on the CPU, in float64 and on the
"3d" and halo engines, under the same keys in the same order), the
wrapper's refusals, and the drivers' ``kkt_kernel_checks`` beside
``checks``. On the card: the kernel's 17 + 3 d sums against the plain ones
on states a few steps into a level (2D at 33^2 x 9 and 65^2 x 17, 1D at 65
x 17, 3D at 17^3 x 9; unweighted and weighted: the love-heart weight in 2D,
a seeded weight in 1D and 3D; the host's float scalars and the device
driver's tensors), each sum of squares within 1e-5 of the plain sum and
each inner product within 1e-5 of the sum of its terms' magnitudes (every
element is rounded as the plain version rounds it; the kernel adds in
float64, PyTorch in float32); the sums bit-equal run to run and between an
eager launch and a graph replay; a fleet's ``kkt_batched`` over 4 instances
equal to 4 single calls; and device-driver solves counting every check in
``kkt_kernel_checks``.
"""
import types

import pytest
import torch

from dotsocp_tpu_torch.algorithms import core
from dotsocp_tpu_torch.algorithms.core import (BATCH_SCALARS, Kernels,
                                               LevelConfig, instance,
                                               stack_fields)
from dotsocp_tpu_torch.algorithms.graphs import SegmentGraphs
from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.models.examples import (get_example_1d,
                                               get_example_2d,
                                               get_example_3d)
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache, solve_dot
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import OpsFlat
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import zeros
from dotsocp_tpu_torch.parallel.batch import solve_fleet

F32, F64 = torch.float32, torch.float64
# (nt, space) of the card's comparisons
CARD = {"2d-33": (9, (33, 33)), "2d-65": (17, (65, 65)), "1d": (17, (65,)),
        "3d": (9, (17, 17, 17))}
# and of the CPU's
CPU = {"1d": (5, (17,)), "2d": (5, (9, 9)), "3d": (3, (5, 5, 5))}
FIELDS = ("phi", "q", "z", "alpha", "beta", "c")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _weight(geom, weighted, device):
    """None, the love-heart weight (2D) or a seeded weight in [1, 3)."""
    if not weighted:
        return None
    if geom.ndim_space == 2:
        n0, n1 = geom.space
        return wdot2d.get_weight_by_barrier(
            n1, n0, geom.nt, wdot2d.barrier_love_heart(), dtype=F32,
            device=device)
    gen = torch.Generator().manual_seed(7)
    return zeros(geom).map(
        lambda b: (1.0 + 2.0 * torch.rand(b.shape, generator=gen)).to(
            device))


def _level(nt, space, device, dtype=F32, weighted=False, steps=5):
    """Kernels and a state ``steps`` iterations into a level."""
    if len(space) == 1:
        r0, r1 = get_example_1d("gaussian", space[0])
    elif len(space) == 2:
        r0, r1 = get_example_2d("example2", *space)
    else:
        r0, r1 = get_example_3d("gaussian", *space)
    lv = initialize(r0, r1, nt, dtype=dtype, device=device)
    initial_scaling(lv, scaling=True)
    kern = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device=device,
                               dtype=dtype),
                   weight=_weight(lv.geom, weighted, device))
    s = kern.prep(lv.as_dict(), 1.0)
    for _ in range(steps):
        s = kern.run_one(s)
    return kern, s.replace(sigma=1.7, cScale=0.9, dScale=1.3)


def _device_scalars(kern, s):
    """``s`` with the device driver's scalars: sigma, cScale, dScale 0-d
    tensors, E and the values derived from it in ``ev``."""
    ev = kern.e_scalars(s.D, s.E)
    t = {f: torch.full((), getattr(s, f), dtype=s.phi.dtype,
                       device=s.phi.device)
         for f in ("sigma", "cScale", "dScale")}
    return s.replace(ev=ev, E=ev.E, **t)


# -- the CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CPU))
def test_plain_sums_on_the_cpu(name, dtype):
    """On the CPU, in float32 and float64, the battery runs the plain sums:
    the same dict as ``_kkt_parts_plain``, keys in ``kkt_keys`` order, and
    no kernel launched."""
    kern, s = _level(*CPU[name], "cpu", dtype, steps=2)
    assert not kern.kkt_on_kernel(s)
    before = dict(fs.LAUNCHES)
    got = kern._kkt_parts(s)
    want = kern._kkt_parts_plain(s)
    assert fs.LAUNCHES == before
    assert list(got) == list(want) == list(fs.kkt_keys(len(CPU[name][1])))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_route_by_engine():
    """The "3d" and halo engines take the plain sums without looking at the
    tensors; the flat engine looks, and refuses a device with no kernel."""
    meta = torch.zeros(3, device="meta")
    for layout in ("3d", "halo"):
        assert not fs.kkt_sums_on_kernel(types.SimpleNamespace(
            layout=layout), meta)
    ops = OpsFlat(Geometry(nt=3, space=(5,)), F32, "cpu")
    assert not fs.kkt_sums_on_kernel(ops, torch.zeros(3))
    with pytest.raises(ValueError, match="no kernel"):
        fs.kkt_sums_on_kernel(ops, meta)


@pytest.mark.parametrize("bad", ["D", "E", "sigma", "ev"])
def test_kkt_sums_refuses_bad_scalars(bad):
    """A tensor D (graphs take it by value), a tensor E without its ev
    vector, a float64 sigma, or an ev vector beside a float dScale: refused
    before any launch."""
    kern, s = _level(*CPU["2d"], "cpu", steps=0)
    args = dict(D=s.D, sigma=s.sigma, cScale=s.cScale, dScale=s.dScale,
                E=s.E, ev=None)
    if bad == "D":
        args["D"] = torch.tensor(s.D)
    elif bad == "E":
        args["E"] = torch.tensor(s.E)
    elif bad == "sigma":
        args["sigma"] = torch.tensor(s.sigma, dtype=F64)
    else:
        args["ev"] = kern.e_scalars(s.D, s.E).vec
    with pytest.raises(ValueError, match="kkt_sums"):
        fs.kkt_sums(kern.ops, *(getattr(s, f) for f in FIELDS), None,
                    **args)


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("mode", ["solve_dot", "lockstep"])
def test_drivers_count_kkt_kernel_checks(monkeypatch, mode, route):
    """Each level's ``driver`` dict counts in ``kkt_kernel_checks`` the
    checks whose battery the kernel takes: none on the CPU, every one where
    the route says the kernel (the route forced here, the plain sums
    standing in for the kernel's); ``checks`` is one a record read."""
    if route == "kernel":
        monkeypatch.setattr(Kernels, "kkt_on_kernel", lambda self, s: True)
        monkeypatch.setattr(Kernels, "_kkt_parts",
                            Kernels._kkt_parts_plain)
    r0, r1 = get_example_2d("example2", 9, 9)
    clear_solver_cache()
    try:
        if mode == "solve_dot":
            out, _, _ = solve_dot(r0, r1, 5, 2, {"tol": 1e-3}, "inPALM",
                                  device="cpu", verbose=False)
            stats = [lv["driver"] for lv in out["levels"]]
        else:
            out = solve_fleet([r0, r1], [r1, r0], 5, {"tol": 1e-3},
                              "inPALM", dtype=F32, level_n=2,
                              mode="lockstep", verbose=False,
                              device="cpu")
            stats = [rep["driver"] for rep in out["levels"]]
    finally:
        clear_solver_cache()
    assert stats
    for st in stats:
        assert st["checks"] == st["syncs"] > 0
        assert st["kkt_kernel_checks"] == (st["checks"] if route == "kernel"
                                           else 0)


# -- the card --------------------------------------------------------------------

def _scale(kern, s, want) -> dict:
    """The magnitude each sum is held to: the sum itself for the sums of
    squares, the sum of the terms' magnitudes for <q, alpha>, <c, phi>."""
    out = dict(want)
    out["pri"] = s.q.map(torch.abs).dot(s.alpha.map(torch.abs))
    out["dual"] = torch.sum(s.c.abs() * s.phi.abs())
    return out


def _assert_sums_close(kern, s, got, want):
    assert list(got) == list(want)
    scale = _scale(kern, s, want)
    for k in want:
        g, w, m = float(got[k]), float(want[k]), float(scale[k])
        assert got[k].dtype == F32 and got[k].ndim == 0
        assert abs(g - w) <= 1e-5 * abs(m), (k, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("scalars", ["host", "device"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", list(CARD))
def test_kernel_sums_match_plain(dev, name, weighted, scalars):
    kern, s = _level(*CARD[name], dev, weighted=weighted)
    if scalars == "device":
        s = _device_scalars(kern, s)
    assert kern.kkt_on_kernel(s)
    before = dict(fs.LAUNCHES)
    got = kern._kkt_parts(s)
    torch.cuda.synchronize()
    key = "kkt_sums_w" if weighted else "kkt_sums"
    assert all(fs.LAUNCHES[k] == before[k] + (k == key) for k in fs.LAUNCHES)
    _assert_sums_close(kern, s, got, kern._kkt_parts_plain(s))


@pytest.mark.cuda
def test_kernel_sums_repeat_and_replay_bit_equal(dev):
    """Two eager runs and a graph's replays give the same bits (the device
    driver's scalars, as its check graph reads them)."""
    kern, s = _level(*CARD["2d-65"], dev, weighted=False)
    s = _device_scalars(kern, s)
    buf = torch.zeros(len(fs.kkt_keys(2)), dtype=F32, device=dev)

    def battery():
        buf.copy_(torch.stack(list(kern._kkt_parts(s).values())))

    graphs = SegmentGraphs(dev)
    runs = []
    with graphs.context():
        for _ in range(4):   # eager, capture and replay, replay, replay
            graphs.run("kkt", battery)
            torch.cuda.synchronize()
            runs.append(buf.clone())
    assert graphs.replays == 3
    eager = torch.stack(list(kern._kkt_parts(s).values()))
    for r in runs + [eager]:
        assert torch.equal(r, runs[0])
    graphs.release()


@pytest.mark.cuda
def test_kkt_batched_matches_single_calls(dev):
    """``kkt_batched`` over a stack of 4 instances (each its own state and
    scalars) gives each instance's ``_kkt`` bit for bit."""
    states = []
    for i in range(4):
        kern, s = _level(*CARD["2d-33"], dev, steps=2 + i)
        states.append(s.replace(sigma=1.0 + 0.25 * i))
    tens = {f: torch.tensor([getattr(st, f) for st in states], dtype=F32,
                            device=dev) for f in BATCH_SCALARS}
    bs = states[0].replace(**stack_fields(states, FIELDS), **tens)
    got = kern.kkt_batched(bs)
    for b, res in enumerate(got):
        want = kern._kkt(instance(bs, b))
        for k in want:
            assert torch.equal(res[k], want[k]), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["inPALM", "sGS-inPALM", "acc-ADMM"])
def test_solve_counts_every_check_on_the_kernel(dev, method):
    """A device-driver solve on the card: every check's battery on the
    kernel (``kkt_kernel_checks`` = ``checks``), one launch a check."""
    r0, r1 = get_example_2d("example2", 33, 33)
    clear_solver_cache()
    fs.reset_launches()
    try:
        out, _, _ = solve_dot(r0, r1, 9, 2, {"tol": 1e-3}, method,
                              device=dev, verbose=False)
    finally:
        clear_solver_cache()
    drv = [lv["driver"] for lv in out["levels"]]
    assert all(d["kkt_kernel_checks"] == d["checks"] > 0 for d in drv)
    # the prewarm runs each level's check once more
    assert fs.LAUNCHES["kkt_sums"] >= sum(d["checks"] for d in drv)
    assert out["mass_ok"]
