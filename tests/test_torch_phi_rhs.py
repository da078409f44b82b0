"""The phi-step's right-hand side D A^T (w q - alpha) + c
(``ops/fused_step.phi_rhs``) on the CPU.

On the CPU, and in float64 anywhere, ``phi_rhs`` runs its plain version;
on the shaped engine it keeps that engine's ``grad_T``. Here it is held,
bit for bit, to the expression each caller wrote out before the kernel:
on seeded fields in 1D, 2D and 3D, weighted or not, with and without a
leading instance axis, and inside every caller's step (inPALM, sGS-inPALM,
PALM, acc-ADMM, weighted inPALM and acc-ADMM, the lockstep fleet's
stacked state). The kernel itself runs only on a card:
``tests/test_torch_cuda.py`` holds it to ``phi_rhs_plain`` there.
"""
import numpy as np
import pytest
import torch

from dotsocp_tpu_torch.algorithms import core, variants
from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
from dotsocp_tpu_torch.algorithms.variants import (AccADMMKernels,
                                                   PALMKernels, SgsKernels)
from dotsocp_tpu_torch.models import wdot2d
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import Ops3D, OpsFlat
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.parallel.batch import stack_states

torch.set_num_threads(2)

F32 = torch.float32
# a different size on each axis, so a swapped stride or spacing shows
GEOMS = {"1d": (9, (33,)), "2d": (7, (9, 17)), "3d": (5, (5, 7, 9))}


def _fields(name, dtype=F32, lead=(), seed=0):
    """(ops, q, alpha, c, D, w) of seeded fields; face blocks with their
    ghost slots zero, as the solver keeps them, the weight's ghost slots
    1.0."""
    nt, space = GEOMS[name]
    geom = Geometry(nt, space)
    ops = OpsFlat(geom, dtype, "cpu")
    rng = np.random.default_rng(seed)
    S, d = ops.S, geom.ndim_space

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(lead + shape)).to(dtype)

    def stag():
        return Staggered(rand(nt - 1, S), rand(d, nt, S) * ops.masks)

    w = Staggered(
        torch.from_numpy(rng.uniform(0.5, 2.0, (nt - 1, S))).to(dtype),
        torch.from_numpy(rng.uniform(0.5, 2.0, (d, nt, S))).to(dtype)
        * ops.masks + (1.0 - ops.masks))
    D = float(np.sqrt(2.0 * geom.h_mean))
    return ops, stag(), stag(), rand(nt, S), D, w


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stack3"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_phi_rhs_on_cpu_is_the_written_out_expression(name, weighted, lead):
    ops, q, alpha, c, D, w = _fields(name, lead=lead)
    w = w if weighted else None
    before = dict(fs.LAUNCHES)
    got = fs.phi_rhs(ops, q, alpha, c, D, w)
    wq = q if w is None else w * q
    assert torch.equal(got, D * ops.grad_T(wq - alpha) + c)
    assert got.shape == c.shape
    assert fs.LAUNCHES == before  # CPU tensors take the plain version


@pytest.mark.parametrize("name", list(GEOMS))
def test_float64_takes_the_plain_route(name):
    ops, q, alpha, c, D, w = _fields(name, dtype=torch.float64)
    before = dict(fs.LAUNCHES)
    for weight in (None, w):
        got = fs.phi_rhs(ops, q, alpha, c, D, weight)
        assert got.dtype == torch.float64
        assert torch.equal(got, fs.phi_rhs_plain(ops, q, alpha, c, D, weight))
    assert fs.LAUNCHES == before


def test_shaped_engine_keeps_its_grad_T():
    """On the shaped engine (face blocks a tuple) the route is the plain
    version on that engine's operators, and it agrees with the flat
    engine's result."""
    nt, space = GEOMS["2d"]
    geom = Geometry(nt, space)
    flat, q, alpha, c, D, _ = _fields("2d")
    shaped = Ops3D(geom, F32, "cpu")
    sq, sa = flat.stag_from_internal(q), flat.stag_from_internal(alpha)
    sc = flat.phi_from_internal(c)
    got = fs.phi_rhs(shaped, sq, sa, sc, D)
    assert torch.equal(got, D * shaped.grad_T(sq - sa) + sc)
    torch.testing.assert_close(flat.phi_to_internal(got),
                               fs.phi_rhs(flat, q, alpha, c, D),
                               rtol=1e-6, atol=1e-6)


# -- every caller ---------------------------------------------------------------

def _level(weighted):
    if not weighted:
        r0, r1 = get_example_2d("example2", 17, 17)
        lv = initialize(r0, r1, 7, dtype=F32, device="cpu")
    else:
        barrier = wdot2d.barrier_love_heart()
        r0, r1 = wdot2d.get_example_w2d("love-heart", 17, 17)
        r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
        weight = wdot2d.get_weight_by_barrier(17, 17, 7, barrier, dtype=F32)
        lv = initialize(r0, r1, 7, dtype=F32, device="cpu", weight=weight)
    initial_scaling(lv, scaling=True)
    return lv


def _kernels(cls, lv, **kw):
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu", dtype=F32,
                      **kw)
    return cls(cfg) if cls is SgsKernels else cls(cfg, lv.weight)


def _state(kern, lv, its=3):
    """The state after ``its`` iterations, so q and alpha are not zero."""
    s = kern.prep(lv.as_dict(), 1.0)
    s = kern.run_segment(s, its)
    return getattr(s, "s", s)


@pytest.fixture
def spy(monkeypatch):
    """The right-hand sides the callers form through ``phi_rhs``."""
    seen = []

    def recording(*args, **kw):
        seen.append(fs.phi_rhs(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(core, "phi_rhs", recording)
    monkeypatch.setattr(variants, "phi_rhs", recording)
    return seen


@pytest.mark.parametrize("cls,weighted", [(Kernels, False),
                                          (SgsKernels, False),
                                          (Kernels, True)],
                         ids=["inPALM", "sGS-inPALM", "weighted-inPALM"])
def test_inpalm_family_rhs_is_the_written_out_expression(spy, cls, weighted):
    lv = _level(weighted)
    kern = _kernels(cls, lv)
    s = _state(kern, lv)
    ops = kern.ops
    want = s.D * ops.grad_T(kern._w(s.q) - s.alpha) + s.c
    assert torch.equal(kern._rhs(s), want)
    assert torch.equal(kern._rhs(s, plain=True), want)
    spy.clear()
    kern._step(s)
    assert len(spy) == 1 and torch.equal(spy[0], want)


def test_palm_rhs_is_the_written_out_expression(spy):
    lv = _level(False)
    kern = _kernels(PALMKernels, lv)
    s = _state(kern, lv)
    ops = kern.ops
    spy.clear()
    kern._step(s)
    # the step's first q-step, as PALM's step forms it
    q = kern._q_solve(s, s.D * ops.grad(s.phi), kern._bfd_T(s, s.z + s.beta))
    assert len(spy) == 1
    assert torch.equal(spy[0], s.D * ops.grad_T(q - s.alpha) + s.c)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["acc-ADMM", "weighted-acc-ADMM"])
def test_acc_rhs_is_the_written_out_expression(spy, weighted):
    lv = _level(weighted)
    kern = _kernels(AccADMMKernels, lv, tau=1.0)
    s = _state(kern, lv)
    ops = kern.ops
    spy.clear()
    _, rhs, _ = kern._step_parts(s)
    # q and the unit-step alpha of the step, as acc-ADMM's step forms them
    tmp_q = s.D * ops.grad(s.phi)
    q = kern._q_solve(s, tmp_q, kern._bfd_T(s, s.z + s.beta))
    alpha = s.alpha + tmp_q - kern._w(q)
    assert len(spy) == 1 and spy[0] is rhs
    assert torch.equal(rhs, s.D * ops.grad_T(kern._w(q) - alpha) + s.c)


def test_fleet_rhs_is_the_written_out_expression(spy):
    """The lockstep fleet's stacked state (two instances of one level):
    one rhs over the stack, each instance's slice its own rhs."""
    lv = _level(False)
    kern = _kernels(Kernels, lv)
    states = [_state(kern, lv, its) for its in (2, 5)]
    stacked = stack_states(states)
    ops = kern.ops
    got = kern._rhs(stacked)
    assert got.shape == stacked.c.shape
    assert torch.equal(got, stacked.D * ops.grad_T(stacked.q - stacked.alpha)
                       + stacked.c)
    for b, st in enumerate(states):
        assert torch.equal(got[b], st.D * ops.grad_T(st.q - st.alpha) + st.c)
    spy.clear()
    kern.segment_batched(stacked, 2, torch.ones(2, dtype=torch.bool))
    assert len(spy) == 2
