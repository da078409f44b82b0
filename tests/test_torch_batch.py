"""The port's fleet solver (``dotsocp_tpu_torch/parallel/batch.py``) against
the JAX package's (``dotsocp_tpu/parallel/batch.py``), on the CPU in
float64, where the port runs the plain versions of the batched kernels and
every piece of its lockstep loop eagerly.

- ``solve_batch`` at 17^2 x 5, B = 2 (example2, example1): inPALM on one
  and two levels, PALM and ALG2 on one. ``done``, ``done_it`` and
  ``iters`` are the JAX function's exactly. ``kkt`` (the last kkt_org
  rows, float32 in both packages) agrees within rtol 1e-7, one float32
  rounding, and atol 1e-12 for residual 5, which sits at the rounding
  floor (~1e-16) here; ``rho`` within 1e-8 of its largest entry.
- Both loops started from one stacked state (``utils/interop``): the same
  counts and the same final state within 1e-8.
- The batched plain versions against the per-instance plain versions,
  bit-equal, and an inactive instance's fields (phi included) bit-equal
  through segments; the fleet decision at the port's own constant;
  sequential and lockstep fleets within 1e-2 on ``rho``
  (``tests/test_batch.py:35``); what raises, with its reason.
- ``@pytest.mark.cuda`` cases need the card and skip here. They import no
  JAX, so on a machine with the card and no JAX:
  ``python -m pytest --noconftest -o addopts="" tests/test_torch_batch.py
  -m cuda -q``.

Run as a script, ``python tests/test_torch_batch.py --fleet-anchor`` runs
the JAX ``solve_batch`` on the CPU over the ``scripts/fleet_bench.py``
fleet (eight problems at 129^2 x 33, 3 levels, tol 1e-4, inPALM, float32,
x64 off as that script runs) and prints its per-instance ``done_it`` and
total ``iters``: ``chip_smoke.py``'s ``FLEET_ANCHOR``; with ``--f64`` the
same in float64 (x64 on): ``FLEET_ANCHOR_F64``; with ``--rel`` also each
instance's rho gap between that solve_batch and the JAX ``solve_dot``
(device driver) of the instance alone: ``FLEET_REL_JAX``.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script from anywhere
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig, instance
from dotsocp_tpu_torch.algorithms.driver import SolveOptions
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
from dotsocp_tpu_torch.ops import fused_step as fs
from dotsocp_tpu_torch.ops.engine import OpsFlat, diag_values
from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered
from dotsocp_tpu_torch.parallel import batch as tb
from dotsocp_tpu_torch.utils.interop import (batch_state_from_numpy,
                                             batch_state_to_numpy)

F64 = torch.float64
OPTS = {"tol": 1e-4, "maxit": 3000}


def fleet_problems(get_example_2d, gaussian2d, normalize, n):
    """The eight problems of ``scripts/fleet_bench.py:make_fleet`` (its
    heterogeneous fleet), from either package's generators."""
    probs = ["example1", "example2", "example3", "example4", "circle",
             "DOTmark_4stitch"]
    pairs = [get_example_2d(p, n, n) for p in probs]

    def gpair(a, b, s):
        return (normalize(gaussian2d(n, n, a[0], a[1], s)),
                normalize(gaussian2d(n, n, b[0], b[1], s)))

    pairs.append(gpair((0.3, 0.3), (0.7, 0.7), 0.08))
    pairs.append(gpair((0.2, 0.5), (0.8, 0.5), 0.12))
    r0 = np.stack([np.asarray(a) for a, _ in pairs])
    r1 = np.stack([np.asarray(b) for _, b in pairs])
    return r0, r1


def jax_fleet_anchor(n=129, nt=33, levels=3, tol=1e-4, f64=False):
    """The JAX ``solve_batch`` on the fleet_bench fleet, float32 (or
    float64, with x64 on)."""
    import jax
    import jax.numpy as jnp

    if f64:
        jax.config.update("jax_enable_x64", True)
    from dotsocp_tpu.models import examples as je
    from dotsocp_tpu.parallel.batch import solve_batch

    r0, r1 = fleet_problems(je.get_example_2d, je._gaussian2d, je._normalize,
                            n)
    return solve_batch(r0, r1, nt, {"tol": tol, "maxit": 3000}, "inPALM",
                       dtype=jnp.float64 if f64 else jnp.float32,
                       level_n=levels, verbose=True)


def _pair():
    a, b = get_example_2d("example2", 17, 17)
    c, d = get_example_2d("example1", 17, 17)
    return np.stack([a, c]), np.stack([b, d])


@pytest.fixture(scope="module")
def cpu_threads():
    torch.set_num_threads(2)


def _assert_same(jout, tout):
    np.testing.assert_array_equal(tout["done"], np.asarray(jout["done"]))
    np.testing.assert_array_equal(tout["done_it"], np.asarray(jout["done_it"]))
    assert tout["iters"] == int(jout["iters"])
    np.testing.assert_allclose(tout["kkt"], np.asarray(jout["kkt"]),
                               rtol=1e-7, atol=1e-12)
    jr = np.asarray(jout["rho"])
    tr = tout["rho"].cpu().numpy()
    assert tr.shape == jr.shape
    assert np.abs(tr - jr).max() <= 1e-8 * np.abs(jr).max()


@pytest.mark.parametrize("method,levels", [("inPALM", 1), ("inPALM", 2),
                                           ("PALM", 1), ("ALG2", 1)])
def test_solve_batch_matches_jax(cpu_threads, method, levels):
    import jax.numpy as jnp

    from dotsocp_tpu.parallel.batch import solve_batch as jsolve_batch

    r0, r1 = _pair()
    jout = jsolve_batch(r0, r1, 5, OPTS, method, dtype=jnp.float64,
                        level_n=levels, verbose=False)
    tout = tb.solve_batch(r0, r1, 5, OPTS, method, dtype=F64,
                          level_n=levels, verbose=False, device="cpu")
    _assert_same(jout, tout)
    assert tout["done"].all()
    # one record read a check, no other host read in the loop
    for rep in tout["levels"]:
        assert rep["driver"]["syncs"] == rep["driver"]["checks"]


def _levels(r0, r1, nt, dtype=F64):
    lvs = []
    for a, b in zip(r0, r1):
        lv = initialize(torch.as_tensor(a), torch.as_tensor(b), nt, dtype,
                        "cpu")
        initial_scaling(lv, True)
        lvs.append(lv)
    return lvs


def test_both_loops_from_one_stacked_state(cpu_threads):
    """The JAX ``BatchedDeviceDriver`` and the port's, started from the
    same stacked state (the JAX per-instance states as numpy, stacked by
    ``batch_state_from_numpy``), end with the same counters and, back
    through ``batch_state_to_numpy``, the same state."""
    import jax
    import jax.numpy as jnp

    from dotsocp_tpu.algorithms.driver import SolveOptions as JSolveOptions
    from dotsocp_tpu.algorithms.variants import InPALMKernels
    from dotsocp_tpu.algorithms.core import LevelConfig as JLevelConfig
    from dotsocp_tpu.multilevel import level as jlevel
    from dotsocp_tpu.parallel.batch import BatchedDeviceDriver as JDriver

    r0, r1 = _pair()
    nt = 5
    jlvs = []
    for a, b in zip(r0, r1):
        lv = jlevel.initialize(a, b, nt, dtype=jnp.float64)
        jlevel.initial_scaling(lv, True)
        jlvs.append(lv)
    jk = InPALMKernels(JLevelConfig(geom=jlvs[0].geom, D=jlvs[0].D,
                                    E=jlvs[0].E, tau=1.9,
                                    dtype=jnp.float64, layout="flat"))
    jstates = [jk.prep(lv.as_dict(), s) for lv, s in zip(jlvs, (1.0, 0.5))]
    fields = [jax.device_get(s)._asdict() for s in jstates]
    bstate = jax.tree.map(lambda *xs: jnp.stack(xs), *jstates)
    jo = JSolveOptions(tol=1e-4, maxit=3000, sigma=1.0, tau=1.9)
    jls, _ = JDriver(jk, jo).solve(bstate)

    tlvs = _levels(r0, r1, nt)
    tk = Kernels(LevelConfig(geom=tlvs[0].geom, D=tlvs[0].D, E=tlvs[0].E,
                             device="cpu", tau=1.9, dtype=F64))
    tstate = batch_state_from_numpy(fields, device="cpu", dtype=F64)
    back = batch_state_to_numpy(tstate)
    for f, g in zip(fields, back):
        np.testing.assert_array_equal(g["phi"], np.asarray(f["phi"]))
        assert g["sigma"] == float(f["sigma"])
    drv = tb.BatchedDeviceDriver(tk, SolveOptions(tol=1e-4, maxit=3000,
                                                  sigma=1.0, tau=1.9))
    tls, _ = drv.solve(tstate)
    assert int(tls.it) == int(jls.it)
    np.testing.assert_array_equal(tls.done.numpy(), np.asarray(jls.done))
    np.testing.assert_array_equal(tls.done_it.numpy(),
                                  np.asarray(jls.done_it))
    np.testing.assert_array_equal(tls.stage.numpy(), np.asarray(jls.stage))
    got = batch_state_to_numpy(drv.s)
    want = [jax.device_get(jax.tree.map(lambda x: x[b], jls.s))._asdict()
            for b in range(2)]
    for g, w in zip(got, want):
        for key in ("phi", "z", "beta", "c"):
            scale = np.abs(np.asarray(w[key])).max()
            assert np.abs(g[key] - np.asarray(w[key])).max() <= 1e-8 * scale
        for key in ("sigma", "dScale", "cScale", "sigmaScale"):
            assert math.isclose(g[key], float(w[key]), rel_tol=1e-10)


def _random_batch(B, nt, space, dtype, seed=0):
    geom = Geometry(nt, space)
    ops = OpsFlat(geom, dtype, "cpu")
    rng = np.random.default_rng(seed)
    d, S, C = geom.ndim_space, ops.S, geom.cone_cols

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    def stag():
        return Staggered(r(B, nt - 1, S), r(B, d, nt, S) * ops.masks)

    D = math.sqrt(2.0) * math.sqrt(geom.h_mean)
    E = D / math.sqrt(2.0)
    return ops, dict(q=stag(), alpha=stag(), q_out=stag(), phi=r(B, nt, S),
                     beta=r(B, C, nt - 1, S), x=r(B, C, nt - 1, S),
                     sd=torch.tensor(rng.uniform(0.5, 2.0, B), dtype=dtype),
                     D=D, sbf=E / D, tau=1.9,
                     dinv=tuple(1.0 / v for v in diag_values(D, E)),
                     active=torch.tensor([b != 1 for b in range(B)]))


def _at(st, b):
    return Staggered(st.q0[b], st.bs[b])


@pytest.mark.parametrize("space", [(9, 9), (17,), (5, 6, 7)])
def test_batched_plain_is_per_instance_plain(space):
    """Each batched wrapper on the CPU is its plain version, and that is
    the per-instance plain version where ``active``, the old value
    elsewhere: bit-equal."""
    B = 3
    ops, v = _random_batch(B, 5, space, torch.float32)
    x0 = v["x"].clone()
    got = fs.x_step_batched(ops, v["q"], v["beta"], v["sbf"], v["sd"],
                            v["active"], v["x"])
    for b in range(B):
        want = (fs.x_step_plain(ops, _at(v["q"], b), v["beta"][b], v["sbf"],
                                v["sd"][b]) if v["active"][b] else x0[b])
        assert torch.equal(got[b], want)
    q, a = fs.qx_step_batched(ops, v["phi"], v["x"], v["alpha"], v["q_out"],
                              v["dinv"], v["D"], v["sbf"], v["tau"],
                              v["active"])
    for b in range(B):
        if v["active"][b]:
            wq, wa = fs.qx_step_plain(ops, v["phi"][b], v["x"][b],
                                      _at(v["alpha"], b), v["dinv"], v["D"],
                                      v["sbf"], v["tau"])
        else:
            wq, wa = _at(v["q_out"], b), _at(v["alpha"], b)
        for got_st, want_st in ((_at(q, b), wq), (_at(a, b), wa)):
            assert torch.equal(got_st.q0, want_st.q0)
            assert torch.equal(got_st.bs, want_st.bs)
    for final, fn in ((False, fs.cx_step_batched),
                      (True, fs.cx_final_batched)):
        beta, x = fn(ops, v["beta"], v["x"], v["q"], v["sbf"], v["sd"],
                     v["tau"], v["active"])
        for b in range(B):
            if v["active"][b]:
                wb, wx = fs.cx_step_plain(ops, v["beta"][b], v["x"][b],
                                          _at(v["q"], b), v["sbf"],
                                          v["sd"][b], v["tau"], final)
            else:
                wb, wx = v["beta"][b], v["x"][b]
            assert torch.equal(beta[b], wb) and torch.equal(x[b], wx)


def _fleet_state(dtype=F64, nt=5):
    r0, r1 = _pair()
    r0 = np.concatenate([r0, r0[:1]])
    r1 = np.concatenate([r1, r1[1:]])
    lvs = _levels(r0, r1, nt, dtype)
    k = Kernels(LevelConfig(geom=lvs[0].geom, D=lvs[0].D, E=lvs[0].E,
                            device="cpu", tau=1.9, dtype=dtype))
    return k, lvs, tb.stack_states([k.prep(lv.as_dict(), 1.0) for lv in lvs])


def test_inactive_instance_frozen_through_segments(cpu_threads):
    """An inactive instance's every field, phi included, stays bit-equal
    through segments, rescales and sigma changes (the JAX
    ``_tree_where(ls.done, ls.s, s_new)``), and an active instance's
    segment is bit-equal to the single-instance device driver's from the
    same state."""
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver

    k, lvs, bstate = _fleet_state()
    o = SolveOptions(tol=1e-4, maxit=3000, sigma=1.0, tau=1.9)
    single = DeviceDriver(k, o)
    single.prepare(lvs[2].as_dict())
    out = tb.replay_against_eager(lambda: tb.BatchedDeviceDriver(k, o),
                                  bstate, k=12, inactive=(1,), instance_b=2,
                                  single=single)
    for what, gap, first, frozen in out[:3]:
        assert gap == 0.0 and first is None, what
        assert frozen, what
    # on the CPU the stacked DCT products round as one instance's
    assert out[3][1] == 0.0 and out[3][2] is None


def test_segment_batched_leaves_inactive_alone():
    """``Kernels.segment_batched`` advances the active instances and leaves
    an inactive one's fields bit-equal (phi included)."""
    k, _, s = _fleet_state()
    before = [instance(s, b) for b in range(3)]
    before = [v.replace(phi=v.phi.clone(), q=v.q.clone(), z=v.z.clone(),
                        alpha=v.alpha.clone(), beta=v.beta.clone())
              for v in before]
    active = torch.tensor([False, True, True])
    after = k.segment_batched(s, 7, active)
    for b in range(3):
        got, was = instance(after, b), before[b]
        same = [torch.equal(got.phi, was.phi), torch.equal(got.z, was.z),
                torch.equal(got.beta, was.beta),
                torch.equal(got.q.q0, was.q.q0),
                torch.equal(got.q.bs, was.q.bs),
                torch.equal(got.alpha.q0, was.alpha.q0),
                torch.equal(got.alpha.bs, was.alpha.bs)]
        assert all(same) if b == 0 else not any(same)


def test_pick_fleet_mode_at_the_ports_constant():
    cells = tb.SATURATION_CELLS
    n = 17
    nt_small = cells // (n * n)      # (nt - 1) n^2 < cells
    nt_big = cells // (n * n) + 2    # (nt - 1) n^2 >= cells
    assert (nt_small - 1) * n * n < cells <= (nt_big - 1) * n * n
    assert tb.pick_fleet_mode(8, (n, n), nt_small, 1) == "lockstep"
    assert tb.pick_fleet_mode(8, (n, n), nt_big, 1) == "sequential"
    assert tb.pick_fleet_mode(8, (n, n), nt_small, 4) == "sharded"
    # a fleet whose size shares no factor with the devices stays on one
    assert tb.pick_fleet_mode(3, (n, n), nt_small, 4) == "lockstep"


def test_solve_fleet_modes_agree(cpu_threads):
    r0, r1 = _pair()
    opts = {"tol": 1e-3, "maxit": 1500}
    outs = {}
    for mode in ("sequential", "lockstep", "auto"):
        out = tb.solve_fleet(r0, r1, 5, opts, "inPALM", dtype=F64,
                             mode=mode, verbose=False, device="cpu")
        assert out["done"].all(), (mode, out["kkt"])
        outs[mode] = out
    assert outs["auto"]["mode"] == tb.pick_fleet_mode(2, (17, 17), 5, 1)
    seq = outs["sequential"]["rho"].numpy()
    lock = outs["lockstep"]["rho"].numpy()
    for b in range(2):
        rel = np.linalg.norm(lock[b] - seq[b]) / np.linalg.norm(seq[b])
        assert rel < 1e-2, (b, rel)


def test_refusals():
    r0, r1 = _pair()
    kw = dict(verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tb.solve_batch(r0, r1, 5, OPTS, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tb.solve_fleet(r0, r1, 5, OPTS, mode="sharded", **kw)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tb.solve_fleet(r0, r1, 5, OPTS, mesh=object(), **kw)
    for method in ("acc-ADMM", "sGS-inPALM", "nonsense"):
        with pytest.raises(ValueError, match="inPALM, PALM, ALG2"):
            tb.solve_batch(r0, r1, 5, OPTS, method, **kw)
    with pytest.raises(ValueError, match="unknown option"):
        tb.solve_batch(r0, r1, 5, {"tol": 1e-3, "refine_tol": 1e-6}, **kw)
    with pytest.raises(ValueError, match="one device loop"):
        tb.solve_batch(r0, r1, 5, {"driver": "host"}, **kw)
    with pytest.raises(ValueError, match="unknown fleet mode"):
        tb.solve_fleet(r0, r1, 5, OPTS, mode="nonsense", **kw)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    r0, r1 = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.solve_batch(r0, r1, 5, OPTS, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.solve_fleet(r0, r1, 5, OPTS, mode="lockstep", verbose=False)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _to(v, dev):
    out = {}
    for key, val in v.items():
        if isinstance(val, Staggered):
            out[key] = Staggered(val.q0.to(dev), val.bs.to(dev))
        elif isinstance(val, torch.Tensor):
            out[key] = val.to(dev)
        else:
            out[key] = val
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("space", [(33, 33), (129,), (9, 17, 33)])
def test_batched_kernels_on_the_card(dev, space):
    """Each batched kernel bit-equal per instance to its single-instance
    kernel (sd passed by value), an inactive instance untouched, and
    within rtol 2e-5 / atol 2e-6 of its plain version."""
    B = 3
    ops, v = _random_batch(B, 9, space, torch.float32)
    ops = OpsFlat(ops.geom, torch.float32, dev)
    v = _to(v, dev)
    x0 = v["x"].clone()
    plain = fs.x_step_batched_plain(ops, v["q"], v["beta"], v["sbf"],
                                    v["sd"], v["active"], x0.clone())
    got = fs.x_step_batched(ops, v["q"], v["beta"], v["sbf"], v["sd"],
                            v["active"], x0.clone())
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-6)
    for b in range(B):
        want = (fs.x_step(ops, _at(v["q"], b), v["beta"][b].contiguous(),
                          v["sbf"], float(v["sd"][b]))
                if v["active"][b] else x0[b])
        assert torch.equal(got[b], want)
    for final, fn, single in ((False, fs.cx_step_batched, fs.cx_step),
                              (True, fs.cx_final_batched, fs.cx_final)):
        pb_, px_ = fs.cx_step_batched_plain(
            ops, v["beta"].clone(), v["x"].clone(), v["q"], v["sbf"],
            v["sd"], v["tau"], v["active"], final)
        gb, gx = fn(ops, v["beta"].clone(), v["x"].clone(), v["q"],
                    v["sbf"], v["sd"], v["tau"], v["active"])
        torch.testing.assert_close(gb, pb_, rtol=2e-5, atol=2e-6)
        torch.testing.assert_close(gx, px_, rtol=2e-5, atol=2e-6)
        for b in range(B):
            if not v["active"][b]:
                assert torch.equal(gb[b], v["beta"][b])
                continue
            sb, sx = single(ops, v["beta"][b].clone(), v["x"][b].clone(),
                            Staggered(v["q"].q0[b].contiguous(),
                                      v["q"].bs[b].contiguous()),
                            v["sbf"], float(v["sd"][b]), v["tau"])
            assert torch.equal(gb[b], sb) and torch.equal(gx[b], sx)


@pytest.mark.cuda
def test_lockstep_replays_on_the_card(dev):
    """40-iteration segments replayed from CUDA graphs bit-equal to eager
    runs, an inactive instance frozen, and one instance against the
    single-instance device driver from the same state: within 1e-5 of the
    largest entry here (``chip_smoke.SEG_REL_3D``'s bound), since at
    17^2 x 9 cuBLAS rounds the stacked DCT products unlike one instance's
    (6.4e-6 in phi after 40 iterations on the H100); at the fleet's
    129^2 x 33 ``chip_smoke.py`` phase 8b holds them bit-equal."""
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.ops.poisson import full_precision_matmul

    full_precision_matmul()
    r0, r1 = _pair()
    r0 = np.concatenate([r0, r0[:1]])
    r1 = np.concatenate([r1, r1[1:]])
    lvs = []
    for a, b in zip(r0, r1):
        lv = initialize(torch.as_tensor(a), torch.as_tensor(b), 9,
                        torch.float32, dev)
        initial_scaling(lv, True)
        lvs.append(lv)
    k = Kernels(LevelConfig(geom=lvs[0].geom, D=lvs[0].D, E=lvs[0].E,
                            device=str(dev), tau=1.9, dtype=torch.float32))
    o = SolveOptions(tol=1e-4, maxit=3000, sigma=1.0, tau=1.9)
    single = DeviceDriver(k, o)
    single.prepare(lvs[2].as_dict())
    bstate = tb.stack_states([k.prep(lv.as_dict(), 1.0) for lv in lvs])
    out = tb.replay_against_eager(lambda: tb.BatchedDeviceDriver(k, o),
                                  bstate, k=40, inactive=(1,), instance_b=2,
                                  single=single)
    for what, gap, first, frozen in out[:3]:
        assert gap == 0.0 and first is None, (what, gap, first)
        assert frozen, what
    what, gap, first, scale = out[3]
    assert gap <= 1e-5 * scale, out[3]


if __name__ == "__main__" and "--fleet-anchor" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    f64 = "--f64" in sys.argv
    res = jax_fleet_anchor(f64=f64)
    print("FLEET_ANCHOR" + ("_F64" if f64 else ""), "done_it",
          [int(v) for v in res["done_it"]], "iters", int(res["iters"]),
          "done", res["done"].tolist(), "dtype",
          "float64" if f64 else "float32", "jax", jax.__version__)
    if "--rel" in sys.argv:
        # the JAX package's own lockstep-against-sequential gap: each
        # instance's rho from solve_batch against its solve_dot (the device
        # driver, as solve_fleet's sequential mode runs it)
        import jax.numpy as jnp

        from dotsocp_tpu.models import examples as je
        from dotsocp_tpu.multilevel.solve import solve_dot

        r0, r1 = fleet_problems(je.get_example_2d, je._gaussian2d,
                                je._normalize, 129)
        rel = []
        for b in range(r0.shape[0]):
            one, _, _ = solve_dot(r0[b], r1[b], 33, 3,
                                  {"tol": 1e-4, "maxit": 3000,
                                   "driver": "device"}, "inPALM",
                                  dtype=jnp.float64 if f64 else jnp.float32,
                                  verbose=False)
            seq = np.asarray(one["rho"])
            lock = np.asarray(res["rho"][b])
            rel.append(float(np.linalg.norm(lock - seq)
                             / np.linalg.norm(seq)))
        print("FLEET_REL_JAX", [f"{v:.3e}" for v in rel])
