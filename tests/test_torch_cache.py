"""The port's solver cache (``multilevel/solve.py``: ``reuse_solvers``,
``prewarm``, ``clear_solver_cache``) against the JAX package's, on the CPU
in float64, where the device driver runs its pieces eagerly.

- In one process each package solves example3 and then example4 (2
  levels) under its default ``reuse_solvers=True``: the second problem
  runs on the first one's cached solvers, takes the JAX package's
  iterations with rho within 1e-12, and equals a ``reuse_solvers=False``
  solve bit for bit; E differs between the two problems at level 2, which
  is what a cached driver must not freeze.
- ``prewarm=True`` is bit-equal to ``prewarm=False``, and warms every kind
  of piece the solve then runs.
- The weight keys the cache by content; eleven keys evict the least
  recently used one and free it; ``clear_solver_cache()`` empties and
  frees; ``reuse_solvers=False`` keeps nothing.
- A cached driver's next ``prepare`` writes the new level into the same
  tensors: the E-derived scalars (``core.EScalars``) stay 0-d tensors on
  the state's device at the addresses a captured graph reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotsocp_tpu.models.examples import get_example_2d as jget_example_2d
from dotsocp_tpu.multilevel import solve as jsolve

from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
from dotsocp_tpu_torch.algorithms.driver import SolveOptions
from dotsocp_tpu_torch.models import wdot2d as W
from dotsocp_tpu_torch.models.examples import get_example_2d
from dotsocp_tpu_torch.multilevel import level as tlevel
from dotsocp_tpu_torch.multilevel import solve as tsolve

torch.set_num_threads(2)

F64 = torch.float64
N, NT, LEVELS, TOL = 17, 9, 2, 1e-4
# the JAX package on its flat layout without Pallas, its cache on
JAX_OPTS = {"tol": TOL, "layout": "flat", "use_pallas": False}


def _port(problem, opts=None, method="inPALM", n=N, nt=NT, levels=LEVELS,
          **kw):
    r0, r1 = get_example_2d(problem, n, n)
    out, _, _ = tsolve.solve_dot(r0, r1, nt, levels,
                                 dict({"tol": TOL}, **(opts or {})), method,
                                 device="cpu", dtype=F64, verbose=False, **kw)
    return out


def _jax(problem, opts, method):
    r0, r1 = jget_example_2d(problem, N, N)
    out, _, _ = jsolve.solve_dot(r0, r1, NT, LEVELS, dict(JAX_OPTS, **opts),
                                 method, dtype=jnp.float64, verbose=False)
    return out


def _iters(out):
    return [int(lv["iters"]) for lv in out["levels"]]


@pytest.fixture(autouse=True)
def empty_caches():
    tsolve.clear_solver_cache()
    jsolve.clear_solver_cache()
    yield
    tsolve.clear_solver_cache()
    jsolve.clear_solver_cache()


@pytest.mark.parametrize("method", ["inPALM", "acc-ADMM"])
def test_second_problem_on_cached_solvers_matches_jax(method):
    """example3 then example4 in each package with its cache on: the
    port's example4 runs on example3's solvers (no new entry), takes the
    JAX package's iterations with rho within 1e-12, and is bit-equal to the
    port's solve of example4 with ``reuse_solvers=False``. (example1 and
    example2 would not do: the E2 feedback clamps both to one level-2
    E.)"""
    jax_a = _jax("example3", {}, method)
    jax_b = _jax("example4", {}, method)
    a = _port("example3", method=method)
    entries = len(tsolve._SOLVER_CACHE)
    b = _port("example4", method=method)
    assert len(tsolve._SOLVER_CACHE) == entries == LEVELS
    fresh = _port("example4", {"reuse_solvers": False}, method)
    # the level-2 E comes from each problem's level-1 KKT (E2 feedback)
    assert a["levels"][1]["E"] != b["levels"][1]["E"]
    assert _iters(a) == _iters(jax_a)
    assert _iters(b) == _iters(jax_b)
    np.testing.assert_allclose(b["rho"].numpy(), np.asarray(jax_b["rho"]),
                               rtol=0, atol=1e-12)
    assert _iters(b) == _iters(fresh)
    assert torch.equal(b["rho"], fresh["rho"])


@pytest.mark.parametrize("method", ["inPALM", "PALM", "acc-ADMM",
                                    "sGS-inPALM", "acc-sGS-ADMM"])
def test_prewarm_is_bit_equal_and_warms_every_piece(method):
    """A prewarmed solve equals one without prewarm bit for bit, and every
    kind of piece each level's driver ran is one that ``warm`` ran."""
    plain = _port("example2", method=method)
    tsolve.clear_solver_cache()
    warm = _port("example2", {"prewarm": True}, method)
    assert _iters(warm) == _iters(plain)
    assert torch.equal(warm["rho"], plain["rho"])
    drivers = [e for e in tsolve._SOLVER_CACHE.values()
               if isinstance(e, DeviceDriver)]
    assert len(drivers) == LEVELS
    for d in drivers:
        assert d.graphs.used <= set(d._pieces()), sorted(d.graphs.used)


def test_host_driver_cache_rebuilds_the_solver_around_its_kernels():
    """The host driver keeps per-solve state: each hit is a new solver
    object around the cached kernels, and the result is the fresh one's."""
    a = _port("example2", {"driver": "host"})
    lv = _level()
    o = SolveOptions(tol=TOL, maxit=3000, sigma=1.0, tau=1.9)
    s1 = tsolve._build_solver("inPALM", lv, o, "cpu", F64, driver="host")
    s2 = tsolve._build_solver("inPALM", lv, o, "cpu", F64, driver="host")
    assert s1 is not s2 and s1.k is s2.k
    fresh = _port("example2", {"driver": "host", "reuse_solvers": False})
    assert torch.equal(a["rho"], fresh["rho"])


def _level(problem="example2", n=N, nt=NT, weight=None, e2=None):
    r0, r1 = get_example_2d(problem, n, n)
    lv = tlevel.initialize(r0, r1, nt, dtype=F64, device="cpu",
                           weight=weight)
    tlevel.initial_scaling(lv, True)
    if e2 is not None:  # another problem's E at the same D
        lv.E = lv.D / e2
    return lv


def _key(lv, maxit=3000):
    o = SolveOptions(tol=TOL, maxit=maxit, sigma=1.0, tau=1.9)
    return tsolve._solver_cache_key("inPALM", lv, o, "cpu", F64, 2.0, False,
                                    "device", None, None, None)


def test_weight_key_is_content_based():
    """Two weights built apart with the same values give one key; other
    values give another (the JAX package's test of the same name,
    tests/test_weighted_multilevel.py)."""
    barrier = W.barrier_love_heart()

    def lv(b):
        w = W.get_weight_by_barrier(N, N, NT, b, dtype=F64, device="cpu")
        return tlevel.initialize(*W.get_example_w2d("love-heart", N, N),
                                 NT, dtype=F64, device="cpu", weight=w)

    assert _key(lv(barrier)) == _key(lv(barrier))
    assert _key(lv(barrier)) != _key(lv(None))
    assert _key(lv(barrier)) != _key(_level())


def test_eleven_keys_evict_the_least_recently_used():
    """Eleven keys (maxit 21..31) keep the last ten; the first one's driver
    is freed: no graphs, no buffers."""
    lv = _level()
    built = []
    for maxit in range(21, 32):
        o = SolveOptions(tol=TOL, maxit=maxit, sigma=1.0, tau=1.9)
        d = tsolve._build_solver("inPALM", lv, o, "cpu", F64,
                                 driver="device")
        d.prepare(lv.as_dict())
        built.append((maxit, d))
    assert len(tsolve._SOLVER_CACHE) == tsolve._SOLVER_CACHE_MAX == 10
    keys = set(tsolve._SOLVER_CACHE)
    assert _key(lv, 21) not in keys
    assert all(_key(lv, m) in keys for m in range(22, 32))
    first = built[0][1]
    assert first.graphs is None and first.s is None
    assert all(d.s is not None for _, d in built[1:])


def test_clear_solver_cache_frees_every_entry():
    _port("example2")
    _port("example2", {"driver": "host"})
    drivers = [e for e in tsolve._SOLVER_CACHE.values()
               if isinstance(e, DeviceDriver)]
    assert len(tsolve._SOLVER_CACHE) == 2 * LEVELS and len(drivers) == LEVELS
    tsolve.clear_solver_cache()
    assert len(tsolve._SOLVER_CACHE) == 0
    assert all(d.graphs is None and d.s is None for d in drivers)


def test_reuse_solvers_false_keeps_nothing():
    _port("example2", {"reuse_solvers": False, "prewarm": True})
    assert len(tsolve._SOLVER_CACHE) == 0


@pytest.mark.parametrize("weighted", [False, True], ids=["flat", "weighted"])
def test_cached_prepare_writes_the_same_tensors(weighted):
    """A cached driver prepared on one level and then on another whose E
    differs: every buffer a graph reads keeps its address, the E-derived
    scalars are 0-d tensors on the state's device holding the new level's
    values (formed in double, rounded once), and the weighted inverse
    diagonal is recomputed into its buffer."""
    weight = None
    if weighted:
        weight = W.get_weight_by_barrier(N, N, NT, W.barrier_love_heart(),
                                         dtype=F64, device="cpu")
    first = _level(weight=weight)
    second = _level(weight=weight, e2=1.1)
    o = SolveOptions(tol=TOL, maxit=3000, sigma=1.0, tau=1.9)
    d = tsolve._build_solver("inPALM", first, o, "cpu", F64,
                             driver="device")
    d.prepare(first.as_dict())
    ev = d.s.ev
    addresses = [t.data_ptr() for t in d._all_tensors()]
    scalars = {k: getattr(ev, k).data_ptr() for k in ("E", "sbf", "sv",
                                                      "inv_E")}
    assert tsolve._build_solver("inPALM", second, o, "cpu", F64,
                                driver="device") is d
    d.prepare(second.as_dict())
    assert [t.data_ptr() for t in d._all_tensors()] == addresses
    assert d.s.ev is ev and d.s.E is ev.E
    for k, ptr in scalars.items():
        t = getattr(ev, k)
        assert t.dim() == 0 and t.device == d.s.phi.device
        assert t.dtype == d.s.phi.dtype and t.data_ptr() == ptr
    assert float(ev.E) == second.E and float(ev.sbf) == second.E / second.D
    fresh = d.k.e_scalars(second.D, second.E)
    assert torch.equal(ev.vec, fresh.vec)
    if weighted:
        assert torch.equal(ev.dinv.inv.q0, fresh.dinv.inv.q0)
        assert torch.equal(ev.dinv.inv.bs, fresh.dinv.inv.bs)
        assert ev.dinv.base[0].data_ptr() == ev.vec[3].data_ptr()


def test_prewarm_and_reuse_are_solve_dot_options():
    """prewarm and reuse_solvers are options of solve_dot, and a prewarmed
    solve of another problem under cached keys builds no entry."""
    _port("example1", {"prewarm": True})
    n = len(tsolve._SOLVER_CACHE)
    _port("example2", {"prewarm": True})
    assert len(tsolve._SOLVER_CACHE) == n
    assert "prewarm" in tsolve.KNOWN_OPTS and "reuse_solvers" in \
        tsolve.KNOWN_OPTS
