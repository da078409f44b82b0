"""Trace where the float32 counts of the port and the JAX package part, on
the CPU: the lockstep solve of one instance (``solve_batch`` with B = 1)
of example2 at 129^2 x 33, 3 levels, tol 1e-4, inPALM.

    python scripts/trace_f32_divergence.py [--n 129] [--nt 33]
        [--levels 3] [--steps 400] [--threads 4]

1. Both packages' ``solve_batch`` in float32 (JAX with x64 off, as
   ``tests/test_torch_batch.py --fleet-anchor`` runs it): the iterations
   of each level, to find the first level whose counts differ.
2. That level's start state, taken from the JAX run, handed to both
   packages (``utils/interop.batch_state_from_numpy``), and each lockstep
   driver run from it: whether the counts still part from one state.
   JAX's loop runs again one iteration a chunk, each check's sigma,
   stage and last KKT row read back, to find the first check whose
   decision differs from the port's; the port's float64 run from the same
   state gives that check's reading without float32 rounding.
3. From that state, ``--steps`` iterations step by step: the JAX plain
   step (``Kernels.run_one``, what the JAX package runs on the CPU), the
   port's plain step (``Kernels._step_plain``) and the port's x-carry CA
   segment (what the port's loop runs), each in float32, against the
   port's float64 plain step from the same state: the float32 growth
   envelope. A gap between two float32 runs well inside the envelope is
   rounding; one above it is an operation that differs.
4. The port's driver from that state with every check logged: the sigma
   table's input pri/dua and its distance to the nearest table edge.

Prints one line a finding; nothing is written.
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _rel_gap(a: dict, b: dict) -> float:
    """Largest relative max-abs gap over the iterate fields."""
    gap = 0.0
    for f in ("phi", "z", "beta", "c"):
        x, y = np.asarray(a[f], np.float64), np.asarray(b[f], np.float64)
        gap = max(gap, float(np.abs(x - y).max() / max(np.abs(y).max(),
                                                       1e-300)))
    for f in ("q", "alpha"):
        for x, y in zip([a[f][0], *a[f][1]], [b[f][0], *b[f][1]]):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            gap = max(gap, float(np.abs(x - y).max()
                                 / max(np.abs(y).max(), 1e-300)))
    return gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=129)
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)

    from dotsocp_tpu.models.examples import get_example_2d as jex
    from dotsocp_tpu.parallel import batch as jbatch
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.core import instance
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.parallel import batch as tbatch
    from dotsocp_tpu_torch.parallel.batch import BatchedDeviceDriver
    from dotsocp_tpu_torch.utils.interop import (batch_state_from_numpy,
                                                 state_to_numpy)

    r0, r1 = jex("example2", a.n, a.n)
    opts = {"tol": 1e-4, "maxit": 3000}

    # 1. both solve_batch runs, the JAX level start states kept
    starts = []
    orig = jbatch.BatchedDeviceDriver.solve

    def keep(self, bstate):
        starts.append((self.k, self.opts, jax.device_get(bstate)))
        return orig(self, bstate)

    jbatch.BatchedDeviceDriver.solve = keep
    jout = jbatch.solve_batch(r0[None], r1[None], a.nt, opts,
                              level_n=a.levels, dtype=jnp.float32,
                              verbose=False)
    jbatch.BatchedDeviceDriver.solve = orig
    tout = tbatch.solve_batch(r0[None], r1[None], a.nt, opts,
                              level_n=a.levels, dtype=torch.float32,
                              verbose=False, device="cpu")
    t_levels = [lv["iters"] for lv in tout["levels"]]
    j_final = int(jout["done_it"][0])
    print(f"1. solve_batch B=1 float32: JAX total {jout['iters']}, final "
          f"level done_it {j_final}; port levels {t_levels}, done_it "
          f"{int(tout['done_it'][0])}", flush=True)
    lev = a.levels - 1
    if jout["iters"] - j_final == sum(t_levels[:-1]):
        print(f"   the levels before the last take the same total "
              f"({sum(t_levels[:-1])}): the counts part on level {a.levels}",
              flush=True)

    # 2. both drivers from the JAX start state of that level
    jk, jo, jstate = starts[lev]
    fields = [jax.tree.map(lambda x: np.asarray(x)[0], jstate)._asdict()]
    geom = jk.geom
    cfg = dict(geom=geom, D=float(fields[0]["D"]), E=float(fields[0]["E"]),
               device="cpu", tau=1.9)
    k32 = Kernels(LevelConfig(dtype=torch.float32, **cfg))
    k64 = Kernels(LevelConfig(dtype=torch.float64, **cfg))
    o = SolveOptions(tol=jo.tol, maxit=jo.maxit, sigma=1.0, tau=1.9)
    jls, _ = jbatch.BatchedDeviceDriver(jk, jo).solve(jstate)
    # the JAX loop again, one iteration a chunk (its steps are plain, so
    # the chunking changes no arithmetic), each check's decision read back
    jd = jbatch.BatchedDeviceDriver(jk, jo, chunk_iters=1)
    B = 1
    ls = jbatch.BatchLoopState(
        s=jstate, it=jnp.zeros((), jnp.int32),
        last_sigma_it=jnp.full((), -(10 ** 9), jnp.int32),
        use_feas_org=jnp.zeros((B,), bool),
        stage=jnp.full((B,), 1, jnp.int32),
        max_feas=jnp.full((B,), jnp.inf, jnp.float32),
        rel_gap=jnp.full((B,), jnp.inf, jnp.float32),
        done=jnp.zeros((B,), bool), done_it=jnp.full((B,), -1, jnp.int32),
        kkt_last=jnp.full((B, 7), jnp.inf, jnp.float32))
    jlog = {}
    last = None
    while True:
        it = int(ls.it)
        if it >= jo.maxit or bool(ls.done[0]):
            break
        ls = jd._chunk(ls, jnp.asarray(it + 1, jnp.int32))
        k = np.asarray(ls.kkt_last[0], np.float64)
        if last is None or not np.array_equal(k, last):
            last = k
            xi = max(k[0], k[1]) / max(k[2], k[4], 1e-30)
            jlog[int(ls.it)] = (float(ls.s.sigma[0]), int(ls.stage[0]),
                                float(max(k[[0, 2, 5, 6]]) / jo.tol), xi,
                                bool(ls.use_feas_org[0]))
    log = []

    class Logged(BatchedDeviceDriver):
        def _check_block(self):
            s = instance(self.s, 0)
            res = self.k._kkt(s)
            use = bool(self.ls.use_feas_org[0]) or bool(
                res["kkt"].max() < 5.0 * self.opts.tol)
            ko, k5 = res["kkt_org"], res["kkt"]
            pri = max(ko[0], ko[1]) if use else max(k5[0], k5[1])
            dua = max(ko[2], ko[4]) if use else max(k5[2], k5[4])
            sigma = float(s.sigma)
            err = max(float(ko[i]) for i in (0, 2, 5, 6))
            super()._check_block()
            log.append((int(self.ls.it), float(pri / max(dua, 1e-30)),
                        sigma, float(self.s.sigma[0]),
                        int(self.ls.stage[0]), err / self.opts.tol, use))

    tls, _ = Logged(k32, o).solve(
        batch_state_from_numpy(fields, device="cpu", dtype=torch.float32))
    log32, log = log, []
    Logged(k64, o).solve(
        batch_state_from_numpy(fields, device="cpu", dtype=torch.float64))
    log64 = {row[0]: row for row in log}
    log = log32
    print(f"2. from the JAX start state of level {a.levels}: JAX done_it "
          f"{int(np.asarray(jls.done_it)[0])} (one iteration a chunk: "
          f"{max(jlog)}), port done_it {int(tls.done_it[0])}", flush=True)
    # a decision differs where the stage or the stop differs, or where
    # sigma parts by more than the rescale's rounding (the table moves it
    # by 10% or more)
    first = None
    for it, xi, _, sig1, stage, err, use in log:
        j = jlog.get(it)
        if j is None or j[1] != stage or abs(sig1 / j[0] - 1.0) > 1e-3 or (
                (err < 1.0) != (j[2] < 1.0)):
            first = (it, xi, sig1, stage, err, use, j)
            break
    if first is not None:
        it, xi, sig1, stage, err, use, j = first
        print(f"   the first check whose decision differs: iteration {it}; "
              f"port pri/dua {xi:.6g}, sigma after {sig1:.6g}, stage "
              f"{stage}, stop residual / tol {err:.6g} (kkt_org for the "
              f"table: {use}); JAX (sigma after, stage, stop residual / "
              f"tol, kkt_org pri/dua, kkt_org for the table) {j}",
              flush=True)
        f64 = log64.get(it)
        print(f"   the port in float64 from the same state at iteration "
              f"{it}: " + ("no check there" if f64 is None else
                           f"pri/dua {f64[1]:.6g}, stop residual / tol "
                           f"{f64[5]:.6g}"), flush=True)

    # 3. step by step from that state
    from dotsocp_tpu_torch.utils.interop import state_from_numpy

    js = jax.tree.map(lambda x: x[0], jstate)
    p32 = state_from_numpy(fields[0], device="cpu", dtype=torch.float32)
    p64 = state_from_numpy(fields[0], device="cpu", dtype=torch.float64)
    ca = p32.clone()
    marks = sorted({1, 2, 5, 10, 20, 50, 100, 200, 400, a.steps})
    first_op = None
    done = 0
    for m in [x for x in marks if x <= a.steps]:
        for _ in range(m - done):
            js = jk.run_one(js)
            p32 = k32._step_plain(p32)
            p64 = k64._step_plain(p64)
        ca = k32.segment_impl(ca, m - done)
        done = m
        jf = jax.device_get(js)._asdict()
        env = _rel_gap(jf, state_to_numpy(p64))
        plain = _rel_gap(state_to_numpy(p32), jf)
        cagap = _rel_gap(state_to_numpy(ca), jf)
        print(f"3. after {m:4d} steps: float32 envelope (JAX f32 against "
              f"port f64) {env:.2e}; port plain f32 against JAX f32 "
              f"{plain:.2e}; port CA segment f32 against JAX f32 "
              f"{cagap:.2e}", flush=True)
        if first_op is None and max(plain, cagap) > 4.0 * env:
            first_op = m
    print(f"   first step where a float32 pair parts by more than 4x the "
          f"envelope: {first_op}", flush=True)

    # 4. the port's checks near a sigma-table edge
    from dotsocp_tpu_torch.algorithms.driver import UPDATE_RULE

    edges = [e for e, _ in UPDATE_RULE]
    near = []
    for it, xi, sig0, sig1, stage, _, _ in log:
        x = xi if xi >= 1.0 else 1.0 / xi
        d = min(abs(x - e) / e for e in edges)
        near.append((d, it, xi, sig0, sig1, stage))
    near.sort()
    print("4. the port's checks closest to a sigma-table edge "
          "(relative distance, iteration, pri/dua, sigma before, after, "
          "stage):", flush=True)
    for row in near[:6]:
        print("   " + ", ".join(f"{v:.4g}" if isinstance(v, float) else
                                str(v) for v in row), flush=True)


if __name__ == "__main__":
    main()
