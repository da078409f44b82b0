"""What the ranks of the spawned gloo worlds of ``tests/test_torch_halo.py``,
``test_torch_parallel.py`` and ``test_torch_distributed.py`` run. This
module imports torch and the port only: every rank is a fresh process
(``dotsocp_tpu_torch/parallel/launch.run_world``) that imports it by name,
and JAX stays in the test process, which compares. Each function returns
numpy arrays and Python numbers (on rank 0, or on every rank where the
test compares the ranks)."""
import numpy as np
import torch
import torch.distributed as dist

from dotsocp_tpu_torch.ops.geometry import Geometry
from dotsocp_tpu_torch.ops.staggered import Staggered

F64 = torch.float64


def _np(x):
    if isinstance(x, Staggered):
        return (x.q0.numpy(), tuple(b.numpy() for b in x.bs))
    return x.numpy()


def _pads_max(oh, x, short=None, t_real=None):
    """The largest |entry| of the pads of a block field (gathered)."""
    full = oh._gather(x, t=True)
    pads = torch.zeros((), dtype=full.dtype)
    for a in range(oh.d):
        ax = full.ndim - oh.d + a
        real = oh.geom.space[a] - (1 if a == short else 0)
        pads = torch.maximum(pads, full.narrow(ax, real, full.shape[ax]
                                               - real).abs().amax()
                             if full.shape[ax] > real else pads)
    if oh.sharded_t and t_real is not None:
        ax = full.ndim - oh.d - 1
        if full.shape[ax] > t_real:
            pads = torch.maximum(pads, full.narrow(ax, t_real, full.shape[ax]
                                                   - t_real).abs().amax())
    return float(pads)


def _stacked_ops(oh, pi, sti, zi) -> dict:
    """Each operator of ``oh`` on a stack of 3 instances (the inputs and two
    others made from them, bd with a different scale_d an instance) against
    the operator on each instance alone: op -> True where every instance's
    slice of the stacked result is bit-equal (``torch.equal``) to its own
    result; and the largest pad entry of the stacked face and cone blocks."""
    from dotsocp_tpu_torch.ops.cone import proj_soc

    B = 3
    # products and multiples of the inputs keep the pads at zero
    phis = [pi, 1.7 * pi - 0.3 * pi * pi, pi * pi]
    sts = [sti, sti * 0.6 + sti * sti, Staggered(-sti.q0, sti.bs * 2.1)]
    zs = [zi, zi * zi - 0.5 * zi, -1.3 * zi]
    sd = torch.tensor([0.7, 1.1, 0.2], dtype=F64)
    stack_st = Staggered(torch.stack([s.q0 for s in sts]),
                         torch.stack([s.bs for s in sts]))
    phi, z = torch.stack(phis), torch.stack(zs)
    sd_b = sd.reshape((B,) + (1,) * (stack_st.q0.ndim - 1))
    poisson = oh.make_poisson(1.0)
    ops = {
        "grad": (lambda b: oh.grad(phis[b]), oh.grad(phi)),
        "grad_T": (lambda b: oh.grad_T(sts[b]), oh.grad_T(stack_st)),
        "bfd": (lambda b: oh.bfd(sts[b], 1.3, sd[b]),
                oh.bfd(stack_st, 1.3, sd_b)),
        "bfd_T": (lambda b: oh.bfd_T(zs[b], 0.9), oh.bfd_T(z, 0.9)),
        "poisson": (lambda b: poisson.solve(phis[b], scale=0.5),
                    poisson.solve(phi, scale=0.5)),
        "face_interp": (lambda b: oh.face_interp(phis[b], oh.d - 1),
                        oh.face_interp(phi, oh.d - 1)),
        "t_node_interp": (lambda b: oh.t_node_interp(sts[b].q0),
                          oh.t_node_interp(stack_st.q0)),
        "proj_soc": (lambda b: proj_soc(zs[b]),
                     proj_soc(z, oh.cone_dim)),
    }
    out = {}
    for name, (one, stacked) in ops.items():
        same = True
        for b in range(B):
            want = one(b)
            if isinstance(want, Staggered):
                same &= bool(torch.equal(stacked.q0[b], want.q0)
                             and torch.equal(stacked.bs[b], want.bs))
            else:
                same &= bool(torch.equal(stacked[b], want))
        out[name] = same
    d, nt = oh.geom.ndim_space, oh.geom.nt
    gr, bt = ops["grad"][1], ops["bfd_T"][1]
    pads = max(
        _pads_max(oh, ops["bfd"][1], t_real=nt - 1),
        *[_pads_max(oh, x.bs.select(1, a), a, nt)
          for x in (gr, bt) for a in range(d)])
    return {"equal": out, "pads_max": pads}


def halo_ops(cases) -> list:
    """Each case (axis names, nt, space, inputs as numpy): the halo ops of
    the port on that mesh, gathered: grad, grad_T, bfd, bfd_T, the Poisson
    solve, two sGS sweeps and the colour-A residual norm, and the largest
    pad entry of bfd's, bfd_T's, grad's and the sweep's blocks; and under
    ``stack``, the operators on a stack of instances against each alone
    (:func:`_stacked_ops`, every rank's)."""
    from dotsocp_tpu_torch.ops.halo_engine import HaloSGS, OpsHalo
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    out = []
    for names, nt, space, inp in cases:
        mesh = make_mesh(axis_names=names)
        g = Geometry(nt, tuple(space))
        oh = OpsHalo(g, F64, "cpu", mesh)
        phi = torch.tensor(inp["phi"])
        st = Staggered(torch.tensor(inp["q0"]),
                       tuple(torch.tensor(b) for b in inp["bs"]))
        z = torch.tensor(inp["z"])
        rhs = torch.tensor(inp["rhs"])
        pi, sti, zi = (oh.phi_to_internal(phi), oh.stag_to_internal(st),
                       oh.z_to_internal(z))
        gr = oh.grad(pi)
        bf = oh.bfd(sti, 1.3, 0.7)
        bt = oh.bfd_T(zi, 0.9)
        sgs = HaloSGS(oh)
        sw = sgs.sweep(pi, oh.phi_to_internal(rhs), 2, d2=0.64)
        d = g.ndim_space
        pads = max(_pads_max(oh, bf, t_real=nt - 1),
                   _pads_max(oh, sw, t_real=nt),
                   *[_pads_max(oh, gr.bs[a], a, nt) for a in range(d)],
                   *[_pads_max(oh, bt.bs[a], a, nt) for a in range(d)])
        res = {
            "mesh": dict(mesh.shape),
            "grad": _np(oh.stag_from_internal(gr)),
            "grad_T": _np(oh.phi_from_internal(oh.grad_T(sti))),
            "bfd": _np(oh.z_from_internal(bf)),
            "bfd_T": _np(oh.stag_from_internal(bt)),
            "poisson": _np(oh.phi_from_internal(
                oh.make_poisson(1.0).solve(pi, scale=0.5))),
            "sweep": _np(oh.phi_from_internal(sw)),
            "resid": float(sgs.residual_color_a_norm(
                sw, oh.phi_to_internal(rhs), 0.1, d2=0.64)),
            "pads_max": pads,
        }
        stack = _stacked_ops(oh, pi, sti, zi)
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, stack)
        res["stack"] = everyone
        out.append(res if dist.get_rank() == 0 else None)
    return out


def solves(cases) -> list:
    """Each case (axis names, problem, n, nt, levels, opts, method,
    weighted): the port's meshed solve_dot in float64 on the CPU; every
    rank returns its per-level counts, rho and final KKT row."""
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    out = []
    for names, problem, n, nt, levels, opts, method, weighted in cases:
        mesh = make_mesh(axis_names=names)
        out.append(solve_case(problem, n, nt, levels,
                              dict(opts, mesh=mesh), method, weighted))
    return out


def ops_and_solves(cases, solve_cases):
    return halo_ops(cases), solves(solve_cases)


def solve_case(problem, n, nt, levels, opts, method, weighted=False):
    """The port's solve_dot of one case in float64 on the CPU: (per-level
    iterations, rho, the last KKT row)."""
    from dotsocp_tpu_torch.models import wdot2d
    from dotsocp_tpu_torch.models.examples import get_example_2d, \
        get_example_3d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    kw = {}
    if weighted:
        r0, r1 = wdot2d.get_example_w2d(problem, n, n)
        barrier = wdot2d.barrier_love_heart()
        r0, r1, _ = wdot2d.ensure_barrier_validity(r0, r1, barrier)
        kw = {"weight": wdot2d.get_weight_by_barrier(n, n, nt, barrier),
              "barrier": barrier}
    elif problem == "gaussian3d":
        r0, r1 = get_example_3d("gaussian", n, n, n)
    else:
        r0, r1 = get_example_2d(problem, n, n)
    out, hml, _ = solve_dot(r0, r1, nt, levels, dict(opts), method,
                            device="cpu", dtype=F64, verbose=False, **kw)
    return ([lv["iters"] for lv in out["levels"]], out["rho"].numpy(),
            np.asarray(hml["kkt"][-1]), bool(out["mass_ok"]))


def fleet(r0s, r1s, nt, opts, levels) -> dict:
    """The sharded f64 fleet (``solve_fleet(mode="sharded")``) over the
    world's ranks; every rank returns what it got."""
    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    out = solve_fleet(r0s, r1s, nt, opts, "inPALM", dtype=F64,
                      level_n=levels, mode="sharded", verbose=False,
                      device="cpu")
    return {"mode": out["mode"], "iters": out["iters"],
            "done": out["done"], "done_it": out["done_it"],
            "kkt": out["kkt"], "rho": out["rho"].numpy(),
            "chunk_cuts": [lv["driver"]["chunk_cuts"]
                           for lv in out["levels"]]}


def mesh_resume(ck, maxit, chunk) -> dict:
    """Checkpoint/resume of a meshed inPALM solve (example2 33^2 x 9, one
    level, float64, a (y,) mesh of the world), each rank writing its own
    file under ``ck``: the uninterrupted solve; a solve cut after one
    chunk; a resume cut after one more; the last rank's file then put back
    to the first cut's (a stale file on one rank: every rank must start
    afresh, ending as the first cut did); a resume to the end. Every rank
    returns the runs' iterations and rho."""
    import os
    import shutil

    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=("y",))
    last = dist.get_world_size() - 1
    mine = os.path.join(ck, f"level1.rank{mesh.rank}.npz")
    base = {"tol": 1e-4, "maxit": maxit, "driver": "device", "mesh": mesh}
    cut = dict(base, checkpoint_dir=ck, chunk_iters=chunk, max_chunks=1)

    def run(opts):
        it, rho, _, _ = solve_case("example2", 33, 9, 1, opts, "inPALM")
        return it[0], rho

    out = {"full": run(base), "cut": run(cut)}
    if mesh.rank == last:
        shutil.copy(mine, mine + ".first")
    out["resumed_cut"] = run(cut)
    if mesh.rank == last:
        shutil.copy(mine + ".first", mine)
    out["stale_cut"] = run(cut)
    out["resumed"] = run({k: v for k, v in cut.items()
                          if k != "max_chunks"})
    return out


def conversions(nt, space, seed) -> dict:
    """make_mesh's shapes and coordinates, and shard_state / gather_state
    round trips of a random flat state on (y, x), (t, y, x) and (x,)
    meshes; plus the comm layer's shift, psum and all_gather against
    what one process computes."""
    from dotsocp_tpu_torch.algorithms.core import SolverState
    from dotsocp_tpu_torch.parallel import comm
    from dotsocp_tpu_torch.parallel.sharding import (gather_state,
                                                     make_mesh, shard_state)
    from dotsocp_tpu_torch.utils.interop import (state_from_numpy,
                                                 state_to_numpy)

    g = Geometry(nt, tuple(space))
    S = int(np.prod(space))
    d = len(space)
    rng = np.random.RandomState(seed)

    def rnd(*shape):
        return torch.tensor(rng.randn(*shape))

    # a flat state with zero ghost slots, as the flat engine keeps them
    from dotsocp_tpu_torch.ops.engine import OpsFlat

    fl = OpsFlat(g, F64, "cpu")
    q = Staggered(rnd(nt - 1, S), rnd(d, nt, S) * fl.masks)
    alpha = Staggered(rnd(nt - 1, S), rnd(d, nt, S) * fl.masks)
    s = SolverState(phi=rnd(nt, S), q=q, z=rnd(g.cone_cols, nt - 1, S),
                    alpha=alpha, beta=rnd(g.cone_cols, nt - 1, S),
                    c=rnd(nt, S), sigma=1.0, cScale=1.0, dScale=1.0,
                    norm_c=1.0, norm_d=1.0, sigmaScale=1.0, D=1.0, E=1.0)
    out = {"meshes": [], "round_trip": []}
    for names in (("y", "x"), ("t", "y", "x"), ("x",), ("batch", "y", "x")):
        mesh = make_mesh(axis_names=names)
        out["meshes"].append((dict(mesh.shape), mesh.coords))
        if "batch" in names:
            continue
        # the shaped global state, as a JAX state arrives, to this rank's
        # block through utils/interop, and back
        shaped = dict(
            state_to_numpy(s),
            **{f: fl.phi_from_internal(getattr(s, f)).numpy()
               for f in ("phi", "c")},
            **{f: fl.z_from_internal(getattr(s, f)).numpy()
               for f in ("z", "beta")},
            **{f: _np(fl.stag_from_internal(getattr(s, f)))
               for f in ("q", "alpha")})
        local = state_from_numpy(shaped, device="cpu", dtype=F64, mesh=mesh)
        ref = shard_state(s, mesh, g)
        same = all(bool(torch.equal(getattr(local, f), getattr(ref, f)))
                   for f in ("phi", "z", "beta", "c")) and all(
            bool(torch.equal(getattr(local, f).q0, getattr(ref, f).q0))
            and bool(torch.equal(getattr(local, f).bs, getattr(ref, f).bs))
            for f in ("q", "alpha"))
        out.setdefault("interop", []).append(same)
        back = gather_state(ref, mesh, g)
        err = 0.0
        for f in ("phi", "z", "beta", "c"):
            err = max(err, float((getattr(back, f) - getattr(s, f))
                                 .abs().max()))
        for f in ("q", "alpha"):
            a, b = getattr(back, f), getattr(s, f)
            err = max(err, float((a.q0 - b.q0).abs().max()),
                      float((a.bs - b.bs).abs().max()))
        out["round_trip"].append((names, err))
    # the comm layer against one process's answers
    mesh = make_mesh(axis_names=("y", "x"))
    full = torch.arange(4.0 * 6 * 8, dtype=F64).reshape(4, 6, 8)
    ky, kx = mesh.shape["y"], mesh.shape["x"]
    cy, cx = mesh.coords["y"], mesh.coords["x"]
    ly, lx = 6 // ky, 8 // kx
    block = full[:, cy * ly:(cy + 1) * ly, cx * lx:(cx + 1) * lx]
    errs = {}
    ref_fwd = torch.nn.functional.pad(full[:, :-1], (0, 0, 1, 0))
    got = comm.shift(block, 1, mesh, "y", True)
    errs["shift"] = float((got - ref_fwd[:, cy * ly:(cy + 1) * ly,
                                         cx * lx:(cx + 1) * lx]).abs().max())
    ref_bwd = torch.nn.functional.pad(full[:, :, 1:], (0, 1))
    got = comm.shift(block, 2, mesh, "x", False)
    errs["shift_x"] = float((got - ref_bwd[:, cy * ly:(cy + 1) * ly,
                                           cx * lx:(cx + 1) * lx]).abs().max())
    errs["psum"] = float(abs(comm.psum(block.sum(), mesh) - full.sum()))
    got = comm.all_gather(block, 1, mesh, "y")
    errs["all_gather"] = float((got - full[:, :, cx * lx:(cx + 1) * lx])
                               .abs().max())
    errs["gather_blocks"] = float((comm.gather_blocks(
        block, mesh, {"y": 1, "x": 2}) - full).abs().max())
    errs["bytes"] = mesh.stats["bytes"]
    out["comm"] = errs
    return out


def conversions_and_fleet(nt, space, seed, r0s, r1s) -> tuple:
    """:func:`conversions`, then ``solve_fleet(mode="sharded")`` of
    ``len(r0s)`` instances in float64 at 1 level: with fewer instances
    than ranks the mesh holds gcd(B, world) ranks, and the others receive
    its result."""
    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    conv = conversions(nt, space, seed)
    out = solve_fleet(r0s, r1s, 5, {"tol": 1e-3, "maxit": 1500}, "inPALM",
                      dtype=F64, level_n=1, mode="sharded", verbose=False,
                      device="cpu")
    return conv, {"mode": out["mode"], "iters": out["iters"],
                  "done_it": out["done_it"], "rho": out["rho"].numpy()}


def fail_on(rank_to_fail: int) -> int:
    """Raises on one rank, leaving the others in a collective."""
    if dist.get_rank() == rank_to_fail:
        raise RuntimeError("this rank fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return dist.get_rank()


def solves_and_steps(cases, n, nt, steps, fleet_args) -> tuple:
    """:func:`solves`, then :func:`sharded_steps`, then
    :func:`batch_spatial` of ``fleet_args``."""
    return (solves(cases), sharded_steps(n, nt, steps),
            batch_spatial(*fleet_args, n, nt, steps))


def batch_spatial(r0s, r1s, nt, opts, levels, n, step_nt, steps) -> dict:
    """On a ("batch", "y", "x") mesh of the world (4 ranks: 2 x 2 x 1):

    - ``psum``: each rank's rank + 1 summed over its batch row
      (``Mesh.row``), through ``comm.psum`` and through the halo engine
      built on the row, and over the whole mesh; and whether the halo
      engine refuses the whole mesh;
    - ``inPALM`` / ``PALM``: ``solve_batch`` of the fleet in float64
      (inPALM on ``levels`` levels, PALM on one), with the chunk cuts and
      checks of every level and the number of ``comm.psum`` calls;
    - ``steps``: ``make_sharded_step(batched=True)`` run ``steps`` times on
      world copies of example2's first level at n^2 x step_nt, each
      instance's phi, z and q0.

    Every rank returns what it got."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import (initial_scaling,
                                                    initialize)
    from dotsocp_tpu_torch.ops.halo_engine import OpsHalo
    from dotsocp_tpu_torch.parallel import comm
    from dotsocp_tpu_torch.parallel.batch import solve_batch, stack_states
    from dotsocp_tpu_torch.parallel.sharding import (make_mesh,
                                                     make_sharded_step)

    mesh = make_mesh(axis_names=("batch", "y", "x"))
    row = mesh.row()
    mine = torch.tensor([float(mesh.rank + 1)], dtype=F64)
    g = Geometry(nt, tuple(np.shape(r0s)[1:]))
    out = {"mesh": dict(mesh.shape), "coords": mesh.coords,
           "row_ranks": list(row.ranks), "psum": {
               "row": float(comm.psum(mine, row)),
               "ops": float(OpsHalo(g, F64, "cpu", row).psum(mine)),
               "mesh": float(comm.psum(mine, mesh))}}
    try:
        OpsHalo(g, F64, "cpu", mesh)
        out["psum"]["refused"] = False
    except ValueError:
        out["psum"]["refused"] = True

    calls = [0]
    psum = comm.psum

    def counted(t, m):
        calls[0] += 1
        return psum(t, m)

    for method, lv in (("inPALM", levels), ("PALM", 1)):
        calls[0] = 0
        comm.psum = counted
        try:
            res = solve_batch(r0s, r1s, nt, opts, method, dtype=F64,
                              mesh=mesh, level_n=lv, verbose=False,
                              device="cpu")
        finally:
            comm.psum = psum
        out[method] = {
            "iters": res["iters"], "done": res["done"],
            "done_it": res["done_it"], "kkt": res["kkt"],
            "rho": res["rho"].numpy(), "psum_calls": calls[0],
            "chunk_cuts": [r["driver"]["chunk_cuts"] for r in res["levels"]],
            "checks": [r["driver"]["checks"] for r in res["levels"]],
            "graph_kinds": [r["driver"]["graph_kinds"]
                            for r in res["levels"]]}

    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, step_nt, dtype=F64, device="cpu")
    initial_scaling(lv, True)
    k = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu",
                            dtype=F64))
    s = k.prep(lv.as_dict(), 1.0)
    world = dist.get_world_size()
    step = make_sharded_step(k, mesh)
    b = stack_states([s.clone() for _ in range(world)])
    for _ in range(steps):
        b = step(b)
    out["steps"] = [(b.phi[i].numpy(), b.z[i].numpy(), b.q.q0[i].numpy())
                    for i in range(world)]
    return out


def sharded_steps(n, nt, steps) -> dict:
    """``make_sharded_step`` over a ("batch",) mesh of the world (B = world
    copies of one level's state) and over a (y, x) mesh, each run
    ``steps`` times from example2's first level; then a weighted level
    (love-heart) over the (y, x) mesh and kernels of the "3d" layout over
    the ("batch",) mesh; rank 0 returns the states' phi, z and q0 (the
    batched ones per instance)."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import (initial_scaling,
                                                    initialize)
    from dotsocp_tpu_torch.parallel.batch import stack_states
    from dotsocp_tpu_torch.parallel.sharding import (make_mesh,
                                                     make_sharded_step)

    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, nt, dtype=F64, device="cpu")
    initial_scaling(lv, True)
    k = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu",
                            dtype=F64))
    s = k.prep(lv.as_dict(), 1.0)
    world = dist.get_world_size()
    out = {}
    step = make_sharded_step(k, make_mesh(axis_names=("batch",)))
    b = stack_states([s.clone() for _ in range(world)])
    for _ in range(steps):
        b = step(b)
    out["batched"] = [(b.phi[i].numpy(), b.z[i].numpy(), b.q.q0[i].numpy())
                      for i in range(world)]
    step = make_sharded_step(k, make_mesh(axis_names=("y", "x")),
                             batched=False)
    x = s
    for _ in range(steps):
        x = step(x)
    out["spatial"] = (x.phi.numpy(), x.z.numpy(), x.q.q0.numpy())
    # a weighted level (love-heart) on the (y, x) mesh: its halo kernels
    # carry the weight
    from dotsocp_tpu_torch.models import wdot2d as W

    barrier = W.barrier_love_heart()
    w0, w1 = W.get_example_w2d("love-heart", n, n)
    w0, w1, _ = W.ensure_barrier_validity(w0, w1, barrier)
    lvw = initialize(w0, w1, nt, dtype=F64, device="cpu",
                     weight=W.get_weight_by_barrier(n, n, nt, barrier,
                                                    dtype=F64))
    initial_scaling(lvw, True)
    kw = Kernels(LevelConfig(geom=lvw.geom, D=lvw.D, E=lvw.E, device="cpu",
                             dtype=F64), lvw.weight)
    step = make_sharded_step(kw, make_mesh(axis_names=("y", "x")),
                             batched=False)
    x = kw.prep(lvw.as_dict(), 1.0)
    for _ in range(steps):
        x = step(x)
    out["weighted_spatial"] = (x.phi.numpy(), x.z.numpy(), x.q.q0.numpy())
    # kernels of the "3d" layout on the ("batch",) mesh, the state shaped
    k3 = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, device="cpu",
                             dtype=F64, layout="3d"))
    step = make_sharded_step(k3, make_mesh(axis_names=("batch",)))
    b = stack_states([k3.prep(lv.as_dict(), 1.0) for _ in range(world)])
    for _ in range(steps):
        b = step(b)
    out["batched_3d"] = [(b.phi[i].numpy(), b.z[i].numpy(),
                          b.q.q0[i].numpy()) for i in range(world)]
    return out if dist.get_rank() == 0 else None
