"""The plain reference of the weighted (obstacle) problem: an independent
solve of a checked instance's discrete weighted dynamic-OT problem in
float64 PyTorch, and the numbers that judge the program's answer against
it. It imports nothing of the program and takes the problem as tensors:
the instance's ends and the weight of each space axis's faces.

**The weighted SOCP** (DOT-SOCP's weighted problem, arXiv:2505.05424;
``solver_wsocp_inPALM.m``): the unweighted staggered SOCP of
``reference.py`` with its first constraint A phi = q replaced by

    A phi = W q,        W = diag(w) on the staggered grid,

w = 1 on the time cells and w_a on the faces of space axis a (a wall face
carries 1e6). The cone rows stay on q: z = (1 - q0, b/sqrt2 of the 4d
faces around a cell, 1 + q0) in Q, i.e. q0 + 1/8 sum of the squared faces
<= 0 with q = W^-1 A phi: per cell, phi_t + |grad phi / w|^2 / 2 <= 0, the
Hamilton-Jacobi inequality of the Hamiltonian H(x, p) = |p|^2 / (2 w^2).
Its multiplier alpha of A phi = W q again satisfies A^T alpha = c, so
alpha is the density on the time cells and the momentum m on the faces,
and the continuity equation does not see the weight. The Lagrangian of H
is sup_p (p.v - |p|^2 / (2 w^2)) = w^2 |v|^2 / 2, so the optimum's value is
the weighted kinetic energy of the path, 1/2 of the integral of
w^2 |m|^2 / rho. The program returns as its momentum E = w m on the faces
(``recover_RhoE.m`` folds the weight into alpha), averaged onto the nodes,
and so does this reference (:class:`WSolution`); with that E,
w^2 |m|^2 / rho = |E|^2 / rho. The statement "J the mean of
w^2 |E|^2 / rho" holds with E the momentum m; on the E that the program
returns the weight is already in, and a second w^2 would count it twice.
The checks read

    J_w = mean over the blocks b of sum_a Ebar_a,b^2 / max(rhobar_b, RHO_FLOOR)

with rhobar_b and Ebar_a,b the means over block b's 2^(d+1) nodes (a
pair of neighbours along time and along every space axis: the blocks
over which ``reference.continuity`` reads the staggered values), for
three reasons:

- **Blocks.** rho and E on the nodes are averages of the time cells and
  of the faces, not values the solve has at a node; at the edge of a
  moving support (the love-heart densities are truncated Gaussians, zero
  over most of the box) node averaging puts E of O(1) beside rho near 0.
  Node by node, the reference's own optimum at 129^2 x 129 (residual 1e-6)
  read 14.6 in one time slab and 0.25 in most others; by blocks, 0.25 to
  1.5 (an H100, with the floor below at 1e-3).
- **Vacuum.** A block's mean density counts as at least ``RHO_FLOOR``, a
  hundredth of the mean density (1), which keeps J_w continuous in rho
  where the support ends.
- **The walls.** On a wall face (w = 1e6) the optimum's m is ~1e-6 of its
  neighbours' and w m ~ 0, but a float32 answer holds there w times the
  rounding of alpha: 0.15-0.19 at nodes inside the walls of a float32
  love-heart solve at 33^2 x 9 to tol 1e-3, against 6.5e-6 in float64.
  So E_a is taken as 0 at a node with a wall face (w of at least
  ``WALL``) along a, in the answer and the reference alike: J_w is the
  energy of the path off the walls, and a path that goes through a wall
  is caught by ``wall_mass`` (the share of a time slab's mass inside the
  eroded walls) and by that energy, which leaves out the wall's part of
  a shorter path.

The continuity check is ``reference.continuity`` on E as returned: off
the walls w = 1 and E = m; on them w m ~ 0 at the optimum.

**The solve** is ``reference.py``'s over-relaxed two-block ADMM, (phi, z)
against q, with the weight where the constraint has it:

    phi-step   A^T A phi = A^T W q + (c - A^T alpha) / s1
    q-step     (s1 W^2 + s2 (BF)^T BF) q
                   = W (s1 h1 + alpha) + (BF)^T (beta + s2 h2)
    alpha     += s1 (h1 - W q),    h1 = R A phi + (1 - R) W q_old

((BF)^T BF and W are diagonal, so the q-step stays a division), and the
residuals with W q where the constraint has it. With w = 1 every
operation is the unweighted one, multiplied by 1: the solve is
``reference.solve`` to rounding. It runs coarse to fine as
``reference.solve`` does; a coarser level's face weight is the larger of
the two fine faces it spans (the time nodes and the other axes' nodes
subsampled), so that a wall stays a wall, and the warm start prolongs
the faces' W q, not q (``_warm``). Departures from the paper's
description of its own method (an inexact proximal ALM, inPALM, with
its KKT residuals): this is a plain ADMM with residual balancing, on the
same discrete problem; its stopping residuals are relative primal and
dual residuals of the ADMM, not the paper's KKT battery; its coarse
pyramid subsamples the densities and takes the walls by the maximum,
where the paper restricts in log space and re-validates the densities on
each coarse grid. Only its finest level's optimum is read.

``rounding="tf32"`` stores every iterate in float32 rounded to TF32's 10
mantissa bits, with TF32 matmuls: the control of a float32 cell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import reference
from .reference import (_CHECK_EVERY, _RELAX, _SQRT2, ROUNDINGS, Grid,
                        _proj_cone, _prolong, _zero_state, nodes)

WALL = 1e3          # a face weight of this or more is a wall's
RHO_FLOOR = 1e-2    # a block's mean density counts as at least this in J_w


def _around(faces: list, pick, edge: float) -> list:
    """Per axis, (nt, *space): ``pick`` (torch.minimum or torch.maximum) of
    the two face weights around each node along axis a (the one face at
    the box's edge, ``edge`` standing in for the other)."""
    out = []
    for a, w in enumerate(faces):
        ax = 1 + a
        pad = torch.full_like(w.narrow(ax, 0, 1), edge)
        out.append(pick(torch.cat([pad, w], dim=ax),
                        torch.cat([w, pad], dim=ax)))
    return out


def free_terms(faces: list) -> list:
    """Per axis, (nt, *space): True where neither face around the node
    along a is a wall's (the E_a that J_w reads)."""
    return [m < WALL for m in _around(faces, torch.maximum, -math.inf)]


def wall_nodes(faces: list) -> torch.Tensor:
    """The nodes (space only) whose every face around them is a wall's,
    at the first time node (a weight of the obstacle problems is the same
    at every time node)."""
    walls = None
    for m in _around([w[0:1] for w in faces], torch.minimum, math.inf):
        m = m[0] >= WALL
        walls = m if walls is None else walls & m
    return walls


def erode(mask: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """Binary erosion by the cross of the nearest neighbours, outside the
    box counted as free (``scipy.ndimage.binary_erosion``'s default)."""
    m = mask.bool()
    core = [slice(1, -1)] * m.ndim
    for _ in range(iterations):
        p = torch.nn.functional.pad(m.to(torch.uint8),
                                    (1, 1) * m.ndim).bool()
        out = m.clone()
        for ax in range(m.ndim):
            for lo in (0, 2):
                idx = list(core)
                idx[ax] = slice(lo, lo + m.shape[ax])
                out &= p[tuple(idx)]
        m = out
    return m


@dataclass
class WOptimum:
    """What the checks read of the optimum: the instance's end densities
    (float64), the weighted energy J_ref of the reference's answer
    (:func:`energy`), the E_a that J_w reads and the eroded walls on the
    nodes (both on the checks' device)."""
    rho0: torch.Tensor
    rho1: torch.Tensor
    energy: float
    free: list
    walls: torch.Tensor


def optimum_of(rho0, rho1, faces: list, energy_value: float) -> WOptimum:
    """A :class:`WOptimum` from the instance's ends, its face weights and
    the optimum's energy (a table's, or a solve's)."""
    dev = rho0.device
    faces = [torch.as_tensor(w).to(device=dev, dtype=torch.float64)
             for w in faces]
    return WOptimum(rho0, rho1, float(energy_value), free_terms(faces),
                    erode(wall_nodes(faces)))


@dataclass
class WSolution:
    rho: torch.Tensor        # (nt, *space) on the nodes, float64
    E: list                  # per space axis, w m on the nodes
    iters: list              # per level, coarsest first
    residual: float          # the finest level's last residual
    faces: list              # the finest level's face weights, float64

    def optimum(self) -> WOptimum:
        return optimum_of(self.rho[0], self.rho[-1], self.faces,
                          energy(self.rho, self.E, free_terms(self.faces)))


def _optimum(ref) -> WOptimum:
    """A check's reference: a :class:`WSolution`, or a :class:`WOptimum`
    (a table's)."""
    return ref.optimum() if isinstance(ref, WSolution) else ref


def _block_mean(x: torch.Tensor) -> torch.Tensor:
    """Means over the blocks of 2^ndim neighbouring entries (consecutive
    pairs along every axis)."""
    for ax in range(x.ndim):
        n = x.shape[ax]
        x = 0.5 * (x.narrow(ax, 0, n - 1) + x.narrow(ax, 1, n - 1))
    return x


def energy(rho, Es, free: Optional[list] = None) -> float:
    """J_w of a path on the nodes, E as the program returns it (w m): the
    mean over the blocks of 2^(d+1) neighbouring nodes of
    sum_a Ebar_a^2 / max(rhobar, ``RHO_FLOOR``), E_a taken as 0 outside
    ``free`` (a wall face along the axis; module docstring); ``free``
    None: every node."""
    rho = torch.as_tensor(rho).to(torch.float64)
    num = 0.0
    for a, e in enumerate(Es):
        e = torch.as_tensor(e).to(device=rho.device, dtype=torch.float64)
        if free is not None:
            e = torch.where(free[a].to(rho.device), e, torch.zeros_like(e))
        num = num + _block_mean(e) ** 2
    return float((num / _block_mean(rho).clamp(min=RHO_FLOOR)).mean())


def energy_gap(answer, ref) -> float:
    """|J_w - J_ref| / J_ref of the answer's weighted energy; ``ref`` a
    :class:`WSolution` or a :class:`WOptimum`."""
    rho, Es = answer
    if Es is None:
        raise ValueError("energy_gap needs the answer's momentum")
    opt = _optimum(ref)
    v = abs(energy(torch.as_tensor(rho).to(opt.rho0.device), Es,
                   opt.free) - opt.energy) / opt.energy
    return v if math.isfinite(v) else math.inf


def wall_mass(answer, ref) -> float:
    """The largest share of a time slab's mass inside the eroded walls
    (the nodes all of whose faces are walls, eroded twice): ~0 for a path
    that goes round the obstacle, a large share for one through it."""
    rho, _ = answer
    opt = _optimum(ref)
    rho = torch.as_tensor(rho).to(device=opt.rho0.device,
                                  dtype=torch.float64).abs()
    inside = (rho * opt.walls).sum(dim=tuple(range(1, rho.ndim)))
    total = rho.sum(dim=tuple(range(1, rho.ndim)))
    v = float((inside / total).max())
    return v if math.isfinite(v) else math.inf


def continuity(answer, ref) -> float:
    """``reference.continuity`` on E as returned (w m): w = 1 off the
    walls, and w m ~ 0 on them at the optimum."""
    return reference.continuity(answer, _optimum(ref))


CHECKS = {"continuity": continuity, "energy_gap": energy_gap,
          "wall_mass": wall_mass}


def _coarse_faces(w: torch.Tensor, a: int) -> torch.Tensor:
    """A face block on the next coarser grid: time nodes and the other
    axes' nodes subsampled, the larger of each pair of faces along a."""
    ax = 1 + a
    sl = [slice(None, None, 2)] * w.ndim
    sl[ax] = slice(None)
    w = w[tuple(sl)]
    even = torch.arange(0, w.shape[ax], 2, device=w.device)
    return torch.maximum(w.index_select(ax, even),
                         w.index_select(ax, even + 1))


def _step(g: Grid, c, S: dict, wf: list, wq: list, rnd) -> None:
    """One weighted ADMM iteration on ``S`` in place (``reference._step``
    with W q where the constraint A phi = W q has it; ``wq``: per axis the
    face weight and its square)."""
    d = g.d
    s1, s2 = S["s1"], S["s2"]
    q0, al0 = S["q0"], S["alpha_t"]
    bs = [S[f"b{a}"] for a in range(d)]
    albs = [S[f"alpha{a}"] for a in range(d)]
    bh, bu, bl = S["bh"], S["bu"], S["bl"]
    S["q0_prev"].copy_(q0)
    for a in range(d):
        S[f"b{a}_prev"].copy_(bs[a])
    wbs = [w * b for (w, _), b in zip(wq, bs)]
    # (phi, z) block
    rhs = g.grad_T(q0, wbs) + (c - g.grad_T(al0, albs)) / s1
    phi = rnd(g.poisson(rhs))
    vh = 1.0 - q0 - bh / s2
    vu = g.gather(bs) / _SQRT2 - bu / s2
    vl = 1.0 + q0 - bl / s2
    tail = torch.cat([vu.reshape((-1,) + q0.shape), vl[None]])
    zh, tail = _proj_cone(vh, tail)
    zh = rnd(zh)
    zu = rnd(tail[:-1].reshape(vu.shape))
    zl = rnd(tail[-1])
    # q block, on the over-relaxed (A phi, z - d):
    #   (s1 W^2 + s2 (BF)^T BF) q = W (s1 h1 + alpha) + (BF)^T (beta + s2 h2)
    a0, abs_ = g.grad(phi)
    h0 = _RELAX * a0 + (1.0 - _RELAX) * q0
    hbs = [_RELAX * ab + (1.0 - _RELAX) * wb for ab, wb in zip(abs_, wbs)]
    hh = _RELAX * (zh - 1.0) - (1.0 - _RELAX) * q0
    hu = _RELAX * zu + (1.0 - _RELAX) * g.gather(bs) / _SQRT2
    hl = _RELAX * (zl - 1.0) + (1.0 - _RELAX) * q0
    t0 = (bl + s2 * hl) - (bh + s2 * hh)
    tu = g.scatter((bu + s2 * hu) / _SQRT2)
    q0 = rnd((s1 * h0 + al0 + t0) / (s1 + 2.0 * s2))
    bs = [rnd((w * (s1 * hb + alb) + t) / (s1 * w2 + s2 * f))
          for hb, alb, t, f, (w, w2) in zip(hbs, albs, tu, wf, wq)]
    # multipliers
    gu = g.gather(bs) / _SQRT2
    new = {"phi": phi, "zh": zh, "zu": zu, "zl": zl, "q0": q0,
           "alpha_t": rnd(al0 + s1 * (h0 - q0)),
           "bh": rnd(bh + s2 * (hh + q0)), "bu": rnd(bu + s2 * (hu - gu)),
           "bl": rnd(bl + s2 * (hl - q0))}
    for a in range(d):
        new[f"b{a}"] = bs[a]
        new[f"alpha{a}"] = rnd(albs[a] + s1 * (hbs[a] - wq[a][0] * bs[a]))
    for k, v in new.items():
        S[k].copy_(v)


def _residuals(g: Grid, S: dict, norm_c: float, wq: list):
    """Relative residuals of the last step (``reference._residuals`` with
    W q where the constraint has it)."""
    def nrm(*xs):
        return math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                             for x in xs))

    d = g.d
    q0, bs = S["q0"], [S[f"b{a}"] for a in range(d)]
    wbs = [w * b for (w, _), b in zip(wq, bs)]
    s1, s2 = float(S["s1"]), float(S["s2"])
    dq0 = q0 - S["q0_prev"]
    dbs = [w * (b - S[f"b{a}_prev"])
           for a, ((w, _), b) in enumerate(zip(wq, bs))]
    a0, abs_ = g.grad(S["phi"])
    r_p1 = nrm(a0 - q0, *[ab - wb for ab, wb in zip(abs_, wbs)]) / (
        1.0 + nrm(q0, *wbs))
    r_p2 = nrm(S["zh"] - (1.0 - q0), S["zu"] - g.gather(bs) / _SQRT2,
               S["zl"] - (1.0 + q0)) / (
        1.0 + nrm(S["zh"], S["zu"], S["zl"]))
    r_d1 = s1 * nrm(g.grad_T(dq0, dbs)) / (1.0 + norm_c)
    ubs = [b - S[f"b{a}_prev"] for a, b in enumerate(bs)]
    r_d2 = s2 * nrm(_SQRT2 * dq0, g.gather(ubs) / _SQRT2) / (
        1.0 + nrm(S["bh"], S["bu"], S["bl"]))
    return max(r_p1, r_p2), max(r_d1, r_d2)


def _warm(st: dict, fine: Grid, coarse_faces: list, fine_faces: list):
    """A warm start on ``fine`` from the coarser grid's iterate: the faces'
    W q (at the optimum A phi, no larger on a wall than beside it) is
    prolonged and divided by the fine weight, where prolonging q itself
    would put the O(1) values of free faces on thin walls, 1e6 times the
    constraint's scale. With w = 1 this is ``reference._prolong``."""
    st = dict(st)
    for a, w in enumerate(coarse_faces):
        st[f"b{a}"] = st[f"b{a}"] * w
    out = _prolong(st, fine)
    for a, w in enumerate(fine_faces):
        out[f"b{a}"] = out[f"b{a}"] / w
    return out


def _iterate(g: Grid, c, st: dict, faces: list, tol: float, maxit: int,
             rnd):
    """The weighted ADMM on one grid from ``st`` (``reference._iterate``:
    the same looks, balancing and CUDA graph); returns (state, iterations,
    residual)."""
    check_every = _CHECK_EVERY
    kw = dict(dtype=c.dtype, device=c.device)
    S = {k: v.clone() for k, v in st.items() if isinstance(v, torch.Tensor)}
    S["s1"] = torch.tensor(float(st.get("s1", 1.0)), **kw)
    S["s2"] = torch.tensor(float(st.get("s2", 2.0)), **kw)
    S["q0_prev"] = torch.empty_like(S["q0"])
    for a in range(g.d):
        S[f"b{a}_prev"] = torch.empty_like(S[f"b{a}"])
    norm_c = float(torch.linalg.vector_norm(c))
    wf = [torch.full(S[f"b{a}"].shape, 2.0, **kw) for a in range(g.d)]
    for w in wf:
        w[0] = 1.0
        w[-1] = 1.0
    wq = [(w.to(**kw), (w * w).to(**kw)) for w in faces]

    def block():
        for _ in range(check_every):
            _step(g, c, S, wf, wq, rnd)

    run = block
    if c.is_cuda:
        side = torch.cuda.Stream(c.device)
        side.wait_stream(torch.cuda.current_stream(c.device))
        with torch.cuda.stream(side):
            block()      # warm-up before the capture: real steps
        torch.cuda.current_stream(c.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            block()
        run = graph.replay
    it, res = check_every if c.is_cuda else 0, math.inf
    while it < maxit:
        run()
        it += check_every
        r_p, r_d = _residuals(g, S, norm_c, wq)
        res = max(r_p, r_d)
        if not math.isfinite(res) or res < tol:
            break
        if r_p > 5.0 * r_d:
            S["s1"].mul_(2.0)
            S["s2"].mul_(2.0)
        elif r_d > 5.0 * r_p:
            S["s1"].div_(2.0)
            S["s2"].div_(2.0)
    out = {k: S[k] for k in st if isinstance(st[k], torch.Tensor)}
    out["s1"], out["s2"] = float(S["s1"]), float(S["s2"])
    return out, it, res


def solve(rho0, rho1, nt: int, faces: list, levels: int = 3,
          tol: float = 1e-7, maxit: int = 20000, device="cpu",
          rounding=None, coarse_tol: float = 1e-5) -> WSolution:
    """The reference solve of one weighted instance (module docstring),
    coarse to fine over ``levels`` grids, as ``reference.solve``.
    ``faces[a]``: the finest grid's weight on the faces of space axis a,
    (nt, *space) with n_a - 1 along a (the time cells' weight is 1)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = rounding == "tf32"
    try:
        return _solve(rho0, rho1, nt, faces, levels, tol, maxit, device,
                      rounding, coarse_tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _solve(rho0, rho1, nt, faces, levels, tol, maxit, device, rounding,
           coarse_tol) -> WSolution:
    rnd = ROUNDINGS[rounding]
    dtype = torch.float64 if rounding is None else torch.float32
    kw = dict(dtype=dtype, device=device)
    r0 = torch.as_tensor(rho0).to(device=device, dtype=torch.float64)
    r1 = torch.as_tensor(rho1).to(device=device, dtype=torch.float64)
    ws = [torch.as_tensor(w).to(device=device, dtype=torch.float64)
          for w in faces]
    for a, w in enumerate(ws):
        want = (nt,) + tuple(n - (i == a) for i, n in enumerate(r0.shape))
        if tuple(w.shape) != want:
            raise ValueError(f"face weight {a}: shape {tuple(w.shape)}, "
                             f"expected {want}")
    pyramid = [(nt, r0, r1, ws)]
    for _ in range(levels - 1):
        t, a, b, w = pyramid[-1]
        sl = (slice(None, None, 2),) * a.ndim
        a, b = a[sl], b[sl]
        pyramid.append(((t - 1) // 2 + 1, a / a.mean(), b / b.mean(),
                        [_coarse_faces(x, i) for i, x in enumerate(w)]))
    st, w_prev, iters, res = None, None, [], math.inf
    for k, (t, a, b, w) in enumerate(reversed(pyramid)):
        g = Grid(t, tuple(a.shape), dtype, device)
        c = torch.zeros((t,) + g.space, **kw)
        c[0] = -a.to(dtype) / g.ht
        c[-1] = b.to(dtype) / g.ht
        w = [rnd(x.to(dtype)) for x in w]
        st = _zero_state(g, **kw) if st is None else _warm(st, g, w_prev, w)
        last = k == levels - 1
        st, its, res = _iterate(g, c, st, w, tol if last else coarse_tol,
                                maxit, rnd)
        w_prev = w
        iters.append(its)
    rho_s = st["alpha_t"].to(torch.float64)
    # the momentum as the program returns it: w m (module docstring)
    Ef = [(x * st[f"alpha{a}"]).to(torch.float64) for a, x in enumerate(w)]
    return WSolution(*nodes(rho_s, Ef, r0, r1), iters, res, ws)
