"""The plain reference that decides ``correct``: an independent solve of
each checked instance's discrete dynamic-OT problem in float64 PyTorch,
and the numbers that judge the program's answer against it. It imports
nothing of the program, takes only the instance (rho0, rho1, nt) and reads
the program's answer only to judge it.

The discrete problem is the staggered SOCP of DOT-SOCP (Hu, Lin, Sun, Toh):
the potential phi on the nt x n^d nodes, its forward differences q = A phi
(q0 on the nt-1 time cells, b_a on the faces of space axis a, at every time
node), and per cell of (time interval, space node) the Lorentz cone row

    z = (1 - q0, b/sqrt2 of the 4d faces around the cell, 1 + q0) in Q

(q0 + 1/8 sum of the squared faces <= 0, the discrete Hamilton-Jacobi
inequality), maximising <c, phi> with c = -rho0/ht on the first time slab
and rho1/ht on the last (the Kantorovich dual). Its multiplier alpha of
A phi = q is the answer: the density on the time cells and the momentum on
the faces, with A^T alpha = c the discrete continuity equation.

The solve is a two-block ADMM written from that statement: (phi, z) in one
block (a DCT Poisson solve for phi and a cone projection per row for z,
independent of each other) and q in the other (a diagonal solve, since
F^T B^T B F is diagonal), over-relaxed, with the penalties balanced on the
residuals, coarse to fine. Its answer on the nodes is averaged as a solve of the program returns it:
rho[k] the mean of the two time cells around node k (rho0, rho1 at the
ends), each momentum the mean of the two faces around a node along its
axis (0 on the walls), its first and last time slab doubled (half cells).

The checks read of the optimum only the instance's ends and the kinetic
energy of the reference's answer (:class:`Optimum`), so a configuration
may name a table of those energies, made once by
``tabulate_energies.py``, in the place of a solve of each checked
instance.

``rounding="tf32"`` stores every iterate in float32 rounded to TF32's 10
mantissa bits, with TF32 matmuls: the reference computed in the precision
below the configuration's float32 with TF32 off, which the control of a
float32 cell puts in the program's place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_SQRT2 = math.sqrt(2.0)
_RELAX = 1.8        # over-relaxation of the ADMM (1 is plain ADMM)
VACUUM = 1e-7       # nodes of a lower density carry no kinetic energy
_CHECK_EVERY = 25   # ADMM steps between two looks at the residuals


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


ROUNDINGS = {None: lambda x: x, "tf32": _round_tf32}


def _dct_matrix(n: int, **kw) -> torch.Tensor:
    """Orthonormal DCT-II: rows k, columns j, cos(pi k (j + 1/2) / n)."""
    k = torch.arange(n, **kw).reshape(n, 1)
    j = torch.arange(n, **kw).reshape(1, n)
    m = torch.cos(math.pi * k * (j + 0.5) / n) * math.sqrt(2.0 / n)
    m[0] /= _SQRT2
    return m


class Grid:
    """The operators of one grid: nt time nodes, ``space`` nodes per axis
    on the unit box, ``dtype`` on ``device``."""

    def __init__(self, nt: int, space: tuple, dtype, device):
        self.nt, self.space, self.d = nt, tuple(space), len(space)
        self.ht = 1.0 / (nt - 1)
        self.hs = [1.0 / (n - 1) for n in space]
        kw = dict(dtype=torch.float64, device=device)
        sizes = (nt,) + self.space
        steps = (self.ht,) + tuple(self.hs)
        self.dct = [_dct_matrix(n, **kw).to(dtype) for n in sizes]
        eig = 0.0
        for a, (n, h) in enumerate(zip(sizes, steps)):
            lam = (2.0 - 2.0 * torch.cos(math.pi * torch.arange(n, **kw) / n)
                   ) / (h * h)
            shape = [1] * len(sizes)
            shape[a] = n
            eig = eig + lam.reshape(shape)
        eig = eig.clone()
        eig.reshape(-1)[0] = 1.0
        inv = 1.0 / eig
        inv.reshape(-1)[0] = 0.0
        self.inv_eig = inv.to(dtype)

    # --- A = forward differences and its adjoint -------------------------
    def grad(self, phi):
        q0 = torch.diff(phi, dim=0) / self.ht
        bs = [torch.diff(phi, dim=1 + a) / self.hs[a] for a in range(self.d)]
        return q0, bs

    def grad_T(self, q0, bs):
        out = _diff_T(q0, 0, self.ht)
        for a in range(self.d):
            out = out + _diff_T(bs[a], 1 + a, self.hs[a])
        return out

    def poisson(self, rhs):
        """The mean-free solution of A^T A phi = rhs (Neumann Laplacian)."""
        x = rhs
        for a, m in enumerate(self.dct):
            x = torch.movedim(torch.tensordot(m, x, dims=([1], [a])), 0, a)
        x = x * self.inv_eig
        for a, m in enumerate(self.dct):
            x = torch.movedim(torch.tensordot(m.T, x, dims=([1], [a])), 0, a)
        return x

    # --- BF: the 4d faces around each cell, and its adjoint -------------
    def gather(self, bs):
        """(d, 4, nt-1, *space): for axis a, the faces below and above
        each node along a, at the cell's lower and upper time node."""
        rows = []
        for a, b in enumerate(bs):
            ax = 1 + a
            p = _pad(b, ax, 1, 1)
            n = self.space[a]
            lo, hi = p.narrow(ax, 0, n), p.narrow(ax, 1, n)
            rows.append(torch.stack([lo[:-1], hi[:-1], lo[1:], hi[1:]]))
        return torch.stack(rows)

    def scatter(self, u):
        """Adjoint of :meth:`gather`: the face values of (d, 4, ...)."""
        bs = []
        for a in range(self.d):
            ax = 1 + a
            n = self.space[a]
            acc = 0.0
            for k, (t_lo, x_lo) in enumerate(((1, 1), (1, 0), (0, 1),
                                              (0, 0))):
                y = _pad(u[a, k], 0, 1 - t_lo, t_lo)
                y = _pad(y, ax, 1 - x_lo, x_lo)
                acc = acc + y
            bs.append(acc.narrow(ax, 1, n - 1))
        return bs


def _diff_T(u, dim, h):
    return (_pad(u, dim, 1, 0) - _pad(u, dim, 0, 1)) / h


def _pad(x, dim, lo, hi):
    if lo == 0 and hi == 0:
        return x
    shape = list(x.shape)
    parts = []
    if lo:
        shape[dim] = lo
        parts.append(x.new_zeros(shape))
    parts.append(x)
    if hi:
        shape[dim] = hi
        parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim=dim)


def _proj_cone(head, tail):
    """Row-wise projection onto {head >= ||tail||}; tail's leading axis
    holds a row's other entries."""
    nrm = torch.sqrt((tail * tail).sum(dim=0))
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    coef = torch.clamp(0.5 * (1.0 + head / safe), 0.0, 1.0)
    return torch.maximum(head, coef * nrm), coef * tail


@dataclass
class Optimum:
    """What the checks read of the optimum: the instance's end densities
    (float64, on the device the checks run on) and the kinetic energy of
    the reference's answer, J_ref (:func:`energy`)."""
    rho0: torch.Tensor
    rho1: torch.Tensor
    energy: float


@dataclass
class Solution:
    rho: torch.Tensor        # (nt, *space) on the nodes, float64
    E: list                  # per space axis, (nt, *space) on the nodes
    iters: list              # per level, coarsest first
    residual: float          # the finest level's last residual

    def optimum(self) -> Optimum:
        return Optimum(self.rho[0], self.rho[-1], energy(self.rho, self.E))


def _optimum(ref) -> Optimum:
    """A check's reference: a :class:`Solution`, or an :class:`Optimum`
    read from a table."""
    return ref.optimum() if isinstance(ref, Solution) else ref


def _zero_state(g: Grid, **kw) -> dict:
    """A cold start: every field 0 but the cone rows' constant parts.
    The cone rows: head 1 - q0, tail (faces / sqrt2 as (d, 4, ...), 1 + q0)."""
    cells = (g.nt - 1,) + g.space
    st = {"phi": torch.zeros((g.nt,) + g.space, **kw),
          "q0": torch.zeros(cells, **kw), "alpha_t": torch.zeros(cells, **kw),
          "zh": torch.ones(cells, **kw), "zl": torch.ones(cells, **kw),
          "bh": torch.zeros(cells, **kw), "bl": torch.zeros(cells, **kw),
          "zu": torch.zeros((g.d, 4) + cells, **kw),
          "bu": torch.zeros((g.d, 4) + cells, **kw)}
    for a in range(g.d):
        st[f"b{a}"] = torch.zeros(_face_shape(g.nt, g.space, a), **kw)
        st[f"alpha{a}"] = torch.zeros_like(st[f"b{a}"])
    return st


def _kinds(name: str, d: int) -> str:
    """Per axis (time, then space) of a field: 'n' on nodes, 'c' between
    them (time cells, faces)."""
    if name == "phi":
        return "n" * (1 + d)
    if name.rstrip("0123456789") in ("b", "alpha"):
        a = int(name[-1])
        return "n" + "".join("c" if i == a else "n" for i in range(d))
    return "c" + "n" * d


def _interp_axis(x, axis: int, kind: str, n_fine: int):
    """Linear interpolation along ``axis`` onto the grid of ``n_fine``
    nodes on [0, 1] (its n_fine - 1 midpoints for kind 'c')."""
    m = x.shape[axis]
    kw = dict(dtype=torch.float64, device=x.device)
    if kind == "n":
        xs = torch.arange(m, **kw) / (m - 1)
        xf = torch.arange(n_fine, **kw) / (n_fine - 1)
    else:
        xs = (torch.arange(m, **kw) + 0.5) / m
        xf = (torch.arange(n_fine - 1, **kw) + 0.5) / (n_fine - 1)
    idx = torch.clamp(torch.searchsorted(xs, xf) - 1, 0, m - 2)
    w = torch.clamp((xf - xs[idx]) / (xs[idx + 1] - xs[idx]), 0.0, 1.0)
    shape = [1] * x.ndim
    shape[axis] = -1
    w = w.to(x.dtype).reshape(shape)
    return (x.index_select(axis, idx) * (1.0 - w)
            + x.index_select(axis, idx + 1) * w)


def _prolong(st: dict, fine: Grid) -> dict:
    """A warm start on ``fine`` from a coarser grid's iterate."""
    sizes = (fine.nt,) + fine.space
    out = {}
    for name, x in st.items():
        if not isinstance(x, torch.Tensor):
            out[name] = x
            continue
        kinds = _kinds(name, fine.d)
        lead = x.ndim - len(kinds)
        for i, (k, n) in enumerate(zip(kinds, sizes)):
            x = _interp_axis(x, lead + i, k, n)
        out[name] = x
    return out


def _step(g: Grid, c, S: dict, wf: list, rnd) -> None:
    """One ADMM iteration on the state ``S`` in place (``s1`` and ``s2``,
    the penalties, are 0-d tensors there, so that a captured graph of
    steps reads their current values)."""
    d = g.d
    s1, s2 = S["s1"], S["s2"]
    q0, al0 = S["q0"], S["alpha_t"]
    bs = [S[f"b{a}"] for a in range(d)]
    albs = [S[f"alpha{a}"] for a in range(d)]
    bh, bu, bl = S["bh"], S["bu"], S["bl"]
    S["q0_prev"].copy_(q0)
    for a in range(d):
        S[f"b{a}_prev"].copy_(bs[a])
    # (phi, z) block
    rhs = g.grad_T(q0, bs) + (c - g.grad_T(al0, albs)) / s1
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
    #   (s1 I + s2 (BF)^T BF) q = s1 h1 + alpha + (BF)^T (beta + s2 h2)
    a0, abs_ = g.grad(phi)
    h0 = _RELAX * a0 + (1.0 - _RELAX) * q0
    hbs = [_RELAX * ab + (1.0 - _RELAX) * b for ab, b in zip(abs_, bs)]
    hh = _RELAX * (zh - 1.0) - (1.0 - _RELAX) * q0
    hu = _RELAX * zu + (1.0 - _RELAX) * g.gather(bs) / _SQRT2
    hl = _RELAX * (zl - 1.0) + (1.0 - _RELAX) * q0
    t0 = (bl + s2 * hl) - (bh + s2 * hh)
    tu = g.scatter((bu + s2 * hu) / _SQRT2)
    q0 = rnd((s1 * h0 + al0 + t0) / (s1 + 2.0 * s2))
    bs = [rnd((s1 * hb + alb + t) / (s1 + s2 * w))
          for hb, alb, t, w in zip(hbs, albs, tu, wf)]
    # multipliers
    gu = g.gather(bs) / _SQRT2
    new = {"phi": phi, "zh": zh, "zu": zu, "zl": zl, "q0": q0,
           "alpha_t": rnd(al0 + s1 * (h0 - q0)),
           "bh": rnd(bh + s2 * (hh + q0)), "bu": rnd(bu + s2 * (hu - gu)),
           "bl": rnd(bl + s2 * (hl - q0))}
    for a in range(d):
        new[f"b{a}"] = bs[a]
        new[f"alpha{a}"] = rnd(albs[a] + s1 * (hbs[a] - bs[a]))
    for k, v in new.items():
        S[k].copy_(v)


def _residuals(g: Grid, S: dict, norm_c: float):
    """Relative residuals of the last step: primal (both constraints) and
    dual (the change of q through each constraint)."""
    def nrm(*xs):
        return math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                             for x in xs))

    d = g.d
    q0, bs = S["q0"], [S[f"b{a}"] for a in range(d)]
    s1, s2 = float(S["s1"]), float(S["s2"])
    dq0 = q0 - S["q0_prev"]
    dbs = [b - S[f"b{a}_prev"] for a, b in enumerate(bs)]
    a0, abs_ = g.grad(S["phi"])
    r_p1 = nrm(a0 - q0, *[ab - b for ab, b in zip(abs_, bs)]) / (
        1.0 + nrm(q0, *bs))
    r_p2 = nrm(S["zh"] - (1.0 - q0), S["zu"] - g.gather(bs) / _SQRT2,
               S["zl"] - (1.0 + q0)) / (
        1.0 + nrm(S["zh"], S["zu"], S["zl"]))
    r_d1 = s1 * nrm(g.grad_T(dq0, dbs)) / (1.0 + norm_c)
    r_d2 = s2 * nrm(_SQRT2 * dq0, g.gather(dbs) / _SQRT2) / (
        1.0 + nrm(S["bh"], S["bu"], S["bl"]))
    return max(r_p1, r_p2), max(r_d1, r_d2)


def _iterate(g: Grid, c, st: dict, tol: float, maxit: int, rnd):
    """ADMM on one grid from ``st`` until the relative residuals fall
    under ``tol``, ``_CHECK_EVERY`` steps between two looks (on a card, the
    steps between two looks are one captured CUDA graph); returns
    (state, iterations, residual)."""
    check_every = _CHECK_EVERY
    kw = dict(dtype=c.dtype, device=c.device)
    S = {k: v.clone() for k, v in st.items() if isinstance(v, torch.Tensor)}
    S["s1"] = torch.tensor(float(st.get("s1", 1.0)), **kw)
    S["s2"] = torch.tensor(float(st.get("s2", 2.0)), **kw)
    S["q0_prev"] = torch.empty_like(S["q0"])
    for a in range(g.d):
        S[f"b{a}_prev"] = torch.empty_like(S[f"b{a}"])
    norm_c = float(torch.linalg.vector_norm(c))
    # diagonal of (BF)^T BF: 2 on q0 and on the faces, 1 on the faces of
    # the first and last time node
    wf = [torch.full(S[f"b{a}"].shape, 2.0, **kw) for a in range(g.d)]
    for w in wf:
        w[0] = 1.0
        w[-1] = 1.0

    def block():
        for _ in range(check_every):
            _step(g, c, S, wf, rnd)

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
        r_p, r_d = _residuals(g, S, norm_c)
        res = max(r_p, r_d)
        if not math.isfinite(res) or res < tol:
            break
        # residual balancing of both penalties
        if r_p > 5.0 * r_d:
            S["s1"].mul_(2.0)
            S["s2"].mul_(2.0)
        elif r_d > 5.0 * r_p:
            S["s1"].div_(2.0)
            S["s2"].div_(2.0)
    out = {k: S[k] for k in st if isinstance(st[k], torch.Tensor)}
    out["s1"], out["s2"] = float(S["s1"]), float(S["s2"])
    return out, it, res


def solve(rho0, rho1, nt: int, levels: int = 3, tol: float = 1e-7,
          maxit: int = 20000, device="cpu", rounding=None,
          coarse_tol: float = 1e-5) -> Solution:
    """The reference solve of one instance (module docstring), coarse to
    fine over ``levels`` grids (every other node dropped a level, the
    densities' means kept at 1), each level warm from the one below.
    ``tol`` bounds the finest level's relative primal and dual residuals
    (``coarse_tol`` the coarser ones'), each level stopping at ``maxit``
    iterations at the most."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = rounding == "tf32"
    try:
        return _solve(rho0, rho1, nt, levels, tol, maxit, device, rounding,
                      coarse_tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _solve(rho0, rho1, nt, levels, tol, maxit, device, rounding,
           coarse_tol) -> Solution:
    rnd = ROUNDINGS[rounding]
    dtype = torch.float64 if rounding is None else torch.float32
    kw = dict(dtype=dtype, device=device)
    r0 = torch.as_tensor(rho0).to(device=device, dtype=torch.float64)
    r1 = torch.as_tensor(rho1).to(device=device, dtype=torch.float64)
    pyramid = [(nt, r0, r1)]
    for _ in range(levels - 1):
        t, a, b = pyramid[-1]
        sl = (slice(None, None, 2),) * a.ndim
        a, b = a[sl], b[sl]
        pyramid.append(((t - 1) // 2 + 1, a / a.mean(), b / b.mean()))
    st, iters, res = None, [], math.inf
    for k, (t, a, b) in enumerate(reversed(pyramid)):
        g = Grid(t, tuple(a.shape), dtype, device)
        c = torch.zeros((t,) + g.space, **kw)
        c[0] = -a.to(dtype) / g.ht
        c[-1] = b.to(dtype) / g.ht
        st = _zero_state(g, **kw) if st is None else _prolong(st, g)
        last = k == levels - 1
        st, its, res = _iterate(g, c, st, tol if last else coarse_tol,
                                maxit, rnd)
        iters.append(its)
    rho_s = st["alpha_t"].to(torch.float64)
    Ef = [st[f"alpha{a}"].to(torch.float64) for a in range(g.d)]
    return Solution(*nodes(rho_s, Ef, r0, r1), iters, res)


def _face_shape(nt, space, a):
    return (nt,) + tuple(n - 1 if i == a else n for i, n in enumerate(space))


def nodes(rho_s, Ef, rho0, rho1):
    """(rho, [E_a]) on the nodes from the time-cell density and the face
    momenta (module docstring)."""
    rho = torch.cat([rho0[None], 0.5 * (rho_s[:-1] + rho_s[1:]),
                     rho1[None]])
    Es = []
    for a, b in enumerate(Ef):
        b = b.clone()
        b[0] *= 2.0
        b[-1] *= 2.0
        ax = 1 + a
        n = b.shape[ax]
        mid = 0.5 * (b.narrow(ax, 0, n - 1) + b.narrow(ax, 1, n - 1))
        Es.append(_pad(mid, ax, 1, 1))
    return rho, Es


def energy(rho, Es) -> float:
    """The kinetic energy of a path on the nodes, mean of |E|^2 / rho over
    the nodes whose density passes ``VACUUM``."""
    rho = torch.as_tensor(rho).to(torch.float64)
    num = sum(torch.as_tensor(e).to(device=rho.device, dtype=torch.float64)
              ** 2 for e in Es)
    den = torch.where(rho > VACUUM, rho, torch.full_like(rho, math.inf))
    return float((num / den).mean())


def energy_gap(answer, ref) -> float:
    """|J - J_ref| / J_ref of the answer's kinetic energy J: first order in
    an answer that is off the optimum or off the constraints, second order
    in one that is near the reference's. ``ref``: a Solution or an
    Optimum."""
    rho, Es = answer
    if Es is None:
        raise ValueError("energy_gap needs the answer's momentum")
    opt = _optimum(ref)
    j_ref = opt.energy
    v = abs(energy(torch.as_tensor(rho).to(opt.rho0.device), Es) - j_ref)
    v /= j_ref
    return v if math.isfinite(v) else math.inf


def _pair_sum(x: torch.Tensor, axis: int, w=None) -> torch.Tensor:
    """x[b] w[b, 0] + x[b+1] w[b, 1] along ``axis`` (unit weights if w is
    None): one value a block of two neighbours."""
    n = x.shape[axis]
    lo, hi = x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)
    if w is None:
        return lo + hi
    shape = [1] * x.ndim
    shape[axis] = n - 1
    return lo * w[:, 0].reshape(shape) + hi * w[:, 1].reshape(shape)


def continuity(answer, ref) -> float:
    """Relative block residual of the discrete continuity equation of the
    answer (rho, Es) between the given densities (the reference's ends;
    ``ref`` a Solution or an Optimum).

    rho and E are averages of the time-cell densities and the face momenta
    (module docstring), so the equation is not readable node by node; summed
    over the 2^(d+1) nodes of a block of neighbours (weight 2 on a space
    wall's node, whose half face has no flux) the staggered values cancel:

        R = sum_space w 2 (rho[k+1] - rho[k]) / ht
            + sum_a sum_time sum_other w 2 (E_a[.., j+1] - E_a[.., j]) / h_a

    for every block. Returns ||R|| over the same block sums of
    2 (|rho[k+1]| + |rho[k]|) / ht: 0 for an exact solve, a fraction of the
    primal KKT residual for one solved to a tolerance."""
    rho, Es = answer
    if Es is None:
        raise ValueError("continuity needs the answer's momentum")
    opt = _optimum(ref)
    dev = opt.rho0.device
    rho = torch.as_tensor(rho).to(device=dev, dtype=torch.float64).clone()
    rho[0], rho[-1] = opt.rho0, opt.rho1
    nt, space = rho.shape[0], tuple(rho.shape[1:])
    if len(Es) != len(space):
        raise ValueError(f"{len(Es)} momentum fields for {len(space)} axes")
    ws = []
    for n in space:
        w = torch.ones((n - 1, 2), dtype=torch.float64, device=dev)
        w[0, 0] = w[-1, 1] = 2.0
        ws.append(w)
    t_part = 2.0 * (nt - 1) * torch.diff(rho, dim=0)
    scale = 2.0 * (nt - 1) * (rho[1:].abs() + rho[:-1].abs())
    for a in range(len(space)):
        t_part = _pair_sum(t_part, 1 + a, ws[a])
        scale = _pair_sum(scale, 1 + a, ws[a])
    f_part = torch.zeros_like(t_part)
    for a, E in enumerate(Es):
        E = torch.as_tensor(E).to(device=dev, dtype=torch.float64)
        flux = _pair_sum(2.0 * (space[a] - 1) * torch.diff(E, dim=1 + a), 0)
        for b in range(len(space)):
            if b != a:
                flux = _pair_sum(flux, 1 + b, ws[b])
        f_part += flux
    norm = float(torch.linalg.vector_norm(scale))
    v = float(torch.linalg.vector_norm(t_part + f_part)) / norm
    return v if math.isfinite(v) else math.inf


CHECKS = {"continuity": continuity, "energy_gap": energy_gap}


def check(name: str, answer, ref) -> float:
    """The number that check ``name`` reads from one answer (rho, Es)
    against ``ref`` (a Solution or an Optimum)."""
    if name not in CHECKS:
        raise KeyError(f"no reference check {name!r}; known: {sorted(CHECKS)}")
    return CHECKS[name](answer, ref)
