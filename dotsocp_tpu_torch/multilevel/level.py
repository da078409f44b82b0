"""Per-level problem setup, initial scaling, and solution recovery; port of
``dotsocp_tpu/multilevel/level.py``.

Replaces the reference's ``initialize.m`` + the ``InitialScaling`` /
``recoverOrgVar`` closures of ``solver_dotsocp2d.m:304-386`` (1-D deltas at
``solver_dotsocp1d.m:263-317``, weighted at ``solver_wdotsocp2d.m:296-360``).
Level variables are shaped tensors on the
caller's device; the solver's ``prep`` converts them to the flat layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from ..utils.norms import norm_l2


@dataclasses.dataclass
class LevelVar:
    """One level's variables + model data (the reference's var/model pair)."""

    geom: Geometry
    rho0: torch.Tensor
    rho1: torch.Tensor
    c: torch.Tensor
    phi: torch.Tensor
    q: Staggered
    z: torch.Tensor
    alpha: Staggered
    beta: torch.Tensor
    weight: Optional[Staggered] = None  # shaped; None when unweighted
    # scaling factors (set by initial_scaling)
    D: float = 1.0
    E: float = 1.0
    cScale: float = 1.0
    dScale: float = 1.0
    E2: float = math.sqrt(2.0)
    norm_c: float = 0.0
    norm_d: float = math.sqrt(2.0)

    def as_dict(self):
        return {
            "phi": self.phi, "q": self.q, "z": self.z, "alpha": self.alpha,
            "beta": self.beta, "c": self.c, "cScale": self.cScale,
            "dScale": self.dScale, "norm_c": self.norm_c,
            "norm_d": self.norm_d, "D": self.D, "E": self.E,
        }


def make_c(geom: Geometry, rho0: torch.Tensor, rho1: torch.Tensor):
    """The linear term: -rho0/ht on the first time slab, rho1/ht on the
    last, zero between (``initialize.m``)."""
    c = torch.zeros(geom.phi_shape, dtype=rho0.dtype, device=rho0.device)
    c[0] = -rho0 / geom.ht
    c[-1] = rho1 / geom.ht
    return c


def zeros_staggered(geom: Geometry, dtype, device) -> Staggered:
    kw = dict(dtype=dtype, device=device)
    return Staggered(
        q0=torch.zeros(geom.q0_shape, **kw),
        bs=tuple(torch.zeros(geom.b_shape(a), **kw)
                 for a in range(geom.ndim_space)))


def initialize(rho0, rho1, nt: int, dtype: torch.dtype, device,
               weight: Optional[Staggered] = None) -> LevelVar:
    """Model (c) and initial variables (``initialize.m``):
    phi = sum_a x_a^2 / 2 replicated over t; z, beta, q, alpha zero.
    ``weight`` (shaped, the level's grid) makes the level weighted."""
    rho0 = torch.as_tensor(rho0, device=device).to(dtype)
    rho1 = torch.as_tensor(rho1, device=device).to(dtype)
    space = tuple(rho0.shape)
    geom = Geometry(nt=nt, space=space)
    kw = dict(dtype=dtype, device=device)

    # phi0 = (1/2) * sum of squared coordinates (``initialize.m:48-50``),
    # built in numpy exactly as the JAX package does
    npdtype = np.float64 if dtype == torch.float64 else np.float32
    phi_sp = np.zeros(space, npdtype)
    for a, n in enumerate(space):
        x = np.linspace(0.0, 1.0, n, dtype=npdtype)
        shape = [1] * len(space)
        shape[a] = n
        phi_sp = phi_sp + 0.5 * x.reshape(shape) ** 2
    phi = torch.as_tensor(phi_sp, **kw).expand(geom.phi_shape).contiguous()

    return LevelVar(
        geom=geom, rho0=rho0, rho1=rho1, c=make_c(geom, rho0, rho1), phi=phi,
        q=zeros_staggered(geom, dtype, device),
        z=torch.zeros(geom.z_shape, **kw),
        alpha=zeros_staggered(geom, dtype, device),
        beta=torch.zeros(geom.z_shape, **kw),
        weight=weight,
    )


def update_e2(prev_e2: Optional[float], last_kkt,
              weighted: bool = False) -> float:
    """E2 feedback from the previous level's final KKT
    (``solver_dotsocp2d.m:308-318``; weighted: safeguard [0.25, 4],
    ``solver_wdotsocp2d.m:300-305``)."""
    if last_kkt is None or prev_e2 is None:
        return math.sqrt(2.0)
    ratio = math.sqrt(max(last_kkt[0], 1e-300) / max(last_kkt[1], 1e-300))
    if weighted:
        return prev_e2 * min(4.0, max(0.25, ratio))
    lower = 0.8333
    if ratio < lower:
        return prev_e2 * max(1.0 / math.sqrt(2.0), ratio / lower)
    return prev_e2 * min(math.sqrt(2.0), max(1.0, ratio))


def initial_scaling(lv: LevelVar, scaling: bool, last_kkt=None,
                    prev_e2: Optional[float] = None) -> None:
    """Scale (c, phi, q, z, alpha, beta) and set (D, E, cScale, dScale)
    in place (``solver_dotsocp2d.m:304-365``)."""
    geom = lv.geom
    h = geom.h
    h_mean = geom.h_mean
    lv.E2 = update_e2(prev_e2, last_kkt, lv.weight is not None)
    norm_c0 = float(norm_l2(lv.c, h))

    if not scaling:
        lv.cScale = lv.dScale = lv.D = lv.E = 1.0
        lv.norm_c = norm_c0
        lv.norm_d = math.sqrt(2.0)
        return

    norm_c = norm_c0 * math.sqrt(geom.nt)
    norm_d = math.sqrt(2.0)
    if lv.weight is not None:
        adjust = weight_adjust(lv.weight)
        D = math.sqrt(2.0) * math.sqrt(h_mean) * adjust
        E = D / lv.E2
        c_scale = max(1.0, norm_c * math.sqrt(h_mean) / adjust)
        d_scale = E * norm_d * math.sqrt(adjust)
    else:
        D = math.sqrt(2.0) * math.sqrt(h_mean)
        E = D / lv.E2
        c_scale = max(1.0, norm_c * math.sqrt(h_mean))
        d_scale = E * norm_d

    lv.norm_c = norm_c / c_scale
    lv.norm_d = norm_d * E / d_scale
    # c and phi are divided, the rest multiplied (``solver_dotsocp2d.m:330-339``)
    lv.c = lv.c / c_scale
    lv.phi = lv.phi / d_scale
    lv.q = lv.q * (D / d_scale)
    lv.z = lv.z * (E / d_scale)
    lv.alpha = lv.alpha * (1.0 / (c_scale * D))
    lv.beta = lv.beta * (1.0 / (c_scale * E))
    lv.D, lv.E, lv.cScale, lv.dScale = D, E, c_scale, d_scale


def weight_adjust(weight: Staggered) -> float:
    """Geometric mean of the weight, 10^mean(log10(w + 1e-10))
    (``solver_wdotsocp2d.m:310-316``). Summed in host numpy in the weight's
    dtype, block by block, as the JAX package sums it, so D and E come out
    the same to the last bit."""
    logs = [np.log10(b.cpu().numpy() + 1e-10) for b in weight.blocks()]
    total = sum(float(x.sum()) for x in logs)
    count = sum(x.size for x in logs)
    return 10.0 ** (total / count)


def recover_org_var(lv: LevelVar, out: dict) -> None:
    """Undo the initial scaling on the solver's outputs in place
    (``solver_dotsocp2d.m:368-386``); ``out`` is the finalized var dict with
    possibly grown cScale/dScale from dynamic rescaling."""
    c_scale = float(out["cScale"])
    d_scale = float(out["dScale"])
    D, E = lv.D, lv.E
    lv.phi = out["phi"] * d_scale
    lv.z = out["z"] * (d_scale / E)
    lv.q = out["q"] * (d_scale / D)
    lv.alpha = out["alpha"] * (c_scale * D)
    lv.beta = out["beta"] * (c_scale * E)
    lv.cScale, lv.dScale = c_scale, d_scale


def _mid_pad(b: torch.Tensor, ax: int) -> torch.Tensor:
    """Average neighbouring faces along ``ax`` onto cell centres, with a
    zero cell at both ends."""
    n = b.shape[ax]
    mid = 0.5 * (b.narrow(ax, 0, n - 1) + b.narrow(ax, 1, n - 1))
    pad = [0, 0] * b.ndim
    pad[2 * (b.ndim - 1 - ax)] = 1
    pad[2 * (b.ndim - 1 - ax) + 1] = 1
    return torch.nn.functional.pad(mid, pad)


def recover_rho_e(lv: LevelVar):
    """(rho, E_1..E_d) from the multiplier alpha (``recover_RhoE.m``): the
    q0-block is the density on time-staggered cells, the face blocks are
    the momentum. A weighted level folds the weight in first: w * alpha."""
    alpha = lv.alpha if lv.weight is None else lv.weight * lv.alpha
    rho_mid = alpha.q0
    rho = torch.cat([lv.rho0[None], 0.5 * (rho_mid[:-1] + rho_mid[1:]),
                     lv.rho1[None]], dim=0)
    Es = []
    for a, b in enumerate(alpha.bs):
        b = b.clone()
        b[0] *= 2.0   # double the boundary time slabs (half-cells)
        b[-1] *= 2.0
        Es.append(_mid_pad(b, 1 + a))
    return rho, Es


def recover_q_centered(lv: LevelVar):
    """(q0, b_1..b_d) on the cell-centred / time-staggered grid
    (``recover_q.m``)."""
    bs = []
    for a, b in enumerate(lv.q.bs):
        b_cc = _mid_pad(b, 1 + a)
        bs.append(0.5 * (b_cc[:-1] + b_cc[1:]))
    return lv.q.q0, bs


def mass_error(rho: torch.Tensor) -> float:
    """max over time slabs of |int rho - 1| and |int rho_-|
    (``check_massConservation.m``)."""
    axes = tuple(range(1, rho.ndim))
    n = math.prod(rho.shape[1:])
    mass = rho.sum(dim=axes) / n
    neg = torch.where(rho < 0, rho, torch.zeros_like(rho)).sum(dim=axes) / n
    return float(torch.maximum((mass - 1.0).abs().max(), neg.abs().max()))


def check_mass_conservation(rho, tol: float = 1e-2,
                            verbose: bool = False) -> bool:
    """Per-time-slab mass and negative-mass check: error <= tol."""
    rho = torch.as_tensor(rho)
    if verbose:
        axes = tuple(range(1, rho.ndim))
        n = math.prod(rho.shape[1:])
        print("Total mass per time slab:", (rho.sum(dim=axes) / n).tolist())
    return mass_error(rho) <= tol


def recover_solution(lv: LevelVar, tol: float = 1e-2):
    """(rho, E, q0, b) + the mass-conservation check
    (``recover_RhoE.m``/``recover_q.m``/``check_massConservation.m``)."""
    rho, Es = recover_rho_e(lv)
    q0, bs = recover_q_centered(lv)
    return rho, Es, q0, bs, mass_error(rho) <= tol
