"""Transport objective: the Benamou-Brenier kinetic energy; a numpy copy of
``dotsocp_tpu/utils/objective.py``.

The reference stops on KKT residuals and prints no objective value. This
computes the dynamic-OT energy from a solve's recovered solution

    W2(rho0, rho1)^2 = int_0^1 int_Omega |E(t,x)|^2 / rho(t,x) dx dt

(E = rho*v the recovered momentum, ``recover_RhoE.m``), so a run can be
checked against closed-form optima: for Gaussian marginals
N(m0, s0^2 I) -> N(m1, s1^2 I), W2^2 = |m0 - m1|^2 + d*(s0 - s1)^2.
Densities are unit-mean on the unit box, i.e. unit-mass measures, so the
plain grid mean is the integral. ``solve_dot``'s tensors (on any device)
and numpy arrays are both taken; the sums run in float64 numpy on the
host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def transport_cost(rho, Es: Sequence, vacuum: float = 1e-7) -> float:
    """W2^2 estimate from a solve's recovered (rho, E) fields.

    ``rho``: (nt, *space) densities; ``Es``: per-axis momenta, either on
    the same time grid (``recover_RhoE`` output) or time-staggered
    (nt-1 slabs), in which case rho is averaged onto the slabs.

    ``vacuum``: cells with rho below this (densities are unit-mean, so it
    is a relative threshold) contribute nothing: in the exact optimum
    |E|^2/rho -> 0 with rho, but a solve leaves noise ~tol in E, and
    noise^2 / rho blows up in near-vacuum cells.
    """
    rho = _f64(rho)
    Es = [_f64(E) for E in Es]
    if Es[0].shape[0] == rho.shape[0] - 1:
        rho = 0.5 * (rho[:-1] + rho[1:])
    num = sum(E * E for E in Es)
    dens = np.where(rho > vacuum, rho, np.inf)
    return float((num / dens).mean())


def gaussian_w2_squared(m0, m1, s0: float, s1: float) -> float:
    """Closed-form W2^2 between isotropic Gaussians N(m, s^2 I)."""
    m0 = np.atleast_1d(np.asarray(m0, np.float64))
    m1 = np.atleast_1d(np.asarray(m1, np.float64))
    return float(np.sum((m0 - m1) ** 2) + m0.size * (s0 - s1) ** 2)
