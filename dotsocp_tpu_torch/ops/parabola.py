"""Closed-form projection onto the parabolic set (the reference's legacy
``ProjParab.m`` / ``poly_root.m`` pair); a torch copy of
``dotsocp_tpu/ops/parabola.py``. No solver path runs it: it stays as an
independent cross-check of the cone machinery.

Given rows q = (a, b_1..b_k), returns (a - lambda, b / (1 + lambda)) where
lambda >= 0 is the largest real root of

    x^3 + (8 - a) x^2 + (16 - 8a) x - (16a + 2|b|) = 0

with the constant term as the JAX function writes it. The cubic is solved
in closed form (trigonometric / Cardano), in float64.
"""
from __future__ import annotations

import torch


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root (``jnp.cbrt``)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _largest_real_root_cubic(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d = 0 (elementwise, float64).

    Depressed cubic t^3 + p t + q with x = t - b/3; three real roots by the
    trigonometric method, one by Cardano."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three real roots (disc <= 0): the k = 0 branch is the largest
    safe_p = torch.clamp(p, max=-1e-300)
    m = 2.0 * torch.sqrt(-safe_p / 3.0)
    arg = torch.clamp(3.0 * q / (safe_p * m), -1.0, 1.0)
    t_tri = m * torch.cos(torch.arccos(arg) / 3.0)

    # one real root (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_car = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    return torch.where(disc > 0.0, t_car, t_tri) - b / 3.0


def proj_parab(q: torch.Tensor) -> torch.Tensor:
    """Row-wise projection; q shape (n, 1 + k): columns [a, b...]. Computes
    in float64 and returns ``q``'s dtype, on ``q``'s device."""
    q = torch.as_tensor(q)
    a = q[:, 0].to(torch.float64)
    b = q[:, 1:].to(torch.float64)
    norm_b = torch.linalg.vector_norm(b, dim=1)
    lam = _largest_real_root_cubic(8.0 - a, 16.0 - 8.0 * a,
                                   -16.0 * a - 2.0 * norm_b)
    lam = torch.clamp(lam, min=0.0)
    out = torch.cat([(a - lam)[:, None], b / (1.0 + lam)[:, None]], dim=1)
    return out.to(q.dtype)
