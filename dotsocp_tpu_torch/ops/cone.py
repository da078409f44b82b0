"""Lorentz-cone projection (``mexProjSoc``); port of
``dotsocp_tpu/ops/cone.py:99-115``.

The BF gather, its adjoint and the q-diagonal live on the flat engine
(``ops/engine.py:OpsFlat``), which every algorithm of the port runs on.
"""
from __future__ import annotations

import torch


def proj_soc(v: torch.Tensor) -> torch.Tensor:
    """Row-wise projection onto K = {z: z[0] >= ||z[1:]||} over axis 0.

    Branch-free: coef = clip((1 + z0/||w||)/2, 0, 1); head = max(z0,
    coef*||w||) covers the interior, boundary-projection and zero cases,
    with the ``nrm > 0`` guard exactly as in the JAX version."""
    z0 = v[0]
    w = v[1:]
    nrm = torch.sqrt(torch.sum(w * w, dim=0))
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    coef = torch.clamp(0.5 * (1.0 + z0 / safe), 0.0, 1.0)
    head = torch.maximum(z0, coef * nrm)
    return torch.cat([head[None], coef[None] * w], dim=0)
