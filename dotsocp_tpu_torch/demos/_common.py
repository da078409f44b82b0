"""What the demos share: the device and dtype flags and the report."""
from __future__ import annotations

import numpy as np
import torch


def add_device_flags(ap, f64_default: bool = False) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card; without one "
                         "the demo raises)")
    ap.add_argument("--f64", action="store_true", default=f64_default,
                    help="run in float64")


def device_of(args) -> str:
    return "cpu" if args.cpu else "cuda"


def dtype_of(args) -> torch.dtype:
    return torch.float64 if args.f64 else torch.float32


def report(out, hist, Es=None) -> None:
    """The JAX demos' summary: mass conservation, the per-slab masses, the
    final KKT row and, with ``Es``, the Benamou-Brenier energy."""
    from ..multilevel.level import check_mass_conservation
    from ..utils.objective import transport_cost

    print("=" * 64)
    print(f"Mass conservation: {'OK' if out['mass_ok'] else 'VIOLATED'}")
    check_mass_conservation(out["rho"].detach().cpu(), verbose=True)
    print("Final KKT:", np.asarray(hist["kkt"][-1]))
    if Es is not None:
        print(f"W2^2 (Benamou-Brenier energy): "
              f"{transport_cost(out['rho'], Es):.6f}")
