"""dotsocp_tpu_torch — the PyTorch / CUDA port of ``dotsocp_tpu``.

Dynamic optimal transport (Benamou-Brenier, staggered space-time grid)
solved as a second-order cone program by PALM, inPALM, ALG2, acc-ADMM,
sGS-inPALM or acc-sGS-ADMM inside the multilevel coarse-to-fine scheme.
The JAX package ``dotsocp_tpu`` stays the reference; module names here
mirror it one to one, on 1D, 2D and 3D grids. The post-DCT passes of
the inPALM loop, the sGS sweep and the cone projection are hand-written
CUDA kernels for Hopper (``csrc/*.cu``, bound in ``ops/fused_step.py``,
``ops/sgs_sweep.py`` and ``ops/shift.py``); on CPU tensors the same
wrappers run their plain PyTorch versions. Each level's loop runs on the
device driver (``algorithms/device_driver.py``, ``device_sgs.py``: the
decision state on the card, event-free pieces replayed from CUDA graphs,
``algorithms/graphs.py``) or, with ``opts={"driver": "host"}``, on the
host driver (``algorithms/driver.py``), by the JAX package's rule.
Fleets of same-shaped instances go through ``solve_fleet`` /
``solve_batch`` (``parallel/batch.py``): one instance after another, or
all in lockstep on the batched forms of the x-carry kernels.

The entry points run on the card (``solve_dot``'s ``device`` defaults to
``"cuda"``) unless the caller asks for the CPU with ``device="cpu"``; they
never fall back to the CPU by themselves.
"""

import torch

from .ops.geometry import Geometry
from .ops.staggered import Staggered
from .parallel.batch import pick_fleet_mode, solve_batch, solve_fleet

__version__ = "0.1.0"


def w2_distance(rho0, rho1, nt: int = 33, level_n: int = 3,
                opts: dict | None = None, method: str = "inPALM",
                dtype: torch.dtype = torch.float32,
                return_solution: bool = False, *, device="cuda"):
    """The Wasserstein-2 distance between two 1-D or 2-D densities on the
    unit interval / box; port of ``dotsocp_tpu/__init__.py:18-50``.

    Runs :func:`multilevel.solve.solve_dot` (the reference demo's defaults)
    on ``device`` and evaluates the Benamou-Brenier kinetic energy of the
    recovered (rho, E) fields (:func:`utils.objective.transport_cost`).
    The densities are normalized to unit mean (= unit mass); one whose mean
    is not finite and positive raises ValueError (the JAX function divides
    by it unchecked). Returns W2 (not squared); ``return_solution=True``
    also returns the solver's output dict."""
    import math

    import numpy as np

    from .multilevel.solve import solve_dot
    from .utils.objective import transport_cost

    r0 = np.asarray(rho0, np.float64)
    r1 = np.asarray(rho1, np.float64)
    if r0.ndim not in (1, 2) or r1.shape != r0.shape:
        raise ValueError(f"w2_distance takes two 1-D or 2-D densities of one "
                         f"shape, not {r0.shape} and {r1.shape}")
    for name, r in (("rho0", r0), ("rho1", r1)):
        mean = r.mean()
        if not (math.isfinite(mean) and mean > 0.0):
            raise ValueError(f"{name} has mean {mean}: a density needs a "
                             f"finite, positive mass")
    out, _, _ = solve_dot(r0 / r0.mean(), r1 / r1.mean(), nt, level_n,
                          dict(opts or {}), method, device=device,
                          dtype=dtype, verbose=False)
    Es = [out["Ex"]] if r0.ndim == 1 else [out["Ey"], out["Ex"]]
    w2 = math.sqrt(max(transport_cost(out["rho"], Es), 0.0))
    return (w2, out) if return_solution else w2


__all__ = ["Geometry", "Staggered", "pick_fleet_mode", "solve_batch",
           "solve_fleet", "w2_distance", "__version__"]
