"""dotsocp_tpu_torch — the PyTorch / CUDA port of ``dotsocp_tpu``.

Dynamic optimal transport (Benamou-Brenier, staggered space-time grid)
solved as a second-order cone program by PALM, inPALM, ALG2, acc-ADMM,
sGS-inPALM or acc-sGS-ADMM inside the multilevel coarse-to-fine scheme.
The JAX package ``dotsocp_tpu`` stays the reference; module names here
mirror it one to one, on 1D, 2D and 3D grids. The post-DCT passes of
the inPALM loop, the sGS sweep and the cone projection are hand-written
CUDA kernels for Hopper (``csrc/*.cu``, bound in ``ops/fused_step.py``,
``ops/sgs_sweep.py`` and ``ops/shift.py``); on CPU tensors the same
wrappers run their plain PyTorch versions.

The entry points run on the card (``solve_dot``'s ``device`` defaults to
``"cuda"``) unless the caller asks for the CPU with ``device="cpu"``; they
never fall back to the CPU by themselves.
"""

from .ops.geometry import Geometry
from .ops.staggered import Staggered

__version__ = "0.1.0"

__all__ = ["Geometry", "Staggered", "__version__"]
