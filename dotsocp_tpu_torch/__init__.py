"""dotsocp_tpu_torch — the PyTorch / CUDA port of ``dotsocp_tpu``.

Dynamic optimal transport (Benamou-Brenier, staggered space-time grid)
solved as a second-order cone program by PALM, inPALM, ALG2, acc-ADMM,
sGS-inPALM or acc-sGS-ADMM inside the multilevel coarse-to-fine scheme.
The JAX package ``dotsocp_tpu`` stays the reference; module names here
mirror it one to one. The post-DCT passes of the inPALM loop and the sGS
sweep are hand-written CUDA kernels for Hopper (``csrc/*.cu``, bound in
``ops/fused_step.py`` and ``ops/sgs_sweep.py``); on CPU tensors the same
wrappers run their plain PyTorch versions.

Every entry point takes its ``device`` from the caller; nothing here picks
one by itself.
"""

from .ops.geometry import Geometry
from .ops.staggered import Staggered

__version__ = "0.1.0"

__all__ = ["Geometry", "Staggered", "__version__"]
