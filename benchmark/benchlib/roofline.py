"""The yardstick's constants and byte counts, frozen here so that a later
change to the program cannot move them.

* ``HBM_PEAKS``: the SXM H100's 3.35 TB/s, copied from
  ``dotsocp_tpu_torch/utils/profiling.py:38-42`` (NVIDIA's data sheet).
* ``kernel_bytes``: copied from ``chip_smoke.py:1910-1939`` (each input
  read once, each output written once, float32), for a later per-kernel
  roofline.
* ``inpalm_least_bytes``: the least HBM traffic of one inPALM iteration
  that no implementation can avoid (written for this benchmark), which the
  finest level loop's throughput reads (``metrics/loop_least_gbps.py``).
"""
from __future__ import annotations

import math

HBM_PEAKS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM
}


def hbm_peak(card: str):
    """Bytes/s of the card named as ``torch.cuda.get_device_name`` names
    it, or None: no share is reported against a guessed peak."""
    return HBM_PEAKS.get(card)


def staggered_size(nt: int, space) -> int:
    """Entries of one staggered field (q or alpha): the time-staggered
    block (nt-1) x space plus, per space axis a, nt x space with n_a - 1
    faces."""
    S = math.prod(space)
    faces = sum(nt * S // n * (n - 1) for n in space)
    return (nt - 1) * S + faces


def inpalm_least_bytes(nt: int, space, itemsize: int = 4) -> int:
    """Least bytes of one inPALM iteration: the fields that carry from one
    iteration to the next, each read once and written once. phi is solved
    anew from (q, alpha) and z projected anew from (q, beta) every
    iteration, so they need not cross iterations; q, alpha (staggered) and
    beta ((2 + 4d) x (nt-1) x space) must."""
    S = math.prod(space)
    cone = (2 + 4 * len(space)) * (nt - 1) * S
    return 2 * itemsize * (2 * staggered_size(nt, space) + cone)


def kernel_bytes(nt: int, space) -> dict:
    """Bytes each kernel moves through HBM, each input read once and each
    output written once (f32); ``chip_smoke.py:1910-1939``."""
    S = math.prod(space)
    d = len(space)
    C = 2 + 4 * d
    n_centered = nt * S
    cells, faces = (nt - 1) * S, d * nt * S
    return {
        "x_step": 4 * (cells + faces + 2 * C * cells),
        "qx_step": 4 * (nt * S + C * cells + 3 * cells + 3 * faces),
        "qx_step_w": 4 * (nt * S + C * cells + 4 * cells + 4 * faces),
        "cx_step": 4 * (cells + faces + 4 * C * cells),
        "cx_final": 4 * (cells + faces + 4 * C * cells),
        "rb_sweep": 3 * 4 * n_centered,
        "z_step": 4 * (cells + faces + 2 * C * cells),
        "q_step": 4 * (nt * S + 2 * C * cells + 3 * cells + 3 * faces),
        "q_step_w": 4 * (nt * S + 2 * C * cells + 4 * cells + 4 * faces),
        "beta_step": 4 * (cells + faces + 3 * C * cells),
        "cone_project_diff": 4 * 3 * C * cells,
        "flat_shift": 4 * 2 * nt * S,
    }
