"""Checkpoint/resume for long solves; port of
``dotsocp_tpu/utils/checkpoint.py``.

A snapshot is a flat npz of the device driver's loop-state tensors, in the
fixed order the driver lists them, plus a small JSON metadata record. The
driver snapshots at chunk boundaries (``chunk_iters``, 600 by default); a
resumed run continues the same level mid-flight with the identical decision
state (sigma cadence counters, rescale stage, history).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch


def save_tensors(path: str, tensors: Sequence[torch.Tensor],
                 meta: Optional[dict] = None) -> None:
    """Atomic snapshot: a temporary file beside ``path``, then
    ``os.replace``. Reading the tensors back to the host waits for the
    device."""
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, t in enumerate(tensors)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                       dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_tensors(path: str, template: Sequence[torch.Tensor]):
    """The snapshot at ``path`` as tensors on the device and in the dtype of
    the ``template`` tensor in the same place. Returns (tensors, meta).
    Raises ValueError when the count or a shape differs (a stale snapshot
    of another level or configuration)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode() or "{}")
        n = len(template)
        missing = [i for i in range(n) if f"leaf_{i}" not in data.files]
        if missing or f"leaf_{n}" in data.files:
            raise ValueError(f"checkpoint holds another number of tensors "
                             f"than the template's {n}")
        stored = [data[f"leaf_{i}"] for i in range(n)]
    for i, (s, t) in enumerate(zip(stored, template)):
        if tuple(s.shape) != tuple(t.shape):
            raise ValueError(f"tensor {i}: checkpoint shape {s.shape} != "
                             f"template {tuple(t.shape)}")
    return [torch.as_tensor(s).to(device=t.device, dtype=t.dtype)
            for s, t in zip(stored, template)], meta
