"""The native golden kernels: independent C++ implementations of the
reference's four MEX kernels (``mexProjSoc``, ``mexBFd``, ``mexBFdConj``,
``mexsGS``) in float64, the oracle the tests and ``chip_smoke.py`` hold the
port's shaped operators and its sGS sweep against; port of
``dotsocp_tpu/native`` (its own copy of ``src/golden_kernels.cpp``).

``g++`` builds the source at first use into ``build/native/`` at the
repository root, named by a hash of the source and the flags (the flags
are the JAX module's, so the two libraries round alike), and raises if the
build fails. The wrappers take and return CPU float64 tensors in the
port's shaped layout (time axis leading, cone columns first). No solver
path calls them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "golden_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"golden_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first when it is not there."""
    path = _library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        dp = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        dbl = ctypes.c_double
        for name, argtypes in (
                ("proj_soc", [dp, dp, i64, i64]),
                ("bfd2d", [dp, dp, dp, dp, i64, i64, i64, dbl, dbl]),
                ("bfd_conj2d", [dp, dp, dp, dp, i64, i64, i64, dbl]),
                ("rb_sgs", [dp, dp, i64, i64, i64, dbl, dbl, ctypes.c_int])):
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = None
    return _lib


def _arg(t: torch.Tensor, shape, what: str) -> torch.Tensor:
    """``t`` checked (a CPU float64 tensor of ``shape``), contiguous."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" \
            or t.dtype != torch.float64:
        got = (f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        raise TypeError(f"{what}: a CPU float64 tensor, got {got}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


def _ptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_double))


def _empty(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float64)


def proj_soc(z: torch.Tensor) -> torch.Tensor:
    """Row-wise Lorentz projection; z has shape (cols, *cells)."""
    z = _arg(z, None, "z")
    cols = z.shape[0]
    out = torch.empty_like(z)
    lib().proj_soc(_ptr(out), _ptr(z), z.numel() // cols, cols)
    return out


def bfd2d(q0, by, bx, nt: int, ny: int, nx: int, scale_bf,
          scale_d) -> torch.Tensor:
    """z = scale_bf (BF q) + scale_d d in 2D, shape (10, nt-1, ny, nx)."""
    q0 = _arg(q0, (nt - 1, ny, nx), "q0")
    by = _arg(by, (nt, ny - 1, nx), "by")
    bx = _arg(bx, (nt, ny, nx - 1), "bx")
    z = _empty(10, nt - 1, ny, nx)
    lib().bfd2d(_ptr(z), _ptr(q0), _ptr(by), _ptr(bx), nt, ny, nx,
                float(scale_bf), float(scale_d))
    return z


def bfd_conj2d(x, nt: int, ny: int, nx: int,
               scale_bf) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q = scale_bf (BF)^T x in 2D: (q0, by, bx)."""
    x = _arg(x, (10, nt - 1, ny, nx), "x")
    q0, by, bx = (_empty(nt - 1, ny, nx), _empty(nt, ny - 1, nx),
                  _empty(nt, ny, nx - 1))
    lib().bfd_conj2d(_ptr(q0), _ptr(by), _ptr(bx), _ptr(x), nt, ny, nx,
                     float(scale_bf))
    return q0, by, bx


def rb_sgs(phi, rhs, scale, eps: float = 0.0, its: int = 1) -> torch.Tensor:
    """``its`` red-black symmetric Gauss-Seidel sweeps of (scale A^T A +
    eps I) phi = rhs on the (nt, ny, nx) Neumann grid; ``phi`` is left as it
    was."""
    phi = _arg(phi, None, "phi")
    if phi.ndim != 3:
        raise ValueError(f"phi: shape {tuple(phi.shape)}, expected (nt, ny, "
                         f"nx)")
    rhs = _arg(rhs, phi.shape, "rhs")
    out = phi.clone()
    nt, ny, nx = phi.shape
    lib().rb_sgs(_ptr(out), _ptr(rhs), nt, ny, nx, float(scale), float(eps),
                 int(its))
    return out
