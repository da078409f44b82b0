"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source at first use into a shared library with a
plain C interface, under ``build/kernels/`` at the repository root, named by
a hash of the source and flags (an edit rebuilds; an unchanged tree reuses
the library). The sources compile in parallel, one ``nvcc`` each, all
started together. The libraries are loaded with ``ctypes``: pointers come
from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. No PyTorch headers are
compiled, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
import types

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# every source, with the argtypes of each C entry point it defines
SOURCES = {
    "fused_step.cu": {
        # (dim, nt, S, k0..k2): the stride of each space axis; the q-steps
        # also take the sizes n0..n2 and, among their floats, hs0..hs2
        "dotsocp_x_step": [_P] * 4 + [_I] * 6 + [_F] * 2 + [_P],
        "dotsocp_qx_step": [_P] * 6 + [_I] * 9 + [_F] * 10 + [_P],
        "dotsocp_qx_step_w": [_P] * 8 + [_I] * 9 + [_F] * 10 + [_P],
        "dotsocp_cx_step": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_I, _P],
        "dotsocp_z_step": [_P] * 4 + [_I] * 6 + [_F] * 2 + [_P],
        "dotsocp_q_step": [_P] * 9 + [_I] * 9 + [_F] * 10 + [_P],
        "dotsocp_q_step_w": [_P] * 11 + [_I] * 9 + [_F] * 10 + [_P],
        "dotsocp_beta_step": [_P] * 5 + [_I] * 6 + [_F] * 3 + [_P],
        "dotsocp_cone_project_diff": [_P, _P, _P, _I, _I, _P],
        # the entries that read their problem-dependent scalars from device
        # memory: (sbf, sd) pointers where the by-value entries take the two
        # floats; the q-steps (sbf, sv, two diagonal values) pointers after
        # hs0..hs2, and D, tau, ht, hs0..hs2 by value
        "dotsocp_x_step_dev": [_P] * 4 + [_I] * 6 + [_P] * 3,
        "dotsocp_z_step_dev": [_P] * 4 + [_I] * 6 + [_P] * 3,
        "dotsocp_cx_step_dev": [_P] * 4 + [_I] * 6 + [_P, _P, _F, _I, _P],
        "dotsocp_beta_step_dev": [_P] * 5 + [_I] * 6 + [_P, _P, _F, _P],
        "dotsocp_qx_step_dev": [_P] * 6 + [_I] * 9 + [_F] * 6 + [_P] * 5,
        "dotsocp_qx_step_w_dev": [_P] * 8 + [_I] * 9 + [_F] * 6 + [_P] * 5,
        "dotsocp_q_step_dev": [_P] * 9 + [_I] * 9 + [_F] * 6 + [_P] * 5,
        "dotsocp_q_step_w_dev": [_P] * 11 + [_I] * 9 + [_F] * 6 + [_P] * 5,
        # the batched forms: (sd_at, active) pointers after the arrays, B
        # before dim
        "dotsocp_x_step_b": [_P] * 6 + [_I] * 7 + [_F, _P],
        "dotsocp_qx_step_b": [_P] * 7 + [_I] * 10 + [_F] * 10 + [_P],
        "dotsocp_cx_step_b": [_P] * 6 + [_I] * 7 + [_F] * 2 + [_I, _P],
        # the phi-step's rhs: eight arrays (the weight's two null when
        # unweighted), (B, dim, nt, S, k0..k2), D and the reciprocal
        # spacings 1/h_t, 1/h_0..1/h_2
        "dotsocp_phi_rhs": [_P] * 8 + [_I] * 7 + [_F] * 5 + [_P],
        # the KKT battery's sums: the workspace's rows for (nt, S); then ten
        # arrays (the weight's two null when unweighted), the workspace and
        # its rows, out, (dim, nt, S, k0..k2, n0..n2), the reciprocal
        # spacings, D and 1/D, ten scalars by value and four addresses that
        # replace some of them (null: the values)
        "dotsocp_kkt_blocks": [_I, _I],
        "dotsocp_kkt_sums": [_P] * 11 + [_I, _P] + [_I] * 9 + [_F] * 16
                            + [_P] * 5,
    },
    "sgs_sweep.cu": {
        # (dim, nt, n0..n2): the sizes of the space axes
        "dotsocp_rb_sweep": [_P] * 3 + [_I] * 5 + [_F, _P],
        "dotsocp_rb_sweep_smem_bytes": [_I],
        "dotsocp_rb_sweep_blocks_per_sm": [_I],
    },
    "flat_shift.cu": {
        "dotsocp_flat_shift": [_P, _P, _I, _I, _I, _I, _I, _P],
    },
    "dct_spectral.cu": {
        # (V, g, T, R, n1, n2, h3, rows of g, scale)
        "dotsocp_dct_spectral": [_P] * 3 + [_L, _I, _I, _I, _L, _F, _P],
        # (x, y, At, src, L, T, TP, S)
        "dotsocp_dct_t_gather": [_P] * 4 + [_L, _I, _I, _L, _P],
    },
    "dct_dense.cu": {
        # (x, its row stride, y, its row stride, A^T, B, slabs, ny, nx)
        "dotsocp_dct_slab": [_P, _I, _P, _I, _P, _P, _L, _I, _I, _P],
        # (v, C_t^T, C_t, inverse kernel, L, T, S, scale)
        "dotsocp_dct_t_spectral": [_P] * 4 + [_L, _I, _L, _F, _P],
    },
}

_LIB = None
build_info: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda). Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, and not under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the CUDA kernels of dotsocp_tpu_torch are "
        "built from csrc/ at first use and need the CUDA toolkit")


def _library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build() -> list:
    """Compile the sources that have no library for their hash, all at
    once; returns the library paths in the order of ``SOURCES``.
    ``build_info`` records the time and the compiler's register / spill
    report."""
    paths = [_library_path(s) for s in SOURCES]
    todo = [(s, p) for s, p in zip(SOURCES, paths) if not os.path.isfile(p)]
    build_info.update(paths=paths, seconds=0.0, cached=not todo, log="")
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # ranks of one machine that start together build once: the first holds
    # the lock (released when its process ends, however it ends), the
    # others find its libraries
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [(s, p) for s, p in todo if not os.path.isfile(p)]
        build_info["cached"] = not todo
        if todo:
            _compile(nvcc, todo)
    return paths


def _compile(nvcc: str, todo) -> None:
    t0 = time.monotonic()
    jobs = []
    for source, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        jobs.append((cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, tmp, path, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, path)
        logs.append(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_info.update(seconds=time.monotonic() - t0, log="".join(logs))


def library() -> types.SimpleNamespace:
    """Every C entry point of the kernels, by name (built on first call)."""
    global _LIB
    if _LIB is None:
        fns = {}
        libs = []
        for path, signatures in zip(build(), SOURCES.values()):
            lib = ctypes.CDLL(path)
            libs.append(lib)
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        _LIB = types.SimpleNamespace(libraries=libs, **fns)
    return _LIB
