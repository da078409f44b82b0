"""Multi-process execution on ``torch.distributed``; port of
``dotsocp_tpu/parallel/distributed.py:29-152``.

Every process is one rank and holds one shard: it calls
:func:`initialize_distributed`, builds its view of the mesh
(``parallel/sharding.make_mesh``) and runs the same ``solve_dot`` (or
``solve_batch``) as every other rank on its own block. The solver makes
only replicated decisions: every norm and dot product of the KKT battery
is summed over the mesh bit-identically on every rank
(``parallel/comm.psum``), so every rank takes the same branch, issues the
same collectives in the same order, and returns the same result dict.

Backends: ``nccl`` where each rank has a card of its own (``torchrun
--nproc-per-node=N`` on a machine with N cards), ``gloo`` on the CPU.
NCCL refuses two ranks on one card; ``backend="gloo"`` lets several ranks
share one (the comm layer then stages CUDA tensors through host buffers).
Every world run so far, on the CPU and on one card, used gloo: the NCCL
branches of ``parallel/comm.py`` have not run on any machine yet.

Usage, one command per process (or under ``torchrun``, which sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``):

    python -m dotsocp_tpu_torch.parallel.distributed \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id $I --cpu

or the whole world from one command, its ranks spawned on this machine:

    python -m dotsocp_tpu_torch.parallel.distributed --spawn 2 --cpu

Each rank prints one ``DIST_RESULT {...}`` line (``tests/
test_torch_distributed.py`` checks that they agree).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait before the process group raises: a rank
# that issues collectives out of order fails instead of hanging
DEFAULT_TIMEOUT = 600.0

_DEVICE = {"device": None}


def _env_int(*names) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    local_device_count: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> dict:
    """Join (or form) the process group of ``num_processes`` ranks at
    ``tcp://coordinator_address`` as rank ``process_id``.

    The arguments default to ``DOTSOCP_COORDINATOR`` /
    ``DOTSOCP_NUM_PROCESSES`` / ``DOTSOCP_PROCESS_ID``, then to torchrun's
    ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. ``device`` is
    the rank's device, by default ``cuda:LOCAL_RANK``; without a card only
    ``device="cpu"`` runs, and any other raises RuntimeError. ``backend``
    defaults to ``"nccl"`` for a CUDA device (a card for each rank; not
    yet run on any machine) and ``"gloo"`` for the CPU; ``"gloo"`` with a
    CUDA device lets several ranks share one card. A rank holds one shard, so
    ``local_device_count`` (the JAX package's virtual devices a process)
    may only be None or 1. Turns TF32 off in this process (the DCT needs
    full float32). Returns (process_id, process_count, backend, device)."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: a rank of the port "
            f"holds one shard; start one process a shard instead")
    if coordinator_address is None:
        coordinator_address = os.environ.get("DOTSOCP_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("DOTSOCP_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DOTSOCP_PROCESS_ID", "RANK")
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize_distributed needs the coordinator's "
                         "address, the number of processes and this "
                         "process's id (arguments, DOTSOCP_* or torchrun's "
                         "environment)")
    local = _env_int("LOCAL_RANK") or 0
    device = torch.device(f"cuda:{local}" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    from ..ops.poisson import full_precision_matmul

    full_precision_matmul()
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)))
    _DEVICE["device"] = device
    return {"process_id": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "backend": dist.get_backend(), "device": str(device)}


def local_device() -> torch.device:
    """The device :func:`initialize_distributed` gave this rank; raises
    RuntimeError before it ran."""
    if _DEVICE["device"] is None:
        raise RuntimeError("no rank device: call initialize_distributed "
                           "first, or pass the device")
    return _DEVICE["device"]


def is_coordinator() -> bool:
    """True on the rank that owns the side effects: verbose prints, the
    ``trace_dir`` profile, files a caller writes. Every process is the
    coordinator when there is no process group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# self-test: a spatially sharded multilevel solve, one DIST_RESULT line a
# rank (tests/test_torch_distributed.py, chip_smoke.py phase 10)
# ---------------------------------------------------------------------------

def selftest_record(levels: int = 1, maxit: int = 200, tol: float = 1e-3,
                    algorithm: str = "inPALM",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Run the sharded solve of the JAX self-test (example2 at 33^2 x 9 on
    a (y, x) mesh of the world) on this rank and return its record."""
    import numpy as np

    from ..models.examples import get_example_2d
    from ..multilevel.solve import solve_dot
    from .sharding import make_mesh

    rho0, rho1 = get_example_2d("example2", 33, 33)
    mesh = make_mesh(axis_names=("y", "x"))
    dev = local_device()
    out, hml, _ = solve_dot(
        rho0, rho1, 9, levels,
        {"tol": tol, "maxit": maxit, "driver": "device", "mesh": mesh},
        algorithm, dtype=dtype, verbose=False, device=dev)
    return {
        "process": dist.get_rank(),
        "processes": dist.get_world_size(),
        "mesh": dict(mesh.shape),
        "iters": [lv["iters"] for lv in out["levels"]],
        "kkt": np.asarray(hml["kkt"][-1][[0, 2, 5, 6]]).tolist(),
        "mass_ok": bool(out["mass_ok"]),
        "rho_sum": float(out["rho"].double().sum()),
    }


def print_record(rec: dict) -> None:
    """One ``DIST_RESULT`` line, in one write: the ranks of a world share
    their stdout, and a line printed in pieces would interleave."""
    import json
    import sys

    sys.stdout.flush()
    os.write(sys.stdout.fileno(),
             ("DIST_RESULT " + json.dumps(rec) + "\n").encode())


def _spawned_rank(levels, maxit, tol, algorithm, dtype):
    rec = selftest_record(levels, maxit, tol, algorithm, dtype=dtype)
    print_record(rec)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="spawn the N ranks of the world on this machine")
    p.add_argument("--local-devices", type=int, default=1,
                   help="shards a process (the JAX CLI's; a rank holds one)")
    p.add_argument("--levels", type=int, default=1)
    p.add_argument("--maxit", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--algorithm", default="inPALM")
    p.add_argument("--f64", action="store_true",
                   help="float64 (default float32, as the JAX self-test)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--backend", default=None)
    a = p.parse_args(argv)
    dtype = torch.float64 if a.f64 else torch.float32
    device = "cpu" if a.cpu else None
    if a.spawn:
        from .launch import run_world

        run_world(_spawned_rank, a.spawn,
                  (a.levels, a.maxit, a.tol, a.algorithm, dtype),
                  backend=a.backend or "gloo",
                  device=device or "cuda")
        return
    if a.cpu and a.num_processes:
        # the ranks of the self-test share one machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // a.num_processes))
    initialize_distributed(a.coordinator, a.num_processes, a.process_id,
                           backend=a.backend, device=device,
                           local_device_count=a.local_devices)
    try:
        print_record(selftest_record(a.levels, a.maxit, a.tol,
                                      a.algorithm, dtype=dtype))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    # run the package's copy of this module, whose rank device make_mesh
    # reads (``python -m`` runs a second copy named __main__)
    from .distributed import main as _main

    _main()
