"""Spawn a world of ranks on this machine and collect what each returns:
the launcher of the multi-rank self-tests (``parallel/distributed.py
--spawn``, ``demos/demo_batch.py --mode sharded --spawn``, the CPU tests,
``chip_smoke.py`` phase 10). On a machine with a card for each rank,
``torchrun`` is the launcher instead.

Each rank is a fresh process (start method ``spawn``) that forms the
process group on a free local port, runs ``fn(*args)`` and puts its result
(or its traceback) on a queue. The world has one deadline: a rank that
fails, or a world that outlives ``timeout`` (a collective issued out of
order hangs until then), ends every rank by its PID and raises here, so a
fault never hangs the caller.
"""
from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, device, timeout, args, out):
    import os

    import torch
    import torch.distributed as dist

    from .distributed import initialize_distributed

    if str(device) == "cpu":
        # the ranks share the machine's cores: one intra-op pool each of the
        # whole machine's size would oversubscribe it
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               backend=backend, device=device,
                               timeout=timeout)
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which ends the world
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, args=(), *, backend: str = "gloo",
              device="cpu", timeout: float = 600.0) -> list:
    """``fn(*args)`` on each of ``world`` spawned ranks (``fn`` importable
    by name, its results picklable); returns the results in rank order.
    Raises RuntimeError with a rank's traceback when one fails, and
    TimeoutError when the world outlives ``timeout`` seconds; either way
    every rank is ended first."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, str(device),
                               timeout, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world} ranks: {sorted(results)} finished "
                    f"within {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {world} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()  # the exact PID of a rank this call spawned
                p.join(timeout=10.0)
        out.close()
    return [results[r] for r in range(world)]
