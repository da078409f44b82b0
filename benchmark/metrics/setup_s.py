"""Seconds from the start of the process to the start of the window:
imports, CUDA start-up, the pool, the kernels' build (the first run of a
checkout) and the warm-up call."""


def read(run):
    return run.setup_s
