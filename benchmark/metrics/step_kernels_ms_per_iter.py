"""Device milliseconds of the program's own CUDA kernels (every
``__global__`` of ``dotsocp_tpu_torch/csrc``) in the traced window, per
iteration run there (all levels)."""


def read(run):
    if run.trace is None:
        return None
    iters = sum(lv["iters"] for c in run.calls for lv in c.levels)
    own = run.trace.device_s.get("own", 0.0)
    return 1e3 * own / iters if iters and own > 0.0 else None
