"""Device milliseconds of the matrix-product kernels (the phi-step's DCT
matmuls: cuBLAS / CUTLASS GEMMs) in the traced window, per iteration run
there (all levels)."""


def read(run):
    if run.trace is None:
        return None
    iters = sum(lv["iters"] for c in run.calls for lv in c.levels)
    gemm = run.trace.device_s.get("gemm", 0.0)
    return 1e3 * gemm / iters if iters and gemm > 0.0 else None
