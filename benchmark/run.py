#!/usr/bin/env python3
"""One run of one benchmark cell of dotsocp_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the repository's root. Prints the reference's checks beside their
limits as the last lines of standard error and one JSON result as the last
line of standard output (``benchlib.cell.emit``). Exits 1 without a result
where the card or the cell's chip count is missing, or where JAX or the JAX
package was loaded into this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "bench_cache")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library loads JAX behind the port's back."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    from benchlib import cell, manifest

    spec = manifest.cell(ROOT, args.workload)
    import torch

    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import dotsocp_tpu_torch  # noqa: F401  (fails where the port is absent)

    result, _ = cell.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START,
                         spec=spec)
    found = cell.forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 1
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
