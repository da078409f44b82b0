#!/usr/bin/env python3
"""Make the table of optimum energies that a configuration's
``reference.table`` names: each distinct pair of its pool, unturned, solved
once by the float64 reference of its problem kind (``reference_solve``; the
built-in kind's is ``benchlib/reference.py``) at the configuration's
``reference`` block, and the energy J_ref of its optimum written down. The
benchmark's judge then reads J_ref from the table instead of solving each
checked instance (J is the same under every symmetry the pool draws, the
only thing ``--seed`` changes in such a pool).

    python3 benchmark/tabulate_energies.py --config <name> [--out <path>] \\
        [--commit <sha>] [--device cuda|cpu]

Run from the repository's root, on the card (minutes a pair at 513^2 x 65).
Writes the table to ``--out`` (default: the path the configuration names)
and prints it. Only a change of the benchmark remakes a table.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.getcwd()
BENCH = os.path.dirname(os.path.abspath(__file__))


def _power_limit():
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def make_table(root: str, config: dict, device, command: str = "",
               commit: str = "", bench_dir: str = BENCH) -> dict:
    """The table of ``config``: for each distinct pair of its pool, the
    energy of the reference's optimum, the finest level's relative
    residual, the iterations a level and the seconds of the solve."""
    import torch

    from benchlib import manifest

    kind = manifest.problem(config, bench_dir)
    rc = config["reference"]
    names = sorted(set(kind.slot_pairs(config)))
    base = kind.table_pairs(config, device, root)
    dev = torch.device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    table = dict(kind.table_key(config), config=config["name"],
                 command=command, card=card, commit=commit,
                 reference_sha256=kind.reference_sha256(), pairs={})
    if "kind" in config["problem"]:
        table["kind"] = config["problem"]["kind"]
    if dev.type == "cuda":
        table["power_limit"] = _power_limit()
    for name in names:
        # the arrays a slot under the identity holds (float32)
        r0, r1, args = base[name]
        r0, r1 = (r.to(torch.float32) for r in (r0, r1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sol = kind.reference_solve(config, r0, r1, args,
                                   levels=int(rc["levels"]),
                                   tol=float(rc["tol"]),
                                   coarse_tol=float(rc["coarse_tol"]),
                                   maxit=int(rc["maxit"]), device=dev)
        seconds = time.perf_counter() - t0
        table["pairs"][name] = {
            "energy": sol.optimum().energy, "residual": sol.residual,
            "iters": sol.iters, "seconds": seconds}
        print(f"{name}: energy {sol.optimum().energy!r}, finest residual "
              f"{sol.residual!r} (tol {rc['tol']}), iterations {sol.iters},"
              f" {seconds:.1f} s", file=sys.stderr, flush=True)
        if not sol.residual <= float(rc["tol"]):
            print(f"warning: {name} stopped at maxit {rc['maxit']} above "
                  f"tol {rc['tol']}", file=sys.stderr, flush=True)
        del sol
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out")
    ap.add_argument("--commit", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import torch

    from benchlib import manifest

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    entry = {c["name"]: c for c in manifest.load(ROOT)["configs"]}[
        args.config]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    out = args.out or os.path.join(ROOT, config["reference"]["table"])
    command = " ".join(["python3", "benchmark/tabulate_energies.py"] +
                       (argv if argv is not None else sys.argv[1:]))
    table = make_table(ROOT, config, args.device, command, args.commit)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
