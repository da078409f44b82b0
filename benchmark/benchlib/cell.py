"""One run of one cell: set-up (pool, warm-up calls), the measured window,
the trace reduction, the reference's checks and the result line."""
from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import manifest, trace as trace_mod
from .traffic import Driver

FORBIDDEN = ("jax", "jaxlib", "flax", "dotsocp_tpu")


def forbidden_modules(names=None) -> list:
    """Of ``names`` (default: the loaded modules), the top-level names
    (before the first dot, compared whole) that are JAX's or the JAX
    package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """What the metric readers read."""
    config: dict
    card: str
    calls: list
    window_s: float
    setup_s: float
    peak_window_bytes: int
    trace: Optional[trace_mod.TraceSummary] = None
    checks: dict = field(default_factory=dict)


def _rng(seed: int, salt: int):
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  salt])


def plan_checks(driver, seed: int, count: int,
                expected_calls: float) -> dict:
    """The answers to check, drawn from the seed: ``count`` distinct slots
    of the pool, each at one of its calls in the first half of the calls
    the window is expected to hold. Returns {call index: [positions in
    the call]}."""
    rng = _rng(seed, 0x5EED)
    served = {}
    for i in range(max(1, int(0.5 * expected_calls))):
        for b, slot in enumerate(driver.slots(i)):
            served.setdefault(slot, []).append((i, b))
    slots = sorted(served)
    plan = {}
    for k in sorted(rng.choice(len(slots), min(count, len(slots)),
                               replace=False)):
        i, b = served[slots[k]][int(rng.integers(len(served[slots[k]])))]
        plan.setdefault(i, []).append(b)
    return plan


def read_table(root: str, config: dict, kind=None) -> dict:
    """The table of optimum energies that the configuration's
    ``reference.table`` names (``tabulate_energies.py`` makes it), checked
    against the configuration (the same problem kind, and its kind's
    ``table_key``: the same grid, pairs and reference block) and against
    the reference (made by the code of its kind's ``reference_sha256``)."""
    kind = kind or manifest.problem(config)
    rc = config["reference"]
    path = os.path.join(root, rc["table"])
    with open(path) as f:
        table = json.load(f)
    want = dict(kind.table_key(config), kind=config["problem"].get("kind"))
    got = {k: table.get(k) for k in want}
    if got != want:
        raise ValueError(f"table {rc['table']} was made for {got}, the "
                         f"configuration asks for {want}")
    if table.get("reference_sha256") != kind.reference_sha256():
        raise ValueError(f"table {rc['table']} was made by another "
                         "reference: make it again with "
                         "tabulate_energies.py")
    return table


def _tabulated(root, config, slots, host_pool, device, kind, args):
    """The optima of ``slots`` from the configuration's table: the slot's
    own ends and arguments, the energy of its pair's optimum (the same
    under every symmetry the pool draws)."""
    import torch

    table = read_table(root, config, kind)
    names = kind.slot_pairs(config)
    missing = sorted({names[s] for s in slots} - set(table["pairs"]))
    if missing:
        raise KeyError(f"table {config['reference']['table']} has no "
                       f"pair {missing}")
    optima = {}
    for s in slots:
        r0, r1 = (x.to(device=device, dtype=torch.float64)
                  for x in host_pool[s])
        optima[s] = kind.tabled_optimum(
            r0, r1, args[s], float(table["pairs"][names[s]]["energy"]))
    used = sorted({names[s] for s in slots})
    note = (f"table {config['reference']['table']} read, nothing solved: "
            f"pairs {used}, energies "
            f"{[table['pairs'][n]['energy'] for n in used]}, finest "
            f"residuals {[table['pairs'][n]['residual'] for n in used]}")
    return optima, note


def judge(config: dict, limits: dict, answers: list, host_pool: list,
          device, root: str, kind=None, args=None):
    """The reference's checks of ``answers`` [(slot, rho, Es, done)]: the
    optimum of each distinct slot, from the configuration's table where
    it names one (``reference.table``), else from a reference solve, and
    every check of ``limits`` on each answer. ``kind``: the configuration's
    problem kind (by default found from it); ``args[slot]``: the slot's
    extra arguments, handed to the reference as to the program (none by
    default). Returns ({check: worst value and limit}, {check: values},
    indices of the answers over a limit, seconds of the reference)."""
    kind = kind or manifest.problem(config)
    args = args if args is not None else [{} for _ in host_pool]
    rc = config["reference"]
    unknown = sorted(set(limits) - set(kind.CHECKS))
    if unknown:
        raise KeyError(f"no reference check {unknown}; known: "
                       f"{sorted(kind.CHECKS)}")
    t0 = time.perf_counter()
    slots = sorted({a[0] for a in answers})
    if "table" in rc:
        optima, note = _tabulated(root, config, slots, host_pool, device,
                                  kind, args)
    else:
        refs = {slot: kind.reference_solve(
            config, *host_pool[slot], args[slot], levels=int(rc["levels"]),
            tol=float(rc["tol"]), coarse_tol=float(rc["coarse_tol"]),
            maxit=int(rc["maxit"]), device=device) for slot in slots}
        optima = {slot: r.optimum() for slot, r in refs.items()}
        note = (f"{len(refs)} solve(s), iterations "
                f"{[r.iters for r in refs.values()]}, residuals "
                f"{[r.residual for r in refs.values()]}")
    checks, per_answer, wrong = {}, {}, set()
    for name, limit in limits.items():
        values = []
        for k, (slot, rho, Es, done) in enumerate(answers):
            v = kind.CHECKS[name]((rho, Es), optima[slot])
            if not v <= limit:   # NaN fails too
                wrong.add(k)
            values.append(v)
        worst = max(values, key=lambda v: math.inf if math.isnan(v) else v,
                    default=math.nan)
        checks[name] = {"value": worst, "limit": limit}
        per_answer[name] = values
    ref_s = time.perf_counter() - t0
    print(f"reference: {note}, {ref_s:.2f} s", file=sys.stderr)
    return checks, per_answer, wrong, ref_s


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        bench_dir: str = manifest.HERE, spec: Optional[dict] = None,
        warmups: int = 2):
    """Set up, measure, check. Returns (result dict, Run). ``warmups``
    calls of the cell's own shape come first: the first builds the
    kernels, fills the solver cache and captures its graphs; the last, warm,
    times a call for the plan of the answers to check."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or manifest.cell(root, workload, bench_dir)
    config, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"

    marks = [("imports and card", time.perf_counter())]
    kind = manifest.problem(config, bench_dir)
    pool = kind.make_pool(config, seed, dev, root)
    args = kind.slot_args(config, seed, dev, root)
    driver = Driver(config, traffic, pool, dev, args, kind.STOP_ROWS)
    marks.append(("pool", time.perf_counter()))
    for k in range(warmups):
        warm = driver.call(k, keep=[])
        marks.append((f"warm-up {k + 1}", time.perf_counter()))
    window = min(seconds, float(traffic["trace_seconds"])) if trace \
        else seconds
    plan = plan_checks(driver, seed, int(traffic["checks"]),
                       window / max(warm.t1 - warm.t0, 1e-9))
    driver.plan_copies(sum(len(v) for v in plan.values()))
    setup_s = time.perf_counter() - t_start
    # where set-up went, for its spread: the imports and CUDA start-up
    # before this function, then each step here
    print("setup: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in
        zip([("", t_start)] + marks, marks)) + f"; total {setup_s:.3f} s",
        file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    calls = []
    with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
        t_w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t_w0 < window:
            calls.append(driver.call(i, keep=plan.get(i, [])))
            i += 1
    window_s = calls[-1].t1 - t_w0
    if driver.copies is not None:
        driver.copies.wait()
    summary = None
    if prof is not None:
        prof.stop()
        own = trace_mod.program_kernel_names(
            os.path.join(root, "dotsocp_tpu_torch", "csrc"))
        summary = trace_mod.summarize_events(trace_mod.events_of(prof), own)
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # the program's state goes before the reference runs
    from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache

    answers = [a for c in calls for a in c.answers]
    host_pool = [tuple(x.cpu() for x in p) for p in pool]
    del driver, pool, warm
    clear_solver_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, per_answer, wrong, ref_s = judge(config, spec["limits"]["checks"],
                                            answers, host_pool, dev, root,
                                            kind, args)
    correct = bool(answers) and all(
        c["value"] <= c["limit"] for c in checks.values())

    attempted = sum(len(c.slots) for c in calls)
    solved = sum(sum(c.done) for c in calls)
    # a solved instance that the reference finds wrong fails as well
    wrong_solved = sum(1 for k in wrong if answers[k][3])
    failed = attempted - solved + wrong_solved
    rec = Run(config=config, card=card,
              calls=calls, window_s=window_s, setup_s=setup_s,
              peak_window_bytes=int(peak), trace=summary,
              checks={"answers": len(answers), "wrong": wrong_solved,
                      "values": per_answer, "reference_s": ref_s,
                      "slots": [a[0] for a in answers]})
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = manifest.reader(m["name"], bench_dir)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                "count": 1, "memory_peak_bytes": int(max(peak, setup_peak))}
    result = {"correct": correct, "attempted": attempted,
              "failed": min(failed, attempted), "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result, rec


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
