"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, limits, metric readers and problem kind are found by name, so
that a new cell, configuration, metric or problem is added as files alone.

    configs/<config>.json        the file ``configs[].file`` names
    traffic/<traffic>.json       the mix's parameters (traffic.py reads them)
    limits/<workload>.json       the reference's checks and their limits
    metrics/<metric>.py          ``read(run)`` -> number or None
    problems/<kind>.py           the problem a configuration's
                                 ``problem.kind`` names: its pool, each
                                 slot's extra ``solve_dot`` arguments, the
                                 KKT rows a solve stops on, its reference,
                                 table key and checks (``benchlib/dotmark.py``
                                 lists the names; a configuration without
                                 ``kind`` is of that built-in kind)
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of metric ``name``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


KIND_NAMES = ("make_pool", "slot_args", "slot_pairs", "table_pairs",
              "STOP_ROWS", "reference_solve", "tabled_optimum", "table_key",
              "reference_sha256", "CHECKS")


def problem(config: dict, bench_dir: str = HERE):
    """The problem kind of ``config``: the module ``problems/<kind>.py``
    that its ``problem.kind`` names (loaded once a process), else the
    built-in kind, ``benchlib/dotmark.py``."""
    name = config["problem"].get("kind")
    if name is None:
        from . import dotmark
        return dotmark
    path = os.path.join(bench_dir, "problems", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"problem kind {name!r} has no module at "
                                f"{path}")
    mod_name = f"bench_problem_{name}"
    mod = sys.modules.get(mod_name)
    if mod is None or mod.__file__ != path:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[mod_name]
            raise
    missing = [k for k in KIND_NAMES if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"problem kind {name!r} ({path}) lacks "
                             f"{missing}")
    return mod


def cell(root: str, workload: str, bench_dir: str = HERE,
         manifest: dict = None) -> dict:
    """Everything one run of ``workload`` needs: its entry, configuration,
    traffic, limits, and the metrics it reports (end-to-end ones without a
    ``workloads`` key in every cell; per-layer ones without it in every cell
    that reports the end-to-end metric they move)."""
    m = manifest if manifest is not None else load(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 f"{w['traffic']}.json"))
    limits = _json(os.path.join(bench_dir, "limits", f"{workload}.json"))

    def here(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [x for x in m["end_to_end"] if here(x)]
    e2e_names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if x["moves"] in e2e_names and here(x)]
    return {"workload": w, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}
