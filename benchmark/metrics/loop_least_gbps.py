"""Throughput of the finest level's loop in least bytes: the least bytes of
an inPALM iteration (``benchlib.roofline.inpalm_least_bytes``) times the
finest level's iterations, summed over the window's calls, over the finest
level's loop time, in GB/s. The loop time is the program's host clock
(level ``time``), which spans the loop's device work, its launches, its
checks and the gaps between them; in a traced run it carries the
profiler's cost. So this is no share of the card's bandwidth, only a
number that rises as the finest loop gets faster at a fixed amount of
work. Nothing for a method other than inPALM."""
from benchlib import roofline


def read(run):
    p = run.config["problem"]
    if p["method"] != "inPALM":
        return None
    iters = sum(c.levels[-1]["iters"] for c in run.calls)
    seconds = sum(c.levels[-1]["time"] for c in run.calls)
    if not iters or seconds <= 0.0:
        return None
    least = roofline.inpalm_least_bytes(p["nt"], (p["n"],) * p["dim"])
    return 1e-9 * least * iters / seconds
