"""Milliseconds a solve spends outside its levels' loops and solver
builds: ``total_time`` minus the sum of each level's ``time`` and
``build_s`` (the program's host clocks), per solve."""


def read(run):
    vals = [c.total_time - sum(lv["time"] + lv["build_s"] for lv in c.levels)
            for c in run.calls if c.total_time is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
