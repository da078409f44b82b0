"""Milliseconds a solve spends getting its levels' solvers (a hit of the
solver cache, or a build): the sum of the levels' ``build_s``, per solve."""


def read(run):
    vals = [sum(lv["build_s"] for lv in c.levels)
            for c in run.calls if c.total_time is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
