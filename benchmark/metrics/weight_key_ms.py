"""Milliseconds a solve spends forming its levels' solver-cache keys (a
weighted level's content digest of its weight, prewarm's keys included):
the sum of the levels' ``driver["key_s"]``, over the window's solves.
Nothing where no level reports ``key_s`` (a program without the span)."""


def read(run):
    total, solves = 0.0, 0
    for c in run.calls:
        if c.total_time is None:
            continue
        keys = [lv["driver"]["key_s"] for lv in c.levels
                if "key_s" in lv.get("driver", {})]
        if keys:
            total += sum(keys)
            solves += 1
    return 1e3 * total / solves if solves else None
