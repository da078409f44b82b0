"""Milliseconds a solve's level loops spend launching their pieces: the
device driver's ``launch_s`` (each segment's graph replays, and the check,
sigma, rescale and averaging replays, without the record reads), summed
over the levels, per solve. Nothing where the program reports no
``launch_s``."""


def read(run):
    vals = []
    for c in run.calls:
        if c.total_time is None:
            continue
        drv = [lv["driver"] for lv in c.levels if "driver" in lv]
        if drv and all("launch_s" in d for d in drv):
            vals.append(sum(d["launch_s"] for d in drv))
    return 1e3 * sum(vals) / len(vals) if vals else None
