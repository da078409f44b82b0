"""Milliseconds a solve's level loops wait in the record reads of their
checks, where the host blocks on the card: the device driver's ``wait_s``,
summed over the levels, per solve. Nothing where the program reports no
``wait_s``."""


def read(run):
    vals = []
    for c in run.calls:
        if c.total_time is None:
            continue
        drv = [lv["driver"] for lv in c.levels if "driver" in lv]
        if drv and all("wait_s" in d for d in drv):
            vals.append(sum(d["wait_s"] for d in drv))
    return 1e3 * sum(vals) / len(vals) if vals else None
