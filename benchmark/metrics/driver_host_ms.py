"""Milliseconds of host work the device driver reports per solve, outside
its replayed loop: prepare, first eager runs, captures and finish, summed
over the levels."""

PARTS = ("prepare_s", "eager_s", "capture_s", "finish_s")


def read(run):
    vals = []
    for c in run.calls:
        if c.total_time is None:
            continue
        drv = [lv["driver"] for lv in c.levels if "driver" in lv]
        if drv:
            vals.append(sum(d.get(p, 0.0) for d in drv for p in PARTS))
    return 1e3 * sum(vals) / len(vals) if vals else None
