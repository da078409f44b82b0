"""Host synchronisations of the device driver per solve: the sum of the
levels' ``driver["syncs"]``."""


def read(run):
    vals = [sum(lv["driver"]["syncs"] for lv in c.levels if "driver" in lv)
            for c in run.calls
            if c.total_time is not None and any("driver" in lv
                                                for lv in c.levels)]
    return sum(vals) / len(vals) if vals else None
