"""Microseconds of host launch time per graph replay: the device driver's
``launch_s`` over its ``replays``, both summed over the window's solves and
their levels. Nothing where the program reports no ``launch_s`` or
replayed nothing."""


def read(run):
    launch = replays = 0.0
    for c in run.calls:
        if c.total_time is None:
            continue
        for lv in c.levels:
            d = lv.get("driver", {})
            if "launch_s" in d:
                launch += d["launch_s"]
                replays += d.get("replays", 0.0)
    return 1e6 * launch / replays if replays else None
