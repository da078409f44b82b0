"""Microseconds an iteration of the coarsest level's loop takes: the sum
of the first level's ``time`` over the sum of its ``iters``, over the
window's solves (at 33^2 x 33 a launch- and check-paced loop of ~10,000
iterations). Nothing without a finished solve or an iteration."""


def read(run):
    time_s, iters = 0.0, 0
    for c in run.calls:
        if c.total_time is None or not c.levels:
            continue
        time_s += c.levels[0]["time"]
        iters += c.levels[0]["iters"]
    return 1e6 * time_s / iters if iters else None
