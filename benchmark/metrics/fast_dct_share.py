"""Percent of the window's iterations whose phi-step DCT solve took the FFT
route on some axis: 100 times the levels' ``driver["fast_dct_iters"]`` over
their ``iters``, summed over the window's solves. Nothing where no level
reports ``fast_dct_iters`` (a program without the counter) or no iteration
ran."""


def read(run):
    iters = fast = 0
    for c in run.calls:
        if c.total_time is None:
            continue
        for lv in c.levels:
            drv = lv.get("driver")
            if drv is None or "fast_dct_iters" not in drv:
                continue
            iters += lv["iters"]
            fast += drv["fast_dct_iters"]
    return 100.0 * fast / iters if iters else None
