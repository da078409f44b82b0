"""Percent of the window's iterations whose phi-step DCT solve ran the
matrix route's hand-written passes (``ops/poisson.dense_passes``): 100
times the levels' ``driver["dct_kernel_iters"]`` over their ``iters``,
summed over the window's solves. Nothing where no level reports
``dct_kernel_iters`` (a program without the counter) or no iteration
ran."""


def read(run):
    iters = passes = 0
    for c in run.calls:
        if c.total_time is None:
            continue
        for lv in c.levels:
            drv = lv.get("driver")
            if drv is None or "dct_kernel_iters" not in drv:
                continue
            iters += lv["iters"]
            passes += drv["dct_kernel_iters"]
    return 100.0 * passes / iters if iters else None
