"""Percent of the window's iterations whose weighted q-step and phi-step
rhs ran on the hand kernels: 100 times the levels'
``driver["weighted_kernel_iters"]`` over their ``iters``, summed over the
window's solves. Nothing where no level reports the counter (a program
without it) or no iteration ran."""


def read(run):
    iters = on_kernel = 0
    for c in run.calls:
        if c.total_time is None:
            continue
        for lv in c.levels:
            drv = lv.get("driver")
            if drv is None or "weighted_kernel_iters" not in drv:
                continue
            iters += lv["iters"]
            on_kernel += drv["weighted_kernel_iters"]
    return 100.0 * on_kernel / iters if iters else None
