"""Percent of the device driver's KKT checks whose battery ran its sums on
the hand-written kernel: 100 times the levels' ``driver["kkt_kernel_checks"]``
over their ``driver["checks"]``, summed over the window's solves. Nothing
where no level reports ``kkt_kernel_checks`` (a program without the
counter) or no check ran."""


def read(run):
    checks = on_kernel = 0
    for c in run.calls:
        if c.total_time is None:
            continue
        for lv in c.levels:
            drv = lv.get("driver")
            if drv is None or "kkt_kernel_checks" not in drv:
                continue
            checks += drv["checks"]
            on_kernel += drv["kkt_kernel_checks"]
    return 100.0 * on_kernel / checks if checks else None
