"""90th percentile of every call's wall in the window (host clock, from
the call to its return and a ``torch.cuda.synchronize()``)."""
import statistics


def read(run):
    walls = [c.t1 - c.t0 for c in run.calls]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
