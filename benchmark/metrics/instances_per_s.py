"""Instances solved to their tolerance in the window, over the window's
time (host clock, from the first call to the return of the last call that
started inside the window). An instance that stopped at maxit or that the
reference found wrong does not count."""


def read(run):
    solved = sum(sum(c.done) for c in run.calls)
    return (solved - run.checks.get("wrong", 0)) / run.window_s
