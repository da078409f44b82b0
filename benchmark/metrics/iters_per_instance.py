"""Iterations a solved instance took, all levels, from the program's
level reports."""


def read(run):
    if not run.calls:
        return None
    return sum(sum(lv["iters"] for lv in c.levels)
               for c in run.calls) / len(run.calls)
