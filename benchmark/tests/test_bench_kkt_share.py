"""``kkt_kernel_share`` on hand-made call records: the share of the
device driver's checks whose battery ran the kernel, over every level of
the window's finished solves."""
import pytest

from benchlib import manifest
from benchlib.cell import Run
from benchlib.traffic import Call


def _run(drivers, total_time=0.5):
    """One finished solve a list of level ``driver`` dicts (None: a level
    without one), and a failed call that counts for nothing."""
    calls = [Call(slots=[i], t0=float(i), t1=i + 1.0, done=[True],
                  total_time=total_time,
                  levels=[{"iters": 10} if d is None else {"iters": 10,
                                                           "driver": d}
                          for d in levels])
             for i, levels in enumerate(drivers)]
    calls.append(Call(slots=[9], t0=9.0, t1=10.0, done=[False],
                      levels=[{"driver": {"checks": 50,
                                          "kkt_kernel_checks": 0}}]))
    return Run(config={}, card="a card", calls=calls, window_s=10.0,
               setup_s=1.0, peak_window_bytes=0)


def read(run):
    return manifest.reader("kkt_kernel_share")(run)


@pytest.mark.parametrize("on_kernel, want", [(True, 100.0), (False, 0.0)])
def test_share_of_checks_on_the_kernel(on_kernel, want):
    def drv(checks):
        return {"checks": checks,
                "kkt_kernel_checks": checks if on_kernel else 0}

    run = _run([[drv(20), drv(14), drv(9)], [drv(21), drv(13), drv(10)]])
    assert read(run) == want


def test_share_mixes_levels():
    """3 of 4 checks on the kernel, a level without a driver left out."""
    run = _run([[{"checks": 3, "kkt_kernel_checks": 3}, None],
                [{"checks": 1, "kkt_kernel_checks": 0}]])
    assert read(run) == pytest.approx(75.0)


def test_nothing_without_the_counter():
    """A program whose driver reports no ``kkt_kernel_checks`` (the parent),
    or a window without a finished solve, reads nothing."""
    assert read(_run([[{"checks": 20, "syncs": 20}, None]])) is None
    assert read(_run([])) is None
    assert read(_run([[{"checks": 0, "kkt_kernel_checks": 0}]])) is None
