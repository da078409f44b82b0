"""``dct_kernel_share`` on hand-made call records: the share of the
window's iterations whose phi-step solve ran the matrix route's passes,
over every level of the window's finished solves."""
import pytest

from benchlib import manifest
from benchlib.cell import Run
from benchlib.traffic import Call


def _run(levels_of_calls, total_time=0.5):
    """One finished solve a list of levels, each (iters, driver dict or
    None), and a failed call that counts for nothing."""
    calls = [Call(slots=[i], t0=float(i), t1=i + 1.0, done=[True],
                  total_time=total_time,
                  levels=[{"iters": it} if d is None else {"iters": it,
                                                           "driver": d}
                          for it, d in levels])
             for i, levels in enumerate(levels_of_calls)]
    calls.append(Call(slots=[9], t0=9.0, t1=10.0, done=[False],
                      levels=[{"iters": 50, "driver": {
                          "checks": 5, "dct_kernel_iters": 50}}]))
    return Run(config={}, card="a card", calls=calls, window_s=10.0,
               setup_s=1.0, peak_window_bytes=0)


def read(run):
    return manifest.reader("dct_kernel_share")(run)


@pytest.mark.parametrize("on, want", [(True, 100.0), (False, 0.0)])
def test_share_of_iterations_on_the_passes(on, want):
    def level(iters):
        return iters, {"checks": 3, "dct_kernel_iters": iters if on else 0}

    run = _run([[level(10000), level(2729), level(69)],
                [level(10000), level(2731), level(69)]])
    assert read(run) == want


def test_share_over_levels():
    """The coarsest level on the passes, the finer on the FFT route: 239 +
    241 of 387 + 390 iterations; a level without a driver left out."""
    def levels(coarse, mid, fine):
        return [(coarse, {"dct_kernel_iters": coarse}),
                (mid, {"dct_kernel_iters": 0}),
                (fine, {"dct_kernel_iters": 0}), (7, None)]

    run = _run([levels(239, 79, 69), levels(241, 79, 70)])
    assert read(run) == pytest.approx(100.0 * (239 + 241) / (387 + 390))


def test_nothing_without_the_counter():
    """A program whose driver reports no ``dct_kernel_iters`` (the
    parent), or a window without a finished solve, reads nothing."""
    assert read(_run([[(20, {"checks": 2, "fast_dct_iters": 0}),
                       (5, None)]])) is None
    assert read(_run([])) is None


def test_zero_iterations():
    """Levels that report the counter but ran no iteration read
    nothing."""
    assert read(_run([[(0, {"dct_kernel_iters": 0})]])) is None
