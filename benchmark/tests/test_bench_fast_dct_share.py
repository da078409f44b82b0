"""``fast_dct_share`` on hand-made call records: the share of the window's
iterations whose phi-step solve took the FFT route, over every level of the
window's finished solves."""
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
                      levels=[{"iters": 50, "driver": {"checks": 5,
                                                       "fast_dct_iters": 50}}]))
    return Run(config={}, card="a card", calls=calls, window_s=10.0,
               setup_s=1.0, peak_window_bytes=0)


def read(run):
    return manifest.reader("fast_dct_share")(run)


@pytest.mark.parametrize("fast, want", [(True, 100.0), (False, 0.0)])
def test_share_of_iterations_on_the_fft_route(fast, want):
    def level(iters):
        return iters, {"checks": 3, "fast_dct_iters": iters if fast else 0}

    run = _run([[level(239), level(79), level(69)],
                [level(241), level(80), level(69)]])
    assert read(run) == want


def test_share_mixes_levels():
    """The finest level fast, the coarser on matrices: 69 + 70 of 387 +
    390 iterations; a level without a driver left out."""
    def levels(coarse, mid, fine):
        return [(coarse, {"fast_dct_iters": 0}), (mid, {"fast_dct_iters": 0}),
                (fine, {"fast_dct_iters": fine}), (7, None)]

    run = _run([levels(239, 79, 69), levels(241, 79, 70)])
    assert read(run) == pytest.approx(100.0 * (69 + 70) / (387 + 390))


def test_nothing_without_the_counter():
    """A program whose driver reports no ``fast_dct_iters`` (the parent),
    or a window without a finished solve, reads nothing."""
    assert read(_run([[(20, {"checks": 2, "syncs": 2}), (5, None)]])) is None
    assert read(_run([])) is None
    assert read(_run([[(0, {"fast_dct_iters": 0})]])) is None
