"""Spans of the solve path: named host ranges on the profiler's clock, and
host seconds for the solve's reports.

``span(name, into=None)`` is a context manager:

- while a ``torch.profiler`` runs in the process (a caller's own
  ``torch.profiler.profile``, ``opts["trace_dir"]`` of ``solve_dot``, a
  benchmark's traced window), it opens
  ``torch.profiler.record_function("dotsocp." + name)``, a host range on
  the clock the card's events are on: an idle gap of the card that no
  runtime call or PyTorch op covers then falls under the step of the solve
  the host was in;
- with ``into`` a dict, it adds the host seconds it was open
  (``time.perf_counter``) to ``into[name + "_s"]``;
- else it does nothing, through one shared object.

Nothing switches the ranges on or off: they exist exactly while a profiler
runs. Spans open per level, per segment of the level loop and per check,
never per graph replay.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

PREFIX = "dotsocp."


class _Span:
    __slots__ = ("name", "into", "_range", "_t0")

    def __init__(self, name: str, into: Optional[dict], profiled: bool):
        self.name = name
        self.into = into
        self._range = (torch.profiler.record_function(PREFIX + name)
                       if profiled else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            key = self.name + "_s"
            self.into[key] = (self.into.get(key, 0.0)
                              + time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, into: Optional[dict] = None):
    """The span ``name`` (see the module's docstring)."""
    profiled = torch.autograd._profiler_enabled()
    if into is None and not profiled:
        return _NO_SPAN
    return _Span(name, into, profiled)
