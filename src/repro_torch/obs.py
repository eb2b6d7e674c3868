"""Spans: named host time inside the program, on the profiler's clock.

``span(name)`` marks a region.  With tracing off (the default) it returns one
shared object that does nothing, so a marked site costs a flag read and a
call.  Inside ``tracing()`` each span adds its ``perf_counter_ns`` time and
one call to a total per name, and opens a profiler range under the same name
(``record_function``'s), so a profiler over the same seconds puts the range
on its timeline beside the card's operations.  Spans nest; a name's total is
the time inside it, children included.

``timed(name)`` is a span for a site the program always times: it reads the
clock whether or not tracing is on and leaves the seconds in ``.s``, so the
program's own timer (``ServeStats.planner_s``, ``SchedulerStats.join_wait_s``,
``ExecTimings``) and the span share one reading.

Names: ``serve.*`` for the serving path, ``analytics.*`` for the analytics
engine.  There are no per-kernel spans: a kernel's launch is reported
through ``kernels.common.WORK.counter``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Tracer:
    """Calls and nanoseconds per span name."""

    def __init__(self) -> None:
        self.totals: dict[str, list[int]] = defaultdict(lambda: [0, 0])

    def add(self, name: str, ns: int) -> None:
        t = self.totals[name]
        t[0] += 1
        t[1] += ns

    def snapshot(self) -> dict:
        return {name: {"count": c, "s": ns * 1e-9} for name, (c, ns) in self.totals.items()}


#: a ``record_function`` range: the C++ context manager where torch has it
#: (a twentieth of ``torch.profiler.record_function``'s host time)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

#: the totals of the latest ``tracing()`` block; ``_ON`` is the switch
_TRACER = Tracer()
_ON = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "s", "_t0", "_rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self.s = 0.0

    def __enter__(self):
        self._rf = None
        if _ON:
            self._rf = _RANGE(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self.s = ns * 1e-9
        if self._rf is not None:
            _TRACER.add(self.name, ns)
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A traced region (nothing at all while tracing is off)."""
    return _Span(name) if _ON else _OFF


def timed(name: str) -> _Span:
    """A region whose seconds the caller reads from ``.s`` after it, traced
    as ``span(name)`` while tracing is on."""
    return _Span(name)


@contextlib.contextmanager
def tracing():
    """Zero the totals, turn tracing on for the block, yield the tracer."""
    global _ON
    _TRACER.totals.clear()
    _ON = True
    try:
        yield _TRACER
    finally:
        _ON = False


def snapshot() -> dict:
    """``{name: {"count", "s"}}`` of the latest ``tracing()`` block."""
    return _TRACER.snapshot()
