"""The program's own spans in a traced window (``repro_torch.obs``).

The program marks its layers with spans named ``serve.*`` and
``analytics.*``; while ``obs.tracing()`` is on, each is a
``record_function`` range on the profiler's clock.  :func:`program_spans`
turns them on for a block and keeps their totals; :func:`summarize` reads a
profiler's events as :func:`bench.trace.summarize` does, with the program's
ranges left out of the device operations (on the card's timeline they are
annotations, not work), and adds

- ``idle_by_program_span``: the idle seconds on the card, by the innermost
  program span that the host thread was in at each instant: a gap that
  outlasts one span is split over the spans it overlaps (a gap across
  several queries would otherwise go whole to the span at its middle);
- ``device_by_program_span``: each device operation's seconds, by the
  innermost program span that held its launch.  A device operation and the
  host runtime call that enqueued it share ``correlation_id()``; its
  ``linked_correlation_id()`` counts something else on torch 2.11 (host
  operators' ids, which collide with the runtime's).

Where no program span holds the point the name is ``outside``; a device
operation whose launch is not in the trace reads ``unlinked``.  A program
without the span module gives no program span, so every gap and operation
reads ``outside``.  :func:`span_ms` and :func:`idle_explained` are the
arithmetic of the per-layer readings over these.

The cells' drivers and ``bench/trace.py`` do not call this module yet
(``PERF.md`` §7 lists the edits that wire it in).
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

from bench import trace

#: name prefixes of the program's spans
PROGRAM = ("serve.", "analytics.")
#: where no program span holds the point
OUTSIDE = "outside"


def is_runtime(name: str) -> bool:
    """A host event of the CUDA runtime or driver (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``...): the calls that enqueue
    device work.  Their correlation ids are the device operations' own,
    where a host operator's (``aten::...``) count something else."""
    return name.startswith("cu") and "::" not in name


@contextlib.contextmanager
def program_spans():
    """The program's spans on for the block; yields a dict that holds their
    totals (``{name: {"count", "s"}}``) once the block has closed, and stays
    empty where the program has no span module."""
    out: dict = {}
    try:
        from repro_torch import obs
    except ImportError:
        yield out
        return
    with obs.tracing() as tracer:
        yield out
    out.update(tracer.snapshot())


def summarize(events) -> dict:
    """:func:`bench.trace.summarize` of the events less the program's
    annotations on the card, with ``idle_by_program_span`` and
    ``device_by_program_span`` added."""
    from torch.autograd import DeviceType

    work = [e for e in events
            if not (e.device_type() == DeviceType.CUDA and e.name().startswith(PROGRAM))]
    out = trace.summarize(work)
    if not out:
        return out
    win = next(e for e in work if e.name() == trace.WINDOW and e.device_type() == DeviceType.CPU)
    w0 = win.start_ns()
    w1 = w0 + win.duration_ns()
    thread = win.start_thread_id()
    dev, prog, launch = [], [], {}
    for e in work:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench.") and w0 <= s < w1:
                dev.append((s, min(s + d, w1), e.correlation_id()))
        elif name.startswith(PROGRAM):
            if e.start_thread_id() == thread:
                prog.append((s, s + d, name))
        elif is_runtime(name):
            launch[e.correlation_id()] = s
    dev.sort()
    at = [launch.get(c) for _, _, c in dev]
    busy: dict[str, float] = defaultdict(float)
    for (s, t, _), a, name in zip(dev, at, innermost(prog, [-1 if a is None else a
                                                            for a in at])):
        busy["unlinked" if a is None else name] += (t - s) * 1e-9
    out["idle_by_program_span"] = split(idle_gaps(dev, w0, w1), prog)
    out["device_by_program_span"] = dict(busy)
    return out


def idle_gaps(dev, w0: int, w1: int) -> list[tuple[int, int]]:
    """The intervals of [w0, w1) in which none of the device operations
    ``dev`` ((start, end, ...), sorted) ran."""
    gaps, last = [], w0
    for s, t, *_ in dev:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    return gaps


def split(gaps, spans) -> dict[str, float]:
    """Seconds of ``gaps`` under each innermost span of ``spans`` ((start,
    end, name), nested as one thread's are), ``OUTSIDE`` under none."""
    # the timeline cut where a span starts or ends: one innermost span (or
    # none) over each piece
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    under = innermost(spans, cuts)
    out: dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        k = bisect.bisect_right(cuts, g0) - 1
        t = g0
        while t < g1:
            end = min(cuts[k + 1], g1) if k + 1 < len(cuts) else g1
            out[under[k] if k >= 0 else OUTSIDE] += (end - t) * 1e-9
            t, k = end, k + 1
    return dict(out)


def innermost(spans, points) -> list[str]:
    """The name of the innermost of ``spans`` ((start, end, name), nested as
    one thread's are) that holds each of ``points``, or ``OUTSIDE``; in the
    order of ``points``."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    out = [OUTSIDE] * len(points)
    stack: list = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        p = points[j]
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
    return out


def span_ms(spans: dict, names, per: str):
    """Milliseconds inside the spans ``names`` per call of the span ``per``,
    from :func:`program_spans`' totals; None without a ``per`` span."""
    n = spans.get(per, {}).get("count")
    if not n:
        return None
    return 1e3 * sum(spans[k]["s"] for k in names if k in spans) / n


def idle_explained(summary: dict, top) -> float | None:
    """Percent of the card's idle seconds whose innermost program span lies
    below the top-level spans ``top``: neither one of them nor ``OUTSIDE``;
    None where no gap falls in a program span."""
    idle = summary.get("idle_by_program_span") or {}
    total = sum(idle.values())
    if total <= 0 or set(idle) <= {OUTSIDE}:
        return None
    return 100.0 * sum(v for k, v in idle.items() if k not in (*top, OUTSIDE)) / total
