"""What a traced run (``--trace 1``) reads: the shapes of every kernel launch
and the profiler's trace of the card.

:class:`LaunchLog` sits on the port's kernel hook (the thread's
``kernels.common.WORK.counter``, through which every kernel wrapper runs its
body) and keeps each launch's shapes and its small device operands (``pos``,
``t_real``) by reference; they are read on the host once the window has
closed, so the window itself never waits for them.  Its operations and bytes
are this benchmark's own (``bench/work.py``), not the program's.

:class:`DeviceTrace` is ``torch.profiler`` over the window, entered after a
lead-in launch and a synchronise (the profiler has been seen to miss a short
session's first launches) and left after a synchronise.  The harness's own
spans are ``record_function`` ranges, on the profiler's clock, so an idle gap
on the card is put down to the span the host was in.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

import torch

from bench import core

WINDOW = "bench.window"
#: integer operands of at most this many elements are kept (by reference)
#: and read after the window: ``pos`` and ``t_real``; the others give their
#: shape
SMALL = 64


class LaunchLog:
    """The thread's kernel counter: records each outermost launch."""

    def __init__(self) -> None:
        self.launches: dict[str, list] = defaultdict(list)
        self._depth = 0

    def kernel(self, name: str, work, fn, *args, **kwargs):
        if self._depth:
            return fn(*args, **kwargs)
        self.launches[name].append(
            ([_describe(a) for a in args], {k: _describe(v) for k, v in kwargs.items()}))
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1

    def resolved(self) -> dict[str, list]:
        """Each launch as (args, kwargs) with small tensors as host lists
        and large ones as {"shape", "elt"}; call after a synchronise."""
        return {name: [([_resolve(a) for a in args], {k: _resolve(v) for k, v in kw.items()})
                       for args, kw in calls]
                for name, calls in self.launches.items()}


def _describe(x):
    if isinstance(x, torch.Tensor):
        if x.numel() <= SMALL and not x.is_floating_point():
            return ("small", x)
        return ("big", tuple(x.shape), x.element_size())
    return ("value", x)


def _resolve(d):
    kind = d[0]
    if kind == "small":
        return d[1].detach().cpu().reshape(-1).tolist()
    if kind == "big":
        return {"shape": d[1], "elt": d[2]}
    return d[1]


@contextlib.contextmanager
def launch_log():
    """Install a :class:`LaunchLog` as this thread's kernel counter."""
    from repro_torch.kernels.common import WORK

    old = getattr(WORK, "counter", None)
    log = LaunchLog()
    WORK.counter = log
    try:
        yield log
    finally:
        WORK.counter = old


def kernel_counts() -> dict[str, int]:
    """``KERNEL.launches`` of every kernel module of the port loaded so far."""
    import sys

    return {name: mod.KERNEL.launches for name, mod in list(sys.modules.items())
            if name.startswith("repro_torch.kernels.") and name.endswith(".kernel")
            and hasattr(mod, "KERNEL")}


class DeviceTrace:
    """``torch.profiler`` (host and card) over one window."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._prof = None
        self._window = None
        self.summary: dict = {}
        #: each kernel module's launches inside the window
        self.launches: dict[str, int] = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        # the lead-in: one launch and a synchronise before the window opens
        torch.zeros(1 << 16, device=self.device).add_(1.0)
        core.sync(self.device)
        self._launches0 = kernel_counts()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        core.sync(self.device)
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        self.launches = {k: v - self._launches0.get(k, 0) for k, v in kernel_counts().items()}
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events())
        return False


def span(name: str):
    """A harness span on the profiler's clock."""
    from torch.profiler import record_function

    return record_function(name)


def summarize(events) -> dict:
    """The window's device activity: ``window_s``; ``busy_s``, the union of
    the intervals in which an operation ran on the card; each device
    operation's seconds and count by name; and the idle gaps on the card,
    summed by the harness span the host was in at the gap's middle."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not win:
        return {}
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    dev, spans = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.name().startswith("bench."):
            # the harness's spans; on the card's timeline they are
            # annotations, not work
            if e.device_type() == DeviceType.CPU and e.name() != WINDOW:
                spans.append((s, s + d, e.name()))
        elif e.device_type() == DeviceType.CUDA:
            if s >= w0 and s < w1:
                dev.append((s, min(s + d, w1), e.name()))
    ops: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        ops[name][0] += (t - s) * 1e-9
        ops[name][1] += 1
    busy, gaps = 0, []
    cur_s = cur_t = None
    last = w0
    for s, t, _ in sorted(dev):
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        last = max(last, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    if w1 > last:
        gaps.append((last, w1))
    # the harness's spans follow one another (none nests in another)
    idle: dict[str, float] = defaultdict(float)
    spans.sort()
    starts = [sp[0] for sp in spans]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][2] if i >= 0 and mid < spans[i][1] else "bench.other"
        idle[name] += (g1 - g0) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "ops": {k: {"s": v[0], "count": v[1]} for k, v in ops.items()},
            "idle_by_span": dict(idle)}


def kernel_time(summary: dict, names) -> tuple[float, int, int]:
    """(seconds, count of the first name, count of every name) of the device
    operations that name any of the kernels ``names`` (as a whole word):
    the first is the kernel that each launch runs once."""
    secs, first, total = 0.0, 0, 0
    for op, v in summary.get("ops", {}).items():
        hit = [n for n in names if re.search(rf"\b{n}\b", op)]
        if hit:
            secs += v["s"]
            total += v["count"]
            if hit[0] == names[0]:
                first += v["count"]
    return secs, first, total


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary.get("ops", {}).items(), key=lambda kv: -kv[1]["s"])[:top]
    gaps = sorted(summary.get("idle_by_span", {}).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], v["s"]] for name, v in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
