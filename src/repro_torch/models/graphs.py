"""CUDA graphs of a model step, keyed by the addresses they bake in.

A graph replays the kernels its capture recorded, at the addresses the
capture saw.  :class:`StepGraphs` keys each graph on the data pointer,
shape, stride and dtype of every parameter and cache leaf, and on the
shapes and dtypes of the step's small inputs (``tokens``, ``pos``), which
the graph reads from static copies.  A step whose key has a graph copies
its inputs into them and replays; a key seen once before is captured and
replayed; a key seen for the first time runs eagerly (that first run loads
every kernel the shapes need before a capture could try to).  The steps
are in place on the caches, so a key runs its step exactly once whichever
way it goes.

Counting stays what eager steps give.  While the stream captures,
``CudaKernel`` counts no launch and notes it in :data:`build.CAPTURED`, and
the capture installs its own kernel hook (``kernels.common.WORK.counter``)
that records each wrapper's report.  Each replay adds the captured launches
to each ``KERNEL.launches`` and, under an active hook, reports the recorded
calls to it again, with the graph's static inputs replaced by the caller's
tensors of this step.  Operands the graph made itself are passed as
tensors of their own shape on the ``meta`` device, so a recorded call
keeps no device memory alive, except small integer ones (the hook reads
their values), which keep theirs.
"""
from __future__ import annotations

import functools
from collections import OrderedDict

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import obs
from repro_torch.distributed.sharding import active
from repro_torch.kernels import build
from repro_torch.kernels.common import WORK

#: graphs kept per model; a key past it is captured again when it recurs
GRAPHS = 16
#: keys remembered as seen once
SEEN = 64
#: integer operands of at most this many elements keep their own storage in
#: a recorded call (the kernel hook reads their values after the step)
SMALL = 64


class _Recorder:
    """The kernel hook while a step is captured: each wrapper's report
    (name, work function, operands, nested reports), in launch order."""

    def __init__(self) -> None:
        self.calls: list = []
        self._into = self.calls

    def kernel(self, name: str, work, fn, *args, **kwargs):
        outer, children = self._into, []
        outer.append((name, work, args, kwargs, children))
        self._into = children
        try:
            return fn(*args, **kwargs)
        finally:
            self._into = outer


def _stand_in(x, static: dict):
    if not isinstance(x, torch.Tensor) or id(x) in static:
        return x
    if x.numel() <= SMALL and not x.is_floating_point():
        return x
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")


def _kept(calls: list, static: dict) -> list:
    return [(name, work, tuple(_stand_in(a, static) for a in args),
             {k: _stand_in(v, static) for k, v in kwargs.items()}, _kept(children, static))
            for name, work, args, kwargs, children in calls]


def _report(counter, calls: list, swap: dict, *_args, **_kwargs) -> None:
    """Report recorded calls to ``counter`` as the eager step would, nested
    as they were; a static input becomes the caller's tensor.  Takes (and
    ignores) the operands of the report it runs inside."""
    for name, work, args, kwargs, children in calls:
        args = tuple(swap.get(id(a), a) for a in args)
        kwargs = {k: swap.get(id(v), v) for k, v in kwargs.items()}
        counter.kernel(name, work, functools.partial(_report, counter, children, swap),
                       *args, **kwargs)


class _Graph:
    __slots__ = ("graph", "inputs", "out", "launches", "calls")

    def __init__(self, graph, inputs, out, launches, calls) -> None:
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.launches = launches
        self.calls = calls


def _plain(x) -> bool:
    return type(x) is torch.Tensor or type(x) is torch.nn.Parameter


class StepGraphs:
    """One model's captured steps, least recently used dropped first.

    ``replays`` counts steps served from a graph captured at an earlier
    step; ``captures`` the steps that captured a graph (and replayed it).
    """

    def __init__(self) -> None:
        self._graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self._streams: dict = {}
        self.replays = 0
        self.captures = 0

    @staticmethod
    def applies(leaves: list, *inputs) -> bool:
        """Whether a step over ``leaves`` and ``inputs`` may run from a
        graph: plain tensors, all on one CUDA device, no gradient, no
        sharding rules and no dispatch mode (a counter of every operation)
        active."""
        dev = inputs[0].device
        return (dev.type == "cuda" and not torch.is_grad_enabled() and active() is None
                and _get_current_dispatch_mode() is None
                and all(_plain(x) and x.device == dev for x in (*leaves, *inputs)))

    def run(self, step, leaves: list, inputs: tuple):
        """``step(*inputs)`` (one output tensor) from a graph when its key
        recurs; a fresh copy of the output either way."""
        key = (tuple((x.data_ptr(), x.shape, x.stride(), x.dtype) for x in leaves),
               tuple((x.shape, x.dtype) for x in inputs))
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            for static, x in zip(g.inputs, inputs):
                static.copy_(x)
            self.replays += 1
        elif key in self._seen:
            del self._seen[key]
            with obs.span("serve.capture"):
                g = self._capture(step, inputs)
            self._graphs[key] = g
            if len(self._graphs) > GRAPHS:
                self._graphs.popitem(last=False)[1].graph.reset()
            self.captures += 1
        else:
            self._seen[key] = None
            if len(self._seen) > SEEN:
                self._seen.popitem(last=False)
            return step(*inputs)
        g.graph.replay()
        for kernel, n in g.launches.items():
            kernel.launches += n
        counter = getattr(WORK, "counter", None)
        if counter is not None:
            _report(counter, g.calls, {id(s): x for s, x in zip(g.inputs, inputs)})
        return g.out.clone()

    def _capture(self, step, inputs: tuple) -> _Graph:
        dev = inputs[0].device
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        static = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        rec, launches = _Recorder(), {}
        outer = getattr(WORK, "counter", None)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            WORK.counter, build.CAPTURED.launches = rec, launches
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = step(*static)
                finally:
                    graph.capture_end()
        finally:
            WORK.counter, build.CAPTURED.launches = outer, None
        torch.cuda.current_stream(dev).wait_stream(stream)
        ids = {id(s): s for s in static}
        return _Graph(graph, static, out, launches, _kept(rec.calls, ids))
