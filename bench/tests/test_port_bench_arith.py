"""Percentiles and rates over every sample, and the trace's reductions."""
import numpy as np
import pytest
from torch.autograd import DeviceType

from bench import core, trace


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys_linear_rule(q):
    xs = np.random.default_rng(q).exponential(3.0, 257).tolist()
    assert core.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_uses_all_samples():
    assert core.percentile([5.0], 95) == 5.0
    assert core.percentile([], 95) is None
    assert core.percentile([1, 2, 3, 4, 100], 100) == 100


def test_rate_and_mean():
    assert core.rate(300, 30.0) == 10.0
    assert core.rate(0, 30.0) is None and core.rate(5, 0.0) is None
    assert core.mean([1, 2, 3]) == 2 and core.mean([]) is None


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_summarize_busy_union_and_idle_by_span():
    C, G = DeviceType.CPU, DeviceType.CUDA
    events = [
        Ev(trace.WINDOW, C, 1000, 9000),                  # window [1000, 10000)
        Ev("lead_in", G, 500, 100),                       # before the window
        Ev("bench.submit", C, 1000, 2000),
        Ev("bench.step", C, 3000, 7000),
        Ev("void ns::split_kernel<bf16>(...)", G, 3500, 1000),
        Ev("void ns::split_kernel<bf16>(...)", G, 4000, 1000),   # overlaps
        Ev("splitKreduce_kernel", G, 7000, 500),
        Ev("bench.step", G, 3000, 7000),                  # an annotation on the card
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(9000e-9)
    assert s["busy_s"] == pytest.approx(2000e-9)     # [3500, 5000) and [7000, 7500)
    idle = s["idle_by_span"]
    assert idle["bench.submit"] == pytest.approx(2500e-9)   # [1000, 3500)
    assert idle["bench.step"] == pytest.approx(2000e-9 + 2500e-9)
    secs, first, total = trace.kernel_time(s, ("split_kernel", "combine_kernel"))
    assert (first, total) == (2, 2) and secs == pytest.approx(2000e-9)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0].startswith("void ns::split_kernel")
    assert len(b["idle_gaps"]) <= 10


def test_launch_log_keeps_shapes_and_small_integer_operands():
    import torch

    log = trace.LaunchLog()
    q = torch.zeros((1, 1, 4, 16))
    pos = torch.tensor([3, 9], dtype=torch.int32)
    out = log.kernel("decode_attention", None, lambda q, pos: q.sum() + pos.sum(), q, pos=pos)
    assert float(out) == 12.0
    (args, kw), = log.resolved()["decode_attention"]
    assert args[0] == {"shape": (1, 1, 4, 16), "elt": 4} and kw["pos"] == [3, 9]
