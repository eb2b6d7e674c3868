"""``bench/spans.py`` on hand-built profiler events: the program's ranges
are not device work, idle time goes to the innermost program span the host
was in at each instant, a device operation to the innermost program span at
its launch (paired by its own correlation id), ``outside`` where none holds
the point; and the readings over the totals."""
import sys

import pytest
from torch.autograd import DeviceType

from bench import spans, trace


class Ev:
    """The part of ``torch._C._autograd._KinetoEvent`` that is read."""

    def __init__(self, name, s, d, *, dev="cpu", corr=0, linked=0, tid=1):
        self._v = (name, DeviceType.CUDA if dev == "cuda" else DeviceType.CPU, s, d,
                   corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def annotated(name, s, d):
    """A range on the host and its annotation on the card's timeline."""
    return [Ev(name, s, d), Ev(name, s, d, dev="cuda")]


def launch(corr, at, s, d, name="kern"):
    return [Ev("cudaLaunchKernel", at, 5, corr=corr),
            Ev(name, s, d, dev="cuda", corr=corr, linked=corr)]


def window(d=2000):
    return annotated(trace.WINDOW, 0, d)


def events():
    """serve.step [100, 1000) holding serve.decode [150, 400) and
    serve.readback [400, 900); a harness span bench.step [90, 1010); a
    kernel launched in serve.decode runs [200, 300), one launched outside
    any span runs [1100, 1200); a cpu operator shares the first kernel's
    correlation id number, as host operators count their own ids."""
    return (window() + annotated("bench.step", 90, 920) + annotated("serve.step", 100, 900)
            + annotated("serve.decode", 150, 250) + annotated("serve.readback", 400, 500)
            + launch(7, 160, 200, 100) + launch(8, 1050, 1100, 100)
            + [Ev("aten::add", 950, 10, corr=7)])


def test_program_ranges_are_not_device_work():
    ev = events()
    got = spans.summarize(ev)
    assert got["busy_s"] == pytest.approx(200e-9)
    assert set(got["ops"]) == {"kern"} and got["ops"]["kern"]["count"] == 2
    # the harness's own reading of the same events without the program's
    # annotations is kept key for key
    plain = trace.summarize([e for e in ev if not e.name().startswith(spans.PROGRAM)])
    assert {k: got[k] for k in plain} == plain
    # left in, the annotations would read as work
    assert trace.summarize(ev)["busy_s"] > got["busy_s"]


def test_idle_goes_to_the_innermost_span_at_each_instant():
    got = spans.summarize(events())
    idle = got["idle_by_program_span"]
    # gaps [0, 200), [300, 1100), [1200, 2000), split where spans start and
    # end: outside 100 + 100 + 800, serve.step 50 + 100, serve.decode 50 +
    # 100, serve.readback 500
    assert idle == pytest.approx({"outside": 1000e-9, "serve.step": 150e-9,
                                  "serve.decode": 150e-9, "serve.readback": 500e-9})
    assert sum(idle.values()) == pytest.approx(got["window_s"] - got["busy_s"])


def test_device_time_goes_to_the_span_of_its_launch():
    got = spans.summarize(events())
    assert got["device_by_program_span"] == pytest.approx(
        {"serve.decode": 100e-9, "outside": 100e-9})


def test_own_correlation_id_pairs_and_unlinked_operations():
    # a copy's linked id names another runtime call (outside any span): only
    # its own correlation id pairs it; an operation whose own id has no
    # launch in the trace is unlinked, whatever its linked id
    ev = window() + annotated("serve.step", 100, 900)
    ev += [Ev("cudaMemcpyAsync", 120, 5, corr=3), Ev("cudaLaunchKernel", 1500, 5, corr=4),
           Ev("Memcpy HtoD", 130, 10, dev="cuda", corr=3, linked=4),
           Ev("kern2", 500, 10, dev="cuda", corr=99, linked=3)]
    got = spans.summarize(ev)
    assert got["device_by_program_span"] == pytest.approx(
        {"serve.step": 10e-9, "unlinked": 10e-9})


def test_other_threads_spans_are_ignored():
    ev = window() + launch(1, 450, 500, 10)
    ev += [Ev("serve.store_put", 400, 200, tid=2)]
    got = spans.summarize(ev)
    assert set(got["idle_by_program_span"]) == {"outside"}
    assert got["device_by_program_span"] == {"outside": pytest.approx(10e-9)}


def test_a_program_without_spans_reads_outside():
    ev = window() + annotated("bench.query", 0, 2000) + launch(1, 10, 100, 50)
    got = spans.summarize(ev)
    assert got["idle_by_span"] == pytest.approx({"bench.query": 1950e-9})
    assert got["idle_by_program_span"] == pytest.approx({"outside": 1950e-9})
    assert spans.idle_explained(got, ("analytics.query",)) is None
    assert spans.summarize(launch(1, 10, 100, 50)) == {}


def test_runtime_calls_by_name():
    assert spans.is_runtime("cudaLaunchKernel") and spans.is_runtime("cuLaunchKernel")
    assert spans.is_runtime("cudaMemcpyAsync")
    assert not spans.is_runtime("aten::cumsum") and not spans.is_runtime("serve.step")


def test_innermost_is_half_open_and_nests():
    sp = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (50, 60, "d")]
    pts = [0, 10, 25, 30, 49, 50, 60, 99, 100, -1]
    assert spans.innermost(sp, pts) == ["a", "b", "c", "b", "b", "d", "a", "a",
                                        "outside", "outside"]


def test_program_spans_keep_totals_or_stay_empty(monkeypatch):
    import repro_torch
    from repro_torch import obs

    with spans.program_spans() as got:
        with obs.span("serve.step"):
            pass
        assert got == {}
    assert set(got) == {"serve.step"} and got["serve.step"]["count"] == 1
    # a program without the span module
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    with spans.program_spans() as got:
        assert not obs._ON
    assert got == {}


def test_readings():
    totals = {"serve.submit": {"count": 4, "s": 1.0}, "serve.store_put": {"count": 2, "s": 0.02},
              "serve.writeback": {"count": 3, "s": 0.06}}
    assert spans.span_ms(totals, ["serve.store_put", "serve.writeback"],
                         "serve.submit") == pytest.approx(20.0)
    assert spans.span_ms(totals, ["serve.assemble"], "serve.submit") == 0.0
    assert spans.span_ms({}, ["serve.store_put"], "serve.submit") is None
    summary = {"idle_by_program_span": {"serve.step": 1.0, "serve.submit": 0.5,
                                        "serve.readback": 6.0, "outside": 0.5, "serve.join": 2.0}}
    assert spans.idle_explained(summary, ("serve.step", "serve.submit")) == pytest.approx(80.0)
    assert spans.idle_explained({}, ("serve.step",)) is None
