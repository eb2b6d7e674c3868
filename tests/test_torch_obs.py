"""Spans inside the port (``repro_torch.obs``), on the CPU.

Off, a span is one shared object and records nothing; on, totals nest and
count, and every span is a ``record_function`` range a profiler sees.  A
reduced ``SessionManager`` script (async prefill, merged packs) under
``tracing()`` emits every ``serve.*`` span and serves the same greedy
streams, plans, store ids and ``report()`` as with tracing off, but for the
wall-clock fields; an analytics query over an ``ArrayBackend`` emits every
``analytics.*`` span and returns the same model, its ``ExecTimings`` still
summing to ``total_s``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.engine import IncrementalAnalyticsEngine  # noqa: E402
from repro_torch.data.tabular import ArrayBackend  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402
from test_torch_multisession import TIMING_FIELDS  # noqa: E402

SERVE = ("serve.submit", "serve.plan", "serve.assemble", "serve.extend", "serve.store_put",
         "serve.writeback", "serve.step", "serve.join", "serve.sample", "serve.pack",
         "serve.decode", "serve.readback")
ANALYTICS = ("analytics.query", "analytics.plan", "analytics.fetch", "analytics.stats",
             "analytics.combine", "analytics.solve")


def test_off_is_one_shared_object_and_records_nothing():
    with obs.tracing():
        pass
    a, b = obs.span("serve.x"), obs.span("serve.y")
    assert a is b
    with a:
        with b:
            pass
    # a timed site still reads its clock with tracing off, but records nothing
    with obs.timed("serve.z") as t:
        sum(range(1000))
    assert t.s > 0
    assert obs.snapshot() == {}


def test_on_totals_nest_and_count():
    with obs.tracing() as tracer:
        for _ in range(3):
            with obs.span("serve.outer"):
                with obs.timed("serve.inner") as t:
                    sum(range(20000))
                with obs.span("serve.inner"):
                    pass
    snap = obs.snapshot()
    assert snap == tracer.snapshot()
    assert snap["serve.outer"]["count"] == 3 and snap["serve.inner"]["count"] == 6
    assert 0 < t.s < snap["serve.inner"]["s"] < snap["serve.outer"]["s"]
    # a new block starts from zero
    with obs.tracing():
        pass
    assert obs.snapshot() == {}


def test_spans_are_record_function_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.tracing():
            with obs.span("serve.outer"):
                with obs.timed("analytics.inner"):
                    torch.ones(4).add_(1)
        with obs.span("serve.off"):     # tracing off: no range
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("serve.outer") == 1 and names.count("analytics.inner") == 1
    assert "serve.off" not in names


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("deepseek-67b"))
    lm = LM(cfg, device="cpu")
    return cfg, lm, lm.init(torch.Generator().manual_seed(0))


def _serve(model):
    """Two rounds over three sessions: shared segments (a reuse plan), a
    request whose cold build fills gaps, merged packs and write-back."""
    cfg, lm, params = model
    mgr = SessionManager(lm, params, chunk_tokens=32, decode_bucket=32, max_batch=4,
                         async_prefill=True, merge_decode_packs=True)
    rng = np.random.default_rng(0)
    doc_a = rng.integers(0, cfg.vocab_size, 160).astype(np.int32)
    doc_b = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    s1, s2, s3 = mgr.add_session(doc_a), mgr.add_session(doc_a), mgr.add_session(doc_b)
    streams, plans = [], []
    for reqs in ([(s1, 96, 3), (s3, 100, 4)], [(s1, 160, 2), (s2, 128, 3), (s3, 50, 2)]):
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k)
            plans.append([(st.rng.lo, st.rng.hi, st.model_id) for st in plan.steps])
        streams.append(mgr.run())
    return streams, plans, sorted(mgr.store._segs), mgr.report()


def test_serving_emits_every_span_and_serves_the_same(model):
    off = _serve(model)
    with obs.tracing():
        on = _serve(model)
    snap = obs.snapshot()
    assert set(SERVE) <= set(snap), set(SERVE) - set(snap)
    assert snap["serve.submit"]["count"] == 5
    assert on[:3] == off[:3]                    # streams, plans, store ids
    assert any(m is not None for p in on[1] for *_, m in p)
    assert list(on[3]) == list(off[3])
    differ = {k for k in on[3] if on[3][k] != off[3][k]}
    assert differ <= set(TIMING_FIELDS), differ


def test_analytics_emits_every_span_and_keeps_its_timings():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((6000, 4)).astype(np.float32)
    y = (X @ np.arange(1, 5, dtype=np.float32)).astype(np.float32)

    def run():
        eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device="cpu"))
        eng.warm("linreg", [Range(1000, 4500)])
        return eng.query("linreg", Range(1000, 4800))

    off = run()
    with obs.tracing():
        on = run()
    snap = obs.snapshot()
    assert set(ANALYTICS) <= set(snap), set(ANALYTICS) - set(snap)
    assert snap["analytics.query"]["count"] == 1
    assert on.used_reuse and on.plan.models_used
    np.testing.assert_array_equal(on.model.weights, off.model.weights)
    for res in (on, off):
        t = res.timings
        assert min(t.io_s, t.compute_s, t.merge_s) > 0
        assert t.optimizer_s + t.io_s + t.compute_s + t.merge_s == t.total_s
        assert t.optimizer_s == res.plan.optimizer_seconds
    assert on.timings.io_s <= snap["analytics.fetch"]["s"] + 1e-9
    assert on.timings.merge_s == pytest.approx(
        snap["analytics.combine"]["s"] + snap["analytics.solve"]["s"], abs=1e-6)
