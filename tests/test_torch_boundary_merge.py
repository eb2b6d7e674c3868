"""The last prefix token rides the plan's ragged last gap.

``PrefixCacheBuilder.dispatch_prefix`` plans [0, prefix_len - 1).  Where
that plan ends in a ragged gap, the gap's extend runs over [lo, prefix_len)
and its last-position logits are the request's first distribution; where it
ends on a reuse step, or the cache tree holds running state (SSD), the last
token runs through a 1-token extend of its own.  Held, on reduced stacks in
fp32 with the port's own weights (``LM.init``), against the two-extend
sequence (the build of [0, prefix_len - 1), then a 1-token extend):

* dense GQA (``deepseek-67b``) and MLA + MoE (``deepseek-v2-236b``): logits
  and every sequence leaf over [0, prefix_len) within ``ATOL``, the stored
  segments' ids and ranges, ``tokens_computed``, and one model extend for
  the gap's remainder and the last token together; a repeat whose plan
  ends on a reuse step runs the 1-token extend;
* SSD (``mamba2-130m``): two extends, and the stored ragged segment's
  state leaves and the logits bitwise the two-extend ones;
* ``SessionManager.report()``'s ``boundary_merged_share``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.common import (CACHE_SEQ_KEYS, CACHE_STATE_KEYS,  # noqa: E402
                                       cache_leaf_key, tree_items_sorted)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import PrefixCacheBuilder, ServeStats  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402

CHUNK = 32
#: fp32: a remainder extended one token longer against the two extends
ATOL = 1e-5
#: (prefix_len, the extend calls' (tokens, start) when the last token
#: rides the remainder): cold [0, 99) = prefill 32, two chunks, 3 ragged;
#: then [99, 139) over the stored [0, 99) = one chunk, 8 ragged; then a
#: repeat of 100, whose plan ends on the stored [96, 99)
REQUESTS = [(100, [(32, 32), (32, 64), (4, 96)]),
            (140, [(32, 99), (9, 131)]),
            (100, [(1, 99)])]


def _stack(arch):
    cfg = reduced(get_config(arch))
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 160).astype(np.int32)
    return model, params, doc


@pytest.fixture(scope="module", params=["deepseek-67b", "deepseek-v2-236b"])
def stateless(request):
    return _stack(request.param)


@pytest.fixture(scope="module")
def ssd():
    return _stack("mamba2-130m")


def _record_extends(model, monkeypatch) -> list:
    """Every ``prefill_extend`` call's (tokens, start), multi-chunk
    extends' chunks included (they call it per chunk)."""
    calls = []
    inner = model.prefill_extend

    def rec(params, caches, tokens, start):
        calls.append((tokens.shape[1], int(start)))
        return inner(params, caches, tokens, start)

    monkeypatch.setattr(model, "prefill_extend", rec)
    return calls


def _two_extends(b, doc, prefix_len, stats):
    """The two-extend sequence: the build of [0, prefix_len - 1), then the
    last prefix token alone."""
    caches, _, pending, merged = b._dispatch_build(
        doc, prefix_len - 1, doc_id="d", extras={}, stats=stats,
        materialize=True, requester=None, capacity=prefix_len)
    assert merged is None
    logits, caches = b.model.prefill_extend(
        b.params, caches, b._tokens(doc[None, prefix_len - 1:prefix_len]),
        b._scalar(prefix_len - 1))
    stats.tokens_computed += 1
    b.finish(pending, stats)
    return logits, caches


def _ranges(store):
    return sorted((s.rng.lo, s.rng.hi) for s in store._segs.values())


def _leaves(caches, keys, upto=None):
    return [(p, x[:, :, :upto] if upto is not None else x)
            for p, x in tree_items_sorted(caches) if cache_leaf_key(p) in keys]


def test_last_token_rides_ragged_gap(stateless, monkeypatch):
    model, params, doc = stateless
    ref = PrefixCacheBuilder(model, params, SegmentStore(), chunk_tokens=CHUNK)
    b = PrefixCacheBuilder(model, params, SegmentStore(), chunk_tokens=CHUNK)
    rstats, stats = ServeStats(), ServeStats()
    calls = _record_extends(model, monkeypatch)
    for prefix_len, extends in REQUESTS:
        want, want_caches = _two_extends(ref, doc, prefix_len, rstats)
        del calls[:]
        logits, caches, plan, pending = b.dispatch_prefix(
            doc, prefix_len, doc_id="d", stats=stats, capacity=prefix_len)
        b.finish(pending, stats)
        assert calls == extends, (prefix_len, calls)
        torch.testing.assert_close(logits, want, rtol=0, atol=ATOL)
        got = _leaves(caches, CACHE_SEQ_KEYS, prefix_len)
        for (p, x), (q, y) in zip(got, _leaves(want_caches, CACHE_SEQ_KEYS, prefix_len)):
            assert p == q
            torch.testing.assert_close(x, y, rtol=0, atol=ATOL)
        assert got
        assert stats.tokens_computed == rstats.tokens_computed
        assert sorted(b.store._segs) == sorted(ref.store._segs)
    # the ragged segments end where the plans of [0, prefix_len - 1) end
    assert _ranges(b.store) == [(0, 32), (32, 64), (64, 96), (96, 99),
                                (99, 131), (131, 139)]
    # every token of [0, 139) once, and each request's last token
    assert stats.tokens_computed == 139 + 3
    assert (b.boundary_merged, b.boundary_alone) == (2, 1)
    assert b.boundary_merged_share == 2 / 3


def test_running_state_keeps_two_extends(ssd, monkeypatch):
    model, params, doc = ssd
    ref = PrefixCacheBuilder(model, params, SegmentStore(), chunk_tokens=CHUNK)
    b = PrefixCacheBuilder(model, params, SegmentStore(), chunk_tokens=CHUNK)
    want, _ = _two_extends(ref, doc, 100, ServeStats())
    calls = _record_extends(model, monkeypatch)
    logits, _, _, pending = b.dispatch_prefix(doc, 100, doc_id="d", capacity=100)
    b.finish(pending, ServeStats())
    assert calls == [(32, 32), (32, 64), (3, 96), (1, 99)]
    assert (b.boundary_merged, b.boundary_alone) == (0, 1)
    assert torch.equal(logits, want)
    assert _ranges(b.store) == _ranges(ref.store) == [(0, 32), (32, 64), (64, 96), (96, 99)]
    (sid,) = [s for s, seg in b.store._segs.items() if seg.rng.lo == 96]
    got = _leaves(b.store._segs[sid].caches, CACHE_STATE_KEYS)
    assert got
    for (p, x), (q, y) in zip(got, _leaves(ref.store._segs[sid].caches, CACHE_STATE_KEYS)):
        assert p == q and torch.equal(x, y)


@pytest.mark.parametrize("prefixes, share", [((100, 140), 1.0), ((100, 100), 0.5)],
                         ids=["ragged", "reuse_end"])
def test_report_boundary_merged_share(stateless, prefixes, share):
    """Two requests in turn over one document: 1.0 where both plans end in
    a ragged gap; 0.5 where the second repeats the first, its plan ending
    on the stored ragged segment."""
    model, params, doc = stateless
    mgr = SessionManager(model, params, chunk_tokens=CHUNK)
    sid = mgr.add_session(doc)
    for prefix_len in prefixes:
        mgr.submit(sid, prefix_len, 2)
        mgr.run()
    assert mgr.report()["boundary_merged_share"] == share
