"""Batched multi-session serving in the port: ``repro_torch.serve.session``.

The contracts of ``tests/test_multisession.py`` held inside the port, at
that file's size (reduced ``deepseek-67b``, two 192-token documents, chunk
32, decode bucket 32), with ``repro``'s parameters (``LM.init`` through
``params_from_jax``): cross-session reuse, isolation across documents,
``doc_key`` with extras, idle release, the global budget, batched equals
single-session decode, ragged lengths, async equals sync prefill (tokens,
store contents and snapshot manifest under eviction), ticket pins, forced
joins, capacity-split and merged packs, and a finite idle report.

Then the port against ``repro`` on one script: the same greedy streams,
plans and segment ids, and ``report()`` with ``repro``'s keys, then the
port's own (``PORT_REPORT_KEYS``), and ``repro``'s values except the
timing fields and ``decode_attn_flops``, which counts what each
package's decode route reads (the port's kernel: whole splits of 128
positions per row).

Last, storage: no stored leaf shares storage with a live decode pack or a
session cache, and each owns exactly its own bytes, after decode
write-back, a document edit and a 1-row pack, so the in-place decode
write can never reach store bytes.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.session import SessionManager as JaxManager  # noqa: E402
from repro.serve.session import doc_key as jax_doc_key  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.store import MANIFEST_NAME  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import (SegmentStore, cache_len,  # noqa: E402
                                        cache_nbytes, slice_cache)
from repro_torch.serve.session import (PORT_REPORT_KEYS, SessionManager,  # noqa: E402
                                       batch_caches, doc_key, split_caches)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("deepseek-67b"))
    cfg = reduced(get_config("deepseek-67b"))
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    doc_a = rng.integers(0, cfg.vocab_size, 192).astype(np.int32)
    doc_b = rng.integers(0, cfg.vocab_size, 192).astype(np.int32)
    return cfg, model, params, doc_a, doc_b, jm, jparams


def _mgr(setup, **kw):
    _, model, params, *_ = setup
    kw.setdefault("chunk_tokens", 32)
    kw.setdefault("decode_bucket", 32)
    return SessionManager(model, params, **kw)


def _engine(setup, doc, **kw):
    _, model, params, *_ = setup
    return ServeEngine(model, params, doc, chunk_tokens=32, device="cpu", **kw)


# ---------------------------------------------------------------------------
# shared SegmentStore semantics
# ---------------------------------------------------------------------------

def test_cross_session_reuse_same_document(setup):
    doc_a = setup[3]
    mgr = _mgr(setup)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a)
    mgr.submit(s1, 128, 2)
    mgr.run()
    computed_before = mgr.sessions[s2].stats.tokens_computed
    plan = mgr.submit(s2, 128, 2)
    mgr.run()
    assert len(plan.models_used) > 0
    assert mgr.sessions[s2].stats.tokens_reused > 0
    assert mgr.store.cross_session_hits > 0
    # only the plan's boundary chunk is recomputed
    assert mgr.sessions[s2].stats.tokens_computed - computed_before <= 32 + 1


def test_isolation_across_documents(setup):
    doc_a, doc_b = setup[3], setup[4]
    mgr = _mgr(setup)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_b)
    mgr.submit(s1, 128, 2)
    mgr.run()
    plan = mgr.submit(s2, 128, 2)
    mgr.run()
    assert plan.models_used == []
    assert mgr.sessions[s2].stats.tokens_reused == 0
    assert doc_key(doc_a) != doc_key(doc_b)
    assert len(mgr.store.index(doc_key(doc_a))) > 0
    assert len(mgr.store.index(doc_key(doc_b))) > 0
    for sid, _ in mgr.store.index(doc_key(doc_a)).items():
        assert f":{doc_key(doc_a)}:" in sid


def test_same_content_shares_doc_id(setup):
    doc_a = setup[3]
    mgr = _mgr(setup)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a.copy())
    assert mgr.sessions[s1].doc_id == mgr.sessions[s2].doc_id


def test_extras_are_part_of_document_identity(setup):
    """Same tokens with different extras never share a document id; the id
    is ``repro``'s for the same tokens and extras."""
    doc_a = setup[3]
    mgr = _mgr(setup)
    zeros, ones = np.zeros((1, 4, 8), np.float32), np.ones((1, 4, 8), np.float32)
    s1 = mgr.add_session(doc_a, extras={"enc_feats": zeros})
    s2 = mgr.add_session(doc_a, extras={"enc_feats": ones})
    s3 = mgr.add_session(doc_a, extras={"enc_feats": zeros.copy()})
    assert mgr.sessions[s1].doc_id != mgr.sessions[s2].doc_id
    assert mgr.sessions[s1].doc_id == mgr.sessions[s3].doc_id
    assert mgr.sessions[s1].doc_id == jax_doc_key(doc_a, {"enc_feats": zeros})
    assert mgr.sessions[s1].doc_id != doc_key(doc_a)


def test_idle_sessions_release_decode_memory(setup):
    mgr = _mgr(setup)
    s1 = mgr.add_session(setup[3])
    mgr.submit(s1, 64, 3)
    out = mgr.run()
    assert len(out[s1]) == 3
    assert mgr._packs == {}
    assert mgr.sessions[s1].caches is None
    mgr.submit(s1, 64, 2)
    assert len(mgr.run()[s1]) == 2


def test_global_eviction_accounting():
    store = SegmentStore(byte_budget=1, seq_bucket=8)  # evict all but one
    seg = {"k": torch.zeros((1, 1, 8, 2, 4))}
    store.put(Range(0, 8), seg, doc_id="a")
    store.put(Range(8, 16), seg, doc_id="a")
    store.put(Range(0, 8), seg, doc_id="b")
    assert len(store) == 1
    assert store.evictions == 2
    assert store.evicted_bytes == 2 * cache_nbytes(seg)
    assert sum(len(store.index(d)) for d in store.doc_ids()) == 1
    assert store.nbytes() == cache_nbytes(seg)


def test_budget_is_global_across_documents(setup):
    doc_a, doc_b = setup[3], setup[4]
    probe = _mgr(setup)
    p = probe.add_session(doc_a)
    probe.submit(p, 128, 1)
    probe.run()
    one_doc_bytes = probe.store.nbytes()
    mgr = _mgr(setup, byte_budget=int(one_doc_bytes * 1.2))
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_b)
    mgr.submit(s1, 128, 1)
    mgr.run()
    mgr.submit(s2, 128, 1)
    mgr.run()
    assert mgr.store.evictions > 0
    assert mgr.store.nbytes() <= int(one_doc_bytes * 1.2)


def test_alias_publishes_prefix_segments_up_to_a_bound():
    store = SegmentStore(seq_bucket=8)
    seg = {"k": torch.zeros((1, 1, 8, 2, 4))}
    ids = [store.put(Range(lo, lo + 8), seg, doc_id="base") for lo in (0, 8, 16)]
    assert store.alias("base", "fork", upto=16) == 2
    assert sorted(sid for sid, _ in store.index("fork").items()) == sorted(ids[:2])
    assert store.alias("base", "fork", upto=16) == 0        # already there
    store.max_aliases = 1
    assert store.alias("base", "fork2") == 1 and store.alias_skips == 2
    # the fork outlives its base: released base segments stay for the fork
    store.release_doc("base")
    assert len(store.index("fork")) == 2 and len(store) == 3


# ---------------------------------------------------------------------------
# batched decode parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_batched_decode_matches_single_session(setup, greedy):
    """Batched streams equal ``ServeEngine.generate``'s, greedy and sampled
    (each session draws from its own generator, seeded as generate's)."""
    doc_a, doc_b = setup[3], setup[4]
    mgr = _mgr(setup, max_batch=4)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a)
    s3 = mgr.add_session(doc_b)
    mgr.submit(s1, 96, 4, greedy=greedy, seed=1)
    mgr.submit(s2, 128, 4, greedy=greedy, seed=2)
    mgr.submit(s3, 96, 4, greedy=greedy, seed=3)
    out = mgr.run()
    ref_a = _engine(setup, doc_a)
    ref_b = _engine(setup, doc_b)
    assert out[s1] == ref_a.generate(96, 4, greedy=greedy, seed=1)[0]
    assert out[s2] == ref_a.generate(128, 4, greedy=greedy, seed=2)[0]
    assert out[s3] == ref_b.generate(96, 4, greedy=greedy, seed=3)[0]
    assert mgr.sched.mean_batch > 1.0


def test_ragged_lengths_and_resubmission(setup):
    doc_a, doc_b = setup[3], setup[4]
    mgr = _mgr(setup)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_b)
    mgr.submit(s1, 64, 6)   # finishes later
    mgr.submit(s2, 96, 2)   # finishes first: the pack shrinks
    out = mgr.run()
    assert len(out[s1]) == 6 and len(out[s2]) == 2
    plan = mgr.submit(s1, 64, 2)
    out = mgr.run()
    assert len(out[s1]) == 2
    assert len(plan.models_used) > 0
    ref = _engine(setup, doc_a)
    ref.generate(64, 6)
    assert out[s1] == ref.generate(64, 2)[0]
    assert mgr.sessions[s1].plans[-1].validate_telescoping()


def test_closed_sessions_keep_counting(setup):
    mgr = _mgr(setup)
    s1 = mgr.add_session(setup[3])
    s2 = mgr.add_session(setup[4])
    mgr.submit(s1, 64, 3)
    mgr.submit(s2, 64, 2)
    mgr.run()
    before = mgr.aggregate_stats()
    mgr.close_session(s1)
    after = mgr.aggregate_stats()
    assert after.requests == before.requests == 2
    assert after.tokens_decoded == before.tokens_decoded == 5
    assert after.tokens_computed == before.tokens_computed


def test_submit_while_busy_raises(setup):
    mgr = _mgr(setup)
    s1 = mgr.add_session(setup[3])
    mgr.submit(s1, 32, 3)
    with pytest.raises(RuntimeError):
        mgr.submit(s1, 32, 1)
    mgr.run()
    mgr.submit(s1, 32, 1)
    mgr.run()


def test_submit_many_is_the_submit_loop(setup):
    doc_a, doc_b = setup[3], setup[4]
    a, b = _mgr(setup), _mgr(setup)
    reqs = []
    for m in (a, b):
        reqs.append([(m.add_session(doc_a), 96, 3, 0), (m.add_session(doc_b), 64, 3, 1)])
    plans_a = a.submit_many(reqs[0])
    plans_b = [b.submit(sid, n, k, seed=seed) for sid, n, k, seed in reqs[1]]
    assert [p.models_used for p in plans_a] == [p.models_used for p in plans_b]
    assert a.run() == b.run()


def test_manager_defaults_to_the_card(setup):
    """Like the CLI, the manager serves on ``cuda`` unless told otherwise:
    its device is the model's, and an LM's default device is ``cuda``."""
    cfg = setup[0]
    mgr = SessionManager(LM(cfg), setup[2])
    assert mgr.device == torch.device("cuda")
    assert _mgr(setup).device == torch.device("cpu")


# ---------------------------------------------------------------------------
# pipelined serving: async prefix builds
# ---------------------------------------------------------------------------

def _store_fingerprint(store):
    segs = [(sid, (seg.rng.lo, seg.rng.hi), seg.doc_id, seg.valid,
             seg.capacity, seg.hits, tuple(sorted(seg.aliases)))
            for sid, seg in store._segs.items()]
    return segs, {d: tuple(v) for d, v in store._doc_stats.items()}, \
        store.evictions, store._seq


def _eviction_trace(setup, async_prefill, hot_doc, cold_docs, budget):
    """Hot tenant plus a one-off flood under a tight budget, mid-stream joins."""
    mgr = _mgr(setup, byte_budget=budget, async_prefill=async_prefill)
    hot = mgr.add_session(hot_doc)
    outs = []
    mgr.submit(hot, len(hot_doc), 4, greedy=False, seed=0)
    outs.append(mgr.run()[hot])
    for r, cd in enumerate(cold_docs):
        cold = mgr.add_session(cd)
        mgr.submit(hot, len(hot_doc), 6, greedy=False, seed=10 + r)
        mgr.step()
        mgr.submit(cold, len(cd), 2, greedy=False, seed=20 + r)
        out = mgr.run()
        outs.append((out[hot], out[cold]))
        mgr.close_session(cold)
    return outs, mgr


@pytest.fixture(scope="module")
def eviction_traces(setup):
    cfg = setup[0]
    rng = np.random.default_rng(7)
    hot_doc = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    cold_docs = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
                 for _ in range(3)]
    probe = _mgr(setup)
    p = probe.add_session(hot_doc)
    probe.submit(p, 128, 2)
    probe.run()
    budget = int(probe.store.nbytes() * 1.5)
    sync = _eviction_trace(setup, False, hot_doc, cold_docs, budget)
    async_ = _eviction_trace(setup, True, hot_doc, cold_docs, budget)
    return sync, async_


def test_async_prefill_token_streams_match_sync(eviction_traces):
    (sync_out, sync_mgr), (async_out, async_mgr) = eviction_traces
    assert async_out == sync_out
    assert async_mgr.sched.tickets_launched == async_mgr.sched.tickets_joined == 7
    assert sync_mgr.sched.tickets_launched == 0


def test_async_prefill_store_matches_sync_under_eviction(eviction_traces):
    (_, sync_mgr), (_, async_mgr) = eviction_traces
    assert async_mgr.store.evictions > 0
    assert async_mgr.sched.decode_segments > 0
    assert _store_fingerprint(async_mgr.store) == _store_fingerprint(sync_mgr.store)
    for sid, seg in async_mgr.store._segs.items():
        ref = sync_mgr.store._segs[sid]
        for a, b in zip(tree_leaves(seg.caches), tree_leaves(ref.caches)):
            assert torch.equal(a, b)


def test_async_prefill_snapshot_manifest_matches_sync(eviction_traces, tmp_path):
    (_, sync_mgr), (_, async_mgr) = eviction_traces
    sync_mgr.store.save(tmp_path / "sync")
    async_mgr.store.save(tmp_path / "async")

    def records(d):
        man = json.loads((tmp_path / d / MANIFEST_NAME).read_text())
        # retention carries wall-clock stamps; everything else must match
        return man["store"], [{k: v for k, v in rec.items() if k != "retention"}
                              for rec in man["entries"]]

    assert records("async") == records("sync")


def test_deferred_build_matches_sync_build(setup):
    """``dispatch_prefix`` then ``finish`` computes ``prefix_with_logits``'
    caches and logits; its chunk segments reach the store only at
    finalize, which lands them once, and the store then holds the ids of
    a ``ServeEngine`` built the same way."""
    doc_a = setup[3]
    ref, split = _engine(setup, doc_a), _engine(setup, doc_a)
    ref.generate(64, 2)
    split.generate(64, 2)
    want = ref.builder.prefix_with_logits(doc_a, 150, doc_id=ref.doc_id,
                                          capacity=160)
    b = split.builder
    before = sorted(split.store._segs)
    logits, caches, plan, pending = b.dispatch_prefix(
        doc_a, 150, doc_id=split.doc_id, capacity=160)
    assert plan.models_used == want[2].models_used and plan.models_used
    assert set(pending.pin_token) == set(plan.models_used) <= set(b.store._pins)
    assert pending.puts and sorted(split.store._segs) == before
    assert torch.equal(logits, want[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(caches),
                                                 tree_leaves(want[1])))
    b.finish(pending, split.stats)
    landed = sorted(split.store._segs)
    b.finalize_build(pending)                     # idempotent
    b.finish(pending, split.stats)
    assert sorted(split.store._segs) == landed == sorted(ref.store._segs)
    assert len(landed) > len(before) and b.store._pins == {}


def test_ticket_pins_protect_unjoined_build(setup):
    mgr = _mgr(setup, async_prefill=True)
    sid = mgr.add_session(setup[3])
    mgr.submit(sid, 96, 2)
    ref = mgr.run()[sid]
    mgr.submit(sid, 96, 2, seed=1)          # async: the ticket is in flight
    t = mgr.sessions[sid].ticket
    assert t is not None and not t.pending.finalized and t.ready()
    pinned = set(t.pending.pin_token)
    assert pinned and pinned <= set(mgr.store._pins)
    mgr.store.byte_budget = 1
    mgr.store.put(Range(0, 8), {"k": torch.zeros((1, 1, 8, 2, 4))}, doc_id="junk")
    assert pinned <= set(mgr.store._segs)
    mgr.store.byte_budget = None
    out = mgr.run()[sid]
    assert mgr.store._pins == {}
    mgr.submit(sid, 96, 2, seed=1)
    assert mgr.run()[sid] == out == ref


def test_failed_deferred_build_releases_pins(setup, monkeypatch):
    mgr = _mgr(setup, async_prefill=True)
    sid = mgr.add_session(setup[3])
    mgr.submit(sid, 96, 2)
    mgr.run()                                   # the store now holds segments

    def boom(*a, **k):
        raise RuntimeError("dispatch failed")

    with monkeypatch.context() as m:
        m.setattr(mgr.builder.model, "prefill_extend", boom)
        with pytest.raises(RuntimeError, match="dispatch failed"):
            mgr.builder.dispatch_prefix(
                setup[3], 96, doc_id=mgr.sessions[sid].doc_id)
    assert mgr.store._pins == {}
    mgr.submit(sid, 96, 2)
    assert len(mgr.run()[sid]) == 2


def test_forced_join_makes_progress_when_only_cold(setup):
    mgr = _mgr(setup, async_prefill=True)
    sid = mgr.add_session(setup[3])
    mgr.submit(sid, 64, 3)
    assert mgr.sessions[sid].ticket is not None
    assert mgr.step() == 1                  # forced join + first token
    assert mgr.sessions[sid].ticket is None
    assert mgr.sched.tickets_joined == 1
    assert len(mgr.run()[sid]) == 3


def _mixed_capacity(setup, merge):
    doc_a, doc_b = setup[3], setup[4]
    mgr = _mgr(setup, max_batch=8, async_prefill=False, merge_decode_packs=merge)
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a)
    long = mgr.add_session(doc_b)
    mgr.submit(s1, 64, 4)
    mgr.submit(s2, 64, 4)
    mgr.submit(long, 160, 4)
    mgr.step()
    groups = {g: cache_len(c) for g, c in mgr._packs.items()}
    out = mgr.run()
    return groups, [out[s] for s in (s1, s2, long)], mgr


def test_capacity_keeps_warm_decode_groups_separate(setup):
    groups, out, _ = _mixed_capacity(setup, merge=False)
    assert set(groups) == {(0, 1), (2,)}
    assert groups[(0, 1)] < groups[(2,)]
    assert [len(o) for o in out] == [4, 4, 4]


def test_merged_ragged_packs_stream_identically_to_split(setup):
    merged_groups, merged_out, merged_mgr = _mixed_capacity(setup, merge=True)
    _, split_out, _ = _mixed_capacity(setup, merge=False)
    assert list(merged_groups) == [(2, 0, 1)]   # one pack, largest first
    assert merged_out == split_out
    rep = merged_mgr.report()
    assert 0.0 < rep["decode_padded_frac"] < 1.0
    assert rep["decode_attn_flops"] > 0.0


def test_idle_server_report_is_finite(setup):
    mgr = _mgr(setup)
    rep = mgr.report()
    assert rep["requests"] == 0 and rep["tokens_decoded"] == 0
    for key, val in rep.items():
        assert isinstance(val, (int, float)) and math.isfinite(val), (key, val)
    assert mgr.sched.mean_batch == 0.0
    assert mgr.sched.overlap_batch == 0.0
    assert mgr.sched.mean_join_wait_s == 0.0
    agg = mgr.aggregate_stats()
    assert agg.reuse_frac == agg.prefill_tok_s == agg.decode_tok_s == 0.0


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------

#: report() fields that are wall-clock readings
TIMING_FIELDS = ("prefill_tok_s", "decode_tok_s", "mean_join_wait_s", "save_stall_s")


def _script(mgr, doc_a, doc_b):
    """Three rounds over three sessions: mixed prefixes and capacities,
    shared segments, decode write-back onto a continuation (s1's second
    request covers its whole document), an edit, and a request over the
    edited text.  Returns (streams, plans)."""
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a)
    s3 = mgr.add_session(doc_b)
    streams, plans = [], []

    def round_(reqs):
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k)
            plans.append([(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps])
        streams.append(mgr.run())

    round_([(s1, 96, 4), (s2, 128, 4), (s3, 160, 4)])
    round_([(s1, 192, 3), (s2, 64, 2), (s3, 96, 3)])
    edited = doc_b.copy()
    edited[100] = (edited[100] + 1) % 512
    eplan = mgr.update_document(s3, edited)
    round_([(s1, 195, 2), (s2, 190, 4), (s3, 150, 3)])
    return streams, plans, (eplan.action, eplan.divergence, eplan.reused_tokens)


@pytest.fixture(scope="module")
def reference_run(setup):
    cfg, model, params, doc_a, doc_b, jm, jparams = setup
    kw = dict(chunk_tokens=32, decode_bucket=32, async_prefill=False)
    jmgr = JaxManager(jm, jparams, **kw)
    tmgr = SessionManager(model, params, **kw)
    return (_script(jmgr, doc_a, doc_b), jmgr), (_script(tmgr, doc_a, doc_b), tmgr)


def test_streams_plans_and_segments_match_reference(reference_run):
    (jres, jmgr), (tres, tmgr) = reference_run
    assert tres[0] == jres[0]                   # greedy streams, every round
    assert tres[1] == jres[1]                   # plans, with segment ids
    assert tres[2] == jres[2] and tres[2][0] == "edit"
    assert sorted(tmgr.store._segs) == sorted(jmgr.store._segs)
    assert tmgr.sched.decode_segments == jmgr.sched.decode_segments > 0
    assert tmgr.store.cross_session_hits == jmgr.store.cross_session_hits > 0


def test_report_matches_reference(reference_run):
    (_, jmgr), (_, tmgr) = reference_run
    jrep, trep = jmgr.report(), tmgr.report()
    assert list(trep) == list(jrep) + list(PORT_REPORT_KEYS)
    differ = {k for k in jrep if trep[k] != jrep[k]}
    assert differ <= set(TIMING_FIELDS) | {"decode_attn_flops"}, \
        {k: (trep[k], jrep[k]) for k in differ}
    assert trep["mean_batch"] > 1.0 and trep["rekeyed_segments"] > 0


def test_decode_attn_flops_count_whole_splits(setup):
    """The port counts what its decode kernel reads: each row's positions in
    whole splits of ``kernel.SPLIT`` (128), up to the pack's capacity."""
    from repro_torch.kernels.decode_attention.kernel import SPLIT

    cfg = setup[0]
    mgr = _mgr(setup, max_batch=4, async_prefill=False)
    rows = []
    orig = mgr._decode_attn_flops

    def spy(live, cap):
        rows.append((list(live), cap))
        return orig(live, cap)

    mgr._decode_attn_flops = spy
    s1 = mgr.add_session(setup[3])
    s2 = mgr.add_session(setup[4])
    mgr.submit(s1, 60, 3)
    mgr.submit(s2, 150, 3)
    mgr.run()
    per_tok = 4.0 * cfg.n_heads * cfg.head_dim * cfg.n_layers
    want = sum(per_tok * min(-(-t // SPLIT) * SPLIT, cap)
               for live, cap in rows for t in live)
    assert SPLIT == 128 and rows == [([151, 61], 160), ([152, 62], 160)]
    assert mgr.sched.decode_attn_flops == want == per_tok * 2 * (160 + 128)


# ---------------------------------------------------------------------------
# storage: the in-place decode write never reaches store bytes
# ---------------------------------------------------------------------------

def _storage(x):
    return x.untyped_storage().data_ptr()


def _check_store_owns_its_bytes(mgr, snap):
    """Every stored leaf owns storage of exactly its own size, shared with no
    live pack or session cache, and still holds the values it was put with."""
    live = {_storage(x) for pack in mgr._packs.values() for x in tree_leaves(pack)}
    live |= {_storage(x) for s in mgr.sessions.values() if s.caches is not None
             for x in tree_leaves(s.caches)}
    n = 0
    for sid, seg in mgr.store._segs.items():
        for j, x in enumerate(tree_leaves(seg.caches)):
            assert _storage(x) not in live, sid
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size(), sid
            if (sid, j) in snap:
                assert torch.equal(x, snap[sid, j]), sid
            snap[sid, j] = x.clone()
            n += 1
    return n


def _drain_checked(mgr, snap):
    steps = 0
    while mgr.step():
        _check_store_owns_its_bytes(mgr, snap)
        steps += 1
    mgr.run()
    return steps


def test_stored_segments_never_share_storage_with_packs(setup):
    doc_a, doc_b = setup[3], setup[4]
    mgr = _mgr(setup, max_batch=4)
    snap: dict = {}
    s1 = mgr.add_session(doc_a)
    s2 = mgr.add_session(doc_a)
    s3 = mgr.add_session(doc_b)
    # round 1: s1 covers doc_a, so its write-back forks the document
    mgr.submit(s1, 192, 4)
    mgr.submit(s2, 96, 4)
    assert _drain_checked(mgr, snap) > 0
    assert mgr.sched.decode_segments > 0
    # round 2 reuses the decode segment (the whole continuation) and anchors
    # s2's cache on stored segments; three rows share one pack
    mgr.submit(s1, 196, 3)
    mgr.submit(s2, 128, 3)
    mgr.submit(s3, 64, 3)
    assert any(sid.startswith(f"kv:{mgr.sessions[s1].doc_id}:")
               for sid in mgr.sessions[s1].plans[-1].models_used)
    assert _drain_checked(mgr, snap) > 0
    # an edit rekeys the surviving prefix, then a 1-row pack decodes over it
    edited = doc_b.copy()
    edited[70] = (edited[70] + 1) % 512
    assert mgr.update_document(s3, edited).action == "edit"
    assert mgr.store.rekeyed_segments > 0
    mgr.submit(s3, 100, 4)
    mgr.step()
    assert list(mgr._packs) == [(s3,)]
    row = mgr.sessions[s3].caches
    pack = mgr._packs[(s3,)]
    assert all(_storage(x) != _storage(y)
               for x, y in zip(tree_leaves(pack), tree_leaves(row)))
    assert _check_store_owns_its_bytes(mgr, snap) == 2 * len(mgr.store)
    _drain_checked(mgr, snap)
    _check_store_owns_its_bytes(mgr, snap)


def test_batch_caches_always_copies(setup):
    _, model, params, doc_a, *_ = setup
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": torch.from_numpy(doc_a[None, :32])})
    for n in (1, 2):
        pack = batch_caches([caches] * n)
        for x, y in zip(tree_leaves(pack), tree_leaves(caches)):
            assert _storage(x) != _storage(y) and x.is_contiguous()
            assert x.shape[1] == n
        rows = split_caches(pack, n)
        assert all(torch.equal(r, y) for row in rows
                   for r, y in zip(tree_leaves(row), tree_leaves(caches)))
    seg = slice_cache(split_caches(batch_caches([caches] * 2), 2)[1], 0, 16)
    assert all(x.untyped_storage().nbytes() == x.numel() * x.element_size()
               for x in tree_leaves(seg))
