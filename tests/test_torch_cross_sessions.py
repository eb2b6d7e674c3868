"""Batched sessions over reduced ``whisper-large-v3`` and
``llama-3.2-vision-11b`` in the port, against itself and against
``repro``'s ``SessionManager``, and the serve CLI
(``tests/test_torch_cross_serve.py`` holds the model and the
single-session path).

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``,
192-token documents and each session's context features (0.1 N(0, 1)) from
``np.random.default_rng``; fp32 on the CPU, chunk 32, decode bucket 64,
sync prefill.  Held:

* merged packs of mixed capacity, their rows over different contexts,
  stream as capacity-split ones;
* with decode write-back, the greedy streams, plans and segment ids equal
  ``repro``'s (continuations keyed with their session's context), and
  every value of ``report()`` is finite; a document edit rekeys the kept
  segments to the edited content with its context, as ``repro`` does;
* two sessions on the same tokens with other context features share no
  document id and no segment, and stream as each one alone; features
  given as tensors key and serve as the same numpy arrays do;
* over a 2-shard ``ShardedSegmentStore``, one document homed on each
  shard, the second round fetching the remote one's segments (context
  leaves and k/v) over the fp32 or the int8 wire: ``repro``'s streams,
  plans, segment ids per shard and fetch count, and on the fp32 wire the
  single-store streams;
* the serve CLI (``--reduced --device cpu``) prints ``repro``'s lines with
  the same flags, one session (tokens and times aside) and four under
  ``--sync-prefill`` (wall-clock values and the decode route aside).
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.cost import serve_cost_model as jax_serve_cost_model  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro.serve import shard_store as jshard  # noqa: E402
from repro.serve.session import SessionManager as JaxManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.cost import serve_cost_model  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import session as tsession  # noqa: E402
from repro_torch.serve import shard_store as tshard  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
KW = dict(chunk_tokens=32, decode_bucket=64, async_prefill=False)


def context(cfg, seed: int) -> dict:
    """The stub frontend's features for ``cfg``: 0.1 N(0, 1), fp32."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        key, n = "enc_feats", cfg.encoder_context
    else:
        key, n = "image_embeds", cfg.vision_context
    return {key: (0.1 * rng.standard_normal((1, n, cfg.d_model))).astype(np.float32)}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg = reduced(get_config(arch))
    jm = JaxLM(jax_reduced(jax_get_config(arch)))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, 192).astype(np.int32) for _ in range(2)]
    return arch, cfg, jm, jparams, tm, params, docs, [context(cfg, s) for s in (1, 2)]


def _steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps]


def _mixed_capacity(models, merge):
    _, _, _, _, tm, params, (doc_a, doc_b), (ca, cb) = models
    mgr = SessionManager(tm, params, max_batch=8, merge_decode_packs=merge, **KW)
    s1, s2, long = (mgr.add_session(d, extras=c)
                    for d, c in ((doc_a, ca), (doc_a, cb), (doc_b, ca)))
    mgr.submit(s1, 64, 5)
    mgr.submit(s2, 64, 5)
    mgr.submit(long, 160, 5)
    mgr.step()
    groups = sorted(mgr._packs)
    out = mgr.run()
    return groups, [out[s] for s in (s1, s2, long)]


def test_merged_packs_stream_as_split(models):
    merged_groups, merged = _mixed_capacity(models, merge=True)
    split_groups, split = _mixed_capacity(models, merge=False)
    assert merged_groups == [(2, 0, 1)]
    assert split_groups == [(0, 1), (2,)]
    assert merged == split and [len(s) for s in merged] == [5, 5, 5]


def _script(mgr, docs, ctxs):
    """Two rounds over three sessions: shared segments, mixed capacities in
    one merged pack, and a request over a whole document, whose write-back
    forks it and the next round reads the continuation."""
    (doc_a, doc_b), (ca, _) = docs, ctxs
    s1, s2, s3 = (mgr.add_session(d, extras=ca) for d in (doc_a, doc_a, doc_b))
    streams, plans = [], []
    for reqs in (((s1, 96, 4), (s2, 128, 4), (s3, 192, 4)),
                 ((s1, 192, 3), (s2, 64, 2), (s3, 196, 3))):
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k)
            plans.append(_steps(plan))
        streams.append(mgr.run())
    return streams, plans


def test_sessions_match_reference(models):
    _, _, jm, jparams, tm, params, docs, ctxs = models
    jmgr = JaxManager(jm, jparams, **KW)
    tmgr = SessionManager(tm, params, **KW)
    jres = _script(jmgr, docs, ctxs)
    tres = _script(tmgr, docs, ctxs)
    assert tres[0] == jres[0]                   # greedy streams, every round
    assert tres[1] == jres[1]                   # plans, with segment ids
    assert sorted(tmgr.store._segs) == sorted(jmgr.store._segs)
    assert tmgr.sched.decode_segments == jmgr.sched.decode_segments > 0
    assert tmgr.store.cross_session_hits == jmgr.store.cross_session_hits > 0
    # the continuation the write-back forked is keyed with the context
    assert all(s.doc_id == tsession.doc_key(s.doc, ctxs[0])
               for s in tmgr.sessions.values())
    rep = tmgr.report()
    assert all(np.isfinite(v) for v in rep.values())


def _edit_script(mgr, doc, ctx):
    """A request, an edit at position 100, a request over the edited
    document: the edit keeps the segments before the divergence, rekeyed
    to the edited content with its context."""
    sid = mgr.add_session(doc, extras=ctx)
    plans = [_steps(mgr.submit(sid, 160, 3))]
    first = mgr.run()[sid]
    edited = doc.copy()
    edited[100] = (edited[100] + 1) % 512
    eplan = mgr.update_document(sid, edited)
    plans.append(_steps(mgr.submit(sid, 192, 3)))
    return first, mgr.run()[sid], plans, mgr.sessions[sid].doc_id, len(eplan.reuse)


def test_edit_rekeys_with_context_as_reference(models):
    _, _, jm, jparams, tm, params, (doc, _), (ctx, _) = models
    kw = dict(KW, decode_materialize=False)
    port = _edit_script(SessionManager(tm, params, **kw), doc, ctx)
    ref = _edit_script(JaxManager(jm, jparams, **kw), doc, ctx)
    assert port == ref
    edited = doc.copy()
    edited[100] = (edited[100] + 1) % 512
    assert port[3] == tsession.doc_key(edited, ctx) and port[4] > 0


def test_other_context_shares_no_segment(models):
    """Sessions on the same tokens with other features: two documents, no
    reused segment and no cross-session hit, each stream its own alone."""
    _, _, _, _, tm, params, (doc, _), (ca, cb) = models
    mgr = SessionManager(tm, params, **KW)
    s1, s2 = mgr.add_session(doc, extras=ca), mgr.add_session(doc, extras=cb)
    assert mgr.sessions[s1].doc_id != mgr.sessions[s2].doc_id
    mgr.submit(s1, 160, 4)
    first = mgr.run()[s1]
    plan = mgr.submit(s2, 160, 4)
    second = mgr.run()[s2]
    assert plan.models_used == [] and mgr.store.cross_session_hits == 0
    ids = [set(mgr.store.index(mgr.sessions[s].doc_id).items()) for s in (s1, s2)]
    assert ids[0] and ids[1] and not {i for i, _ in ids[0]} & {i for i, _ in ids[1]}
    # a segment of each document holds its own context's K/V
    ck = [mgr.store._segs[min(i for i, _ in d)].caches[0] for d in ids]
    layer = next(j for j, leaves in ck[0].items() if "ck" in leaves)
    assert not torch.equal(ck[0][layer]["ck"], ck[1][layer]["ck"])
    for c, stream in ((ca, first), (cb, second)):
        alone = SessionManager(tm, params, **KW)
        sid = alone.add_session(doc, extras=c)
        alone.submit(sid, 160, 4)
        assert alone.run()[sid] == stream


def test_tensor_extras_key_and_serve_as_arrays(models):
    """Context features given as tensors: the session keeps host arrays
    (the key, ``repro``'s for the same values) and serves as with numpy."""
    _, _, _, _, tm, params, (doc, _), (ca, _) = models
    streams, ids = [], []
    for extras in (ca, {k: torch.from_numpy(v) for k, v in ca.items()}):
        mgr = SessionManager(tm, params, **KW)
        sid = mgr.add_session(doc, extras=extras)
        s = mgr.sessions[sid]
        assert all(isinstance(v, np.ndarray) for v in s.extras.values())
        assert all(isinstance(v, torch.Tensor) for v in s.context.values())
        mgr.submit(sid, 96, 3)
        streams.append(mgr.run()[sid])
        ids.append(s.doc_id)
    assert streams[0] == streams[1] and ids[0] == ids[1] == jsession.doc_key(doc, ca)


def _one_doc_per_shard(vocab, ctx):
    ring, docs, rng = tshard.HashRing(2), {}, np.random.default_rng(11)
    while len(docs) < 2:
        doc = rng.integers(0, vocab, 192).astype(np.int32)
        docs.setdefault(ring.place(tsession.doc_key(doc, ctx)), doc)
    return [docs[0], docs[1]]


def _sharded_rounds(mgr, docs, ctx):
    sids = [mgr.add_session(d, extras=ctx) for d in docs]
    streams, plans = [], []
    for r in range(2):
        for plan in mgr.submit_many([(sid, 160, 2, r * 10 + i)
                                     for i, sid in enumerate(sids)]):
            plans.append(_steps(plan))
        toks = mgr.run()
        streams.append([toks[sid] for sid in sids])
    return streams, plans


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_sharded_sessions_match_reference(models, wire):
    """Two shards, the second round fetching the remote documents' segments
    over the ``wire``: ``repro``'s streams, plans and segment ids, and on
    the fp32 wire the single-store streams."""
    _, cfg, jm, jparams, tm, params, _, (ctx, _) = models
    kw = dict(KW, decode_materialize=False)
    docs = _one_doc_per_shard(cfg.vocab_size, ctx)
    ours = tshard.ShardedSegmentStore(2, cost_model=serve_cost_model(), seq_bucket=64,
                                      device="cpu", wire_precision=wire,
                                      hedge_deadline_s=1e9)
    theirs = jshard.ShardedSegmentStore(2, cost_model=jax_serve_cost_model(),
                                        seq_bucket=64, wire_precision=wire,
                                        hedge_deadline_s=1e9)
    port = _sharded_rounds(SessionManager(tm, params, store=ours, **kw), docs, ctx)
    ref = _sharded_rounds(JaxManager(jm, jparams, store=theirs, **kw), docs, ctx)
    assert port == ref
    assert [sorted(s._segs) for s in ours._shards()] == \
        [sorted(s._segs) for s in theirs._shards()]
    assert ours.remote_fetches == theirs.remote_fetches > 0
    if wire == "fp32":
        single = _sharded_rounds(SessionManager(tm, params, **kw), docs, ctx)
        assert port[0] == single[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _report(out: str) -> list:
    keep = []
    for line in out.splitlines():
        if line.startswith("req "):
            keep.append(line.split("tokens")[0])
        elif " requests: reuse " in line:
            keep.append(line.split(", planner")[0])
        elif line.startswith(("  tiers", "  tier traffic", "  precision")):
            keep.append(line)
    return keep


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_on_cpu_matches_reference(arch, capsys, monkeypatch):
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    flags = ["--arch", arch, "--reduced", "--doc-len", "256", "--requests", "3",
             "--new-tokens", "3", "--chunk-tokens", "64"]
    cli.main(["--device", "cpu", *flags])
    port = _report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jax_cli.main()
    ref = _report(capsys.readouterr().out)
    assert len(port) == 3 + 1 + 3 and port == ref


#: wall-clock values in the multi-session report, and what differs by
#: design (``tests/test_torch_serve.py``'s): the decode route's name and
#: the attention FLOPs that route reads
_MULTI_VOLATILE = (
    (re.compile(r"[0-9.]+ tok/s wall"), "tok/s wall"),
    (re.compile(r"mean join wait [0-9.]+ ms"), "mean join wait"),
    (re.compile(r"\w+ attention\)"), "attention)"),
    (re.compile(r"attn ~[0-9.]+ GFLOP"), "attn GFLOP"),
)


def _multi_report(out: str) -> list:
    keep = []
    for line in out.splitlines():
        for pat, repl in _MULTI_VOLATILE:
            line = pat.sub(repl, line)
        keep.append(line)
    return keep


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_multi_session_matches_reference(arch, capsys, monkeypatch):
    """``--sessions 4 --shared-docs 2 --sync-prefill``: every line of
    ``repro``'s, the scheduler's included, wall-clock values and the decode
    route aside."""
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    flags = ["--arch", arch, "--reduced", "--doc-len", "256", "--sessions", "4",
             "--shared-docs", "2", "--requests", "2", "--new-tokens", "3",
             "--chunk-tokens", "64", "--sync-prefill"]
    cli.main(["--device", "cpu", *flags])
    port = _multi_report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jax_cli.main()
    ref = _multi_report(capsys.readouterr().out)
    assert port[0] == "4 sessions × 2 requests (2 on a shared doc):"
    assert port == ref
