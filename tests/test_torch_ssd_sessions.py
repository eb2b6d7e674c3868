"""Batched sessions over reduced ``mamba2-130m`` and ``jamba-v0.1-52b``
in the port, against itself and against ``repro``'s ``SessionManager``,
and the serve CLI (``tests/test_torch_ssd_serve.py`` holds the model and
the single-session path).

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``,
192-token documents from ``np.random.default_rng``; fp32 on the CPU,
chunk 32, decode bucket 64, sync prefill.  Held:

* merged packs of mixed capacity stream as capacity-split ones (a pure
  SSD pack has no sequence axis: ``cache_len`` 0, rows of any capacity);
* with decode write-back, the greedy streams, plans and segment ids equal
  ``repro``'s, and every value of ``report()`` is finite;
* over a 2-shard ``ShardedSegmentStore``, one document homed on each
  shard, the second round fetching the remote one's segments (state
  leaves, and jamba's k/v) over the fp32 or the int8 wire: ``repro``'s
  streams, plans, segment ids per shard and fetch count, and on the fp32
  wire the single-store streams;
* the serve CLI (``--reduced --device cpu``) prints ``repro``'s reuse
  lines with the same flags, tokens and times aside.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.cost import serve_cost_model as jax_serve_cost_model  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import shard_store as jshard  # noqa: E402
from repro.serve.session import SessionManager as JaxManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.cost import serve_cost_model  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import session as tsession  # noqa: E402
from repro_torch.serve import shard_store as tshard  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402

ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
KW = dict(chunk_tokens=32, decode_bucket=64, async_prefill=False)


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
    return arch, cfg, jm, jparams, tm, params, docs


def _steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps]


def _mixed_capacity(models, merge):
    _, _, _, _, tm, params, (doc_a, doc_b) = models
    mgr = SessionManager(tm, params, max_batch=8, merge_decode_packs=merge, **KW)
    s1, s2, long = (mgr.add_session(d) for d in (doc_a, doc_a, doc_b))
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


def _script(mgr, doc_a, doc_b):
    """Two rounds over three sessions: shared segments, mixed capacities in
    one merged pack, and a request over a whole document, whose write-back
    forks it and the next round reads the continuation."""
    s1, s2, s3 = (mgr.add_session(d) for d in (doc_a, doc_a, doc_b))
    streams, plans = [], []
    for reqs in (((s1, 96, 4), (s2, 128, 4), (s3, 192, 4)),
                 ((s1, 192, 3), (s2, 64, 2), (s3, 196, 3))):
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k)
            plans.append(_steps(plan))
        streams.append(mgr.run())
    return streams, plans


def test_sessions_match_reference(models):
    _, _, jm, jparams, tm, params, (doc_a, doc_b) = models
    jmgr = JaxManager(jm, jparams, **KW)
    tmgr = SessionManager(tm, params, **KW)
    jres = _script(jmgr, doc_a, doc_b)
    tres = _script(tmgr, doc_a, doc_b)
    assert tres[0] == jres[0]                   # greedy streams, every round
    assert tres[1] == jres[1]                   # plans, with segment ids
    assert sorted(tmgr.store._segs) == sorted(jmgr.store._segs)
    assert tmgr.sched.decode_segments == jmgr.sched.decode_segments > 0
    assert tmgr.store.cross_session_hits == jmgr.store.cross_session_hits > 0
    rep = tmgr.report()
    assert all(np.isfinite(v) for v in rep.values())




def _one_doc_per_shard(vocab):
    ring, docs, rng = tshard.HashRing(2), {}, np.random.default_rng(11)
    while len(docs) < 2:
        doc = rng.integers(0, vocab, 192).astype(np.int32)
        docs.setdefault(ring.place(tsession.doc_key(doc)), doc)
    return [docs[0], docs[1]]


def _sharded_rounds(mgr, docs):
    sids = [mgr.add_session(d) for d in docs]
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
    _, cfg, jm, jparams, tm, params, _ = models
    kw = dict(KW, decode_materialize=False)
    docs = _one_doc_per_shard(cfg.vocab_size)
    ours = tshard.ShardedSegmentStore(2, cost_model=serve_cost_model(), seq_bucket=64,
                                      device="cpu", wire_precision=wire,
                                      hedge_deadline_s=1e9)
    theirs = jshard.ShardedSegmentStore(2, cost_model=jax_serve_cost_model(),
                                        seq_bucket=64, wire_precision=wire,
                                        hedge_deadline_s=1e9)
    port = _sharded_rounds(SessionManager(tm, params, store=ours, **kw), docs)
    ref = _sharded_rounds(JaxManager(jm, jparams, store=theirs, **kw), docs)
    assert port == ref
    assert [sorted(s._segs) for s in ours._shards()] == \
        [sorted(s._segs) for s in theirs._shards()]
    assert ours.remote_fetches == theirs.remote_fetches > 0
    if wire == "fp32":
        single = _sharded_rounds(SessionManager(tm, params, **kw), docs)
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
