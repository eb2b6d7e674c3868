"""Sharded serving in the port: ``SessionManager`` over
``ShardedSegmentStore``, against the port's own single-shard run and
against ``repro``.

The traffic is ``scripts/sharded_smoke.py``'s: four 160-token documents,
two homed on each of two shards (rejection-sampled by ``doc_key``), chunk
32, decode bucket 32, no decode write-back, three rounds of two greedy
tokens at full prefix under a per-shard budget of half the unbounded
store's bytes; then a straggler (shard 1 slowed 1e6×, hedge deadline
0.05 s) and two more rounds.  Required inside the port: the sharded
streams equal the single-shard unbounded streams (a fetch perturbs no
token), cross-shard hits over coalesced fetches (one transfer per shard
per tick), and after the straggler, hedged fetches the local rebuild wins
with the streams still equal.  Against ``repro`` (parameters from its
``LM.init`` through ``params_from_jax``, synchronous prefill on both
sides): the same streams, plans and segment ids on every shard, and
``report()`` with ``repro``'s keys, then the port's own
(``PORT_REPORT_KEYS``), and ``repro``'s values apart from the wall-clock
fields and ``decode_attn_flops`` (each package counts what its decode
route reads).  Reduced ``deepseek-67b`` and reduced ``deepseek-v2-236b``,
whose latent cache (``c_kv``, ``k_rope``) is the first non-GQA cache on
the wire.

Last, the CLI: ``--sessions 4 --shards 2 --store-dir DIR`` run twice
prints ``repro``'s fetch-traffic, hedging and per-shard lines, and the
second run its warm start over two shards.
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
from repro.serve.session import SessionManager as JaxManager  # noqa: E402
from repro.serve.shard_store import ShardedSegmentStore as JaxSharded  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.cost import serve_cost_model  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve.session import PORT_REPORT_KEYS, SessionManager, doc_key  # noqa: E402
from repro_torch.serve.shard_store import HashRing, ShardedSegmentStore  # noqa: E402

#: report() fields that are wall-clock readings, and the decode route's
#: attention FLOPs (what each package's route reads)
VOLATILE = ("prefill_tok_s", "decode_tok_s", "mean_join_wait_s", "save_stall_s",
            "decode_attn_flops")


def balanced_docs(rng, vocab, doc_len, n_docs, n_shards):
    """``n_docs`` random documents, ``n_docs / n_shards`` homed on each shard."""
    ring = HashRing(n_shards)
    quota = {s: n_docs // n_shards for s in range(n_shards)}
    docs = []
    while len(docs) < n_docs:
        doc = rng.integers(0, vocab, doc_len).astype(np.int32)
        home = ring.place(doc_key(doc))
        if quota.get(home, 0) > 0:
            quota[home] -= 1
            docs.append(doc)
    return docs


def replay(mgr, docs, *, rounds, n_new=2, seed0=0):
    """``rounds`` rounds of one full-prefix request per document through
    ``submit_many``; returns (streams, plans)."""
    sids = [mgr.add_session(d) for d in docs]
    streams, plans = [], []
    for r in range(rounds):
        for plan in mgr.submit_many([(sid, len(docs[i]), n_new, seed0 + r * 100 + i)
                                     for i, sid in enumerate(sids)]):
            plans.append([(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps])
        toks = mgr.run()
        streams.append(tuple(tuple(toks[sid]) for sid in sids))
    return streams, plans


def sharded_run(mk_mgr, mk_store, docs):
    """The sharded_smoke traffic on one package: the single-shard unbounded
    probe, the sharded run under per-shard pressure, then the straggler."""
    probe = mk_mgr(None)
    ref, _ = replay(probe, docs, rounds=3)
    budget = max(int(probe.store.nbytes() * 0.5), 1)
    mgr = mk_mgr(mk_store(budget))
    st = mgr.store
    got, plans = replay(mgr, docs, rounds=3)
    fetched = (st.remote_fetches, st.fetched_hits,
               st.transport.coalesce_violations, st.transport.max_transfers_per_shard_tick)
    st.hedge_deadline_s = 0.05
    st.transport.slowdown[1] = 1e6
    got2, plans2 = replay(mgr, docs, rounds=2, seed0=300)
    ref2, _ = replay(probe, docs, rounds=2, seed0=300)
    return dict(ref=ref, got=got, ref2=ref2, got2=got2, plans=plans + plans2,
                fetched=fetched, segs=[sorted(s._segs) for s in st._shards()],
                report=mgr.report(), store=st, mgr=mgr)


ARCHS = ("deepseek-67b", "deepseek-v2-236b")


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    jm = JaxLM(jax_reduced(jax_get_config(arch)))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    model = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    docs = balanced_docs(np.random.default_rng(11), cfg.vocab_size, 160, 4, 2)
    kw = dict(chunk_tokens=32, decode_bucket=32, decode_materialize=False,
              async_prefill=False)
    port = sharded_run(
        lambda store: SessionManager(model, params, store=store, **kw),
        lambda budget: ShardedSegmentStore(2, byte_budget=budget,
                                           cost_model=serve_cost_model(),
                                           seq_bucket=32, device="cpu"),
        docs)
    ref = sharded_run(
        lambda store: JaxManager(jm, jparams, store=store, **kw),
        lambda budget: JaxSharded(2, byte_budget=budget,
                                  cost_model=jax_serve_cost_model(), seq_bucket=32),
        docs)
    return arch, port, ref


def test_sharded_streams_equal_single_shard(runs):
    """Inside the port: the 2-shard streams are the single-shard unbounded
    streams, fetched segments serve the builder over coalesced transfers,
    and after the straggler the rebuild wins hedged races, streams equal."""
    _, port, _ = runs
    assert port["got"] == port["ref"]
    remote_fetches, fetched_hits, violations, per_tick = port["fetched"]
    assert remote_fetches > 0 and fetched_hits > 0
    assert violations == 0 and per_tick <= 1
    st = port["store"]
    assert st.hedged_fetches > 0 and st.hedge_rebuild_wins > 0
    assert port["got2"] == port["ref2"]
    assert port["report"]["fetched_segments"] > 0
    assert port["report"]["put_forwards"] > 0


def test_sharded_sessions_match_reference(runs):
    """Against ``repro``: streams, plans (with segment ids), every shard's
    segment ids and the report's counters."""
    arch, port, ref = runs
    for key in ("ref", "got", "ref2", "got2", "plans", "fetched", "segs"):
        assert port[key] == ref[key], (arch, key)
    prep, jrep = port["report"], ref["report"]
    assert list(prep) == list(jrep) + list(PORT_REPORT_KEYS)
    differ = {k for k in jrep if prep[k] != jrep[k]}
    assert differ <= set(VOLATILE), {k: (prep[k], jrep[k]) for k in differ}
    assert prep["remote_fetch_wire_bytes"] > 0 and prep["shards"] == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_SHARD_LINES = ("  fetch traffic", "  hedging", "  shard ", "warm start")


def _shard_lines(out: str) -> list:
    return [line.split(" from ")[0] for line in out.splitlines()
            if line.startswith(_SHARD_LINES)]


def test_cli_sharded_warm_start_matches_reference(tmp_path, capsys, monkeypatch):
    """``--sessions 4 --shards 2 --shard-rtt 1e-6 --store-dir DIR`` twice:
    the port prints ``repro``'s fetch-traffic, hedging and per-shard lines,
    and the second run reloads the first run's two-shard snapshot.  No
    decode write-back: the CLI samples, the two packages draw different
    tokens, and a continuation's home shard follows its tokens."""
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    def flags(root):
        return ["--arch", "deepseek-67b", "--reduced", "--doc-len", "256",
                "--sessions", "4", "--shared-docs", "0", "--requests", "2",
                "--new-tokens", "4", "--no-decode-materialize", "--shards", "2",
                "--shard-rtt", "1e-6", "--store-dir", str(root)]

    outs = {}
    for run in (1, 2):
        cli.main(["--device", "cpu", *flags(tmp_path / "t")])
        outs["port", run] = _shard_lines(capsys.readouterr().out)
        monkeypatch.setattr("sys.argv", ["serve", *flags(tmp_path / "j")])
        jax_cli.main()
        outs["ref", run] = _shard_lines(capsys.readouterr().out)
    for run in (1, 2):
        assert outs["port", run] == outs["ref", run], run
    first, second = outs["port", 1], outs["port", 2]
    assert re.match(r"  fetch traffic \(2 shards\): [1-9]\d* segments fetched", first[0])
    assert "0 coalesce violations" in first[0]
    assert re.search(r" [1-9]\d* put-forwards", first[1])
    assert [line.split(":")[0] for line in first[2:]] == ["  shard 0", "  shard 1"]
    assert re.match(r"warm start: reloaded [1-9]\d* segments .* 2 shards\)", second[0])
    # the snapshot is a shard-XX tree the port loads back onto the CPU
    st = ShardedSegmentStore.load(tmp_path / "t", device="cpu")
    assert st.n_shards == 2 and st.total_segments() > 0
