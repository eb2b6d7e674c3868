"""The slice end to end: the port's ``ServeEngine`` against ``repro``'s.

Reduced ``deepseek-67b`` with the reference's weights (``params_from_jax``),
one 256-token document from ``np.random.default_rng``, chunk 64, three
greedy requests whose prefixes reuse one another.  Required: the same plans
(step ranges, reuse or gap per step), the same segment ids in the store
and identical greedy tokens.  Greedy only: ``jax.random`` and
``torch.Generator`` draw different numbers.

With an int8 segment store (and again with host and disk tiers below a
device budget) the same holds, plus equal dequantization and tier counters;
the last prefix position's logits agree within ``INT8_LOGIT_ATOL``: the
dequantized caches are bitwise equal across the packages (see
``tests/test_torch_quant.py``), so what remains is fp32 reduction order.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import PrefixCacheBuilder as JaxBuilder  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.kv_cache import SegmentStore as JaxStore  # noqa: E402
from repro.serve.session import doc_key as jax_doc_key  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve.engine import PrefixCacheBuilder, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore, slice_cache  # noqa: E402
from repro_torch.serve.session import doc_key  # noqa: E402

REQUESTS = [(200, 4), (256, 4), (130, 4)]
INT8_LOGIT_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("deepseek-67b"))
    cfg = reduced(get_config("deepseek-67b"))
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, tree, "cpu")
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
            for _ in range(3)]
    return jm, jparams, tm, params, docs


def _plan_steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id is not None) for s in plan.steps]


def test_serve_engine_matches_reference(setup):
    jm, jparams, tm, params, docs = setup
    doc = docs[0]
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=64)
    teng = ServeEngine(tm, params, doc, chunk_tokens=64, device="cpu")
    for prefix, n_new in REQUESTS:
        jt, jp = jeng.generate(prefix, n_new, greedy=True)
        tt, tp = teng.generate(prefix, n_new, greedy=True)
        assert _plan_steps(tp) == _plan_steps(jp)
        assert tp.models_used == jp.models_used
        assert tt == jt, (prefix, tt, jt)
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)
    assert teng.stats.tokens_reused == jeng.stats.tokens_reused > 0
    assert teng.stats.tokens_computed == jeng.stats.tokens_computed
    # each plan ends in a ragged gap, whose extend takes the last prefix
    # token in the port: (256, 8), (320, 57), (192, 2) where repro
    # dispatches (256, 7), (320, 56), (192, 1) and a 1-token extend at
    # 256 and 320
    assert jeng.builder.lowerings["extend"] == 5
    assert teng.builder.lowerings == {**jeng.builder.lowerings, "extend": 3}


def test_cold_serve_lowerings_bounded_by_buckets(setup):
    """Cold-serving three documents through one builder dispatches one
    shape set (the bound tests/test_prefill_recompile.py pins for the JAX
    package): one multi-chunk extend shape, three shapes in all (the
    prefill, the chunks, the ragged [224, 256) with the last prefix token;
    repro adds a 1-token extend)."""
    jm, jparams, tm, params, docs = setup
    tb = PrefixCacheBuilder(tm, params, SegmentStore(), chunk_tokens=32)
    jb = JaxBuilder(jm, jparams, JaxStore(), chunk_tokens=32)
    for i, doc in enumerate(docs):
        tb.prefix_with_logits(doc, 256, doc_id=f"d{i}", capacity=258)
        jb.prefix_with_logits(doc, 256, doc_id=f"d{i}", capacity=258)
    assert tb.lowerings["extend_many"] == 1, tb.lowerings
    assert tb.extend_lowerings == 3, tb.lowerings
    assert jb.lowerings["extend"] == 2
    assert tb.lowerings == {**jb.lowerings, "extend": 1}


def test_update_document_matches_reference(setup):
    jm, jparams, tm, params, docs = setup
    doc = docs[1]
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=64, doc_id=jax_doc_key(doc))
    teng = ServeEngine(tm, params, doc, chunk_tokens=64, doc_id=doc_key(doc),
                       device="cpu")
    assert teng.doc_id == jeng.doc_id
    jeng.generate(256, 2)
    teng.generate(256, 2)
    new_doc = doc.copy()
    new_doc[160] = (new_doc[160] + 1) % 512
    jep = jeng.update_document(new_doc)
    tep = teng.update_document(new_doc)
    assert (tep.action, tep.divergence, tep.reused_tokens, sorted(tep.orphans)) == \
        (jep.action, jep.divergence, jep.reused_tokens, sorted(jep.orphans))
    assert tep.action == "edit" and teng.doc_id == jeng.doc_id
    jt, jp = jeng.generate(256, 3)
    tt, tp = teng.generate(256, 3)
    assert _plan_steps(tp) == _plan_steps(jp) and tt == jt
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)


def test_reuse_is_exact_and_store_keeps_copies(setup):
    """A request replayed from stored segments gives the same tokens as its
    cold build, and no stored segment changes while later requests extend
    and decode in place (slices are copies, not views)."""
    _, _, tm, params, docs = setup
    eng = ServeEngine(tm, params, docs[2], chunk_tokens=64, device="cpu")
    cold, _ = eng.generate(192, 5)
    snap = {sid: [x.clone() for x in (s.caches[0]["p0"]["k"], s.caches[0]["p0"]["v"])]
            for sid, s in eng.store._segs.items()}
    warm, plan = eng.generate(192, 5)
    assert warm == cold and all(s.model_id is not None for s in plan.steps[:-1])
    eng.generate(256, 3)
    for sid, (k, v) in snap.items():
        seg = eng.store._segs[sid]
        assert torch.equal(seg.caches[0]["p0"]["k"], k)
        assert torch.equal(seg.caches[0]["p0"]["v"], v)


def test_store_budget_and_pins(setup):
    _, _, tm, params, docs = setup
    with torch.no_grad():
        _, caches = tm.prefill(params, {"tokens": torch.from_numpy(docs[0][None, :128])})
    store = SegmentStore(seq_bucket=32)
    ids = [store.put(Range(lo, lo + 32), slice_cache(caches, lo, lo + 32))
           for lo in range(0, 128, 32)]
    per_seg = store.nbytes() // 4
    assert store.capacity(ids[0]) == 32 and per_seg > 0
    store.byte_budget = 2 * per_seg
    with store.pinned(ids[:3]):
        store.put(Range(0, 16), slice_cache(caches, 0, 16))   # over budget
        assert all(i in store for i in ids[:3])             # pins hold
    assert store.nbytes() <= 2 * per_seg and store.evictions >= 3
    n = len(store)
    assert store.release_doc("doc") == n and len(store) == 0


def test_cli_single_session_on_cpu(capsys):
    from repro_torch.launch import serve as cli

    cli.main(["--arch", "deepseek-67b", "--reduced", "--device", "cpu",
              "--doc-len", "256", "--requests", "2", "--new-tokens", "3",
              "--chunk-tokens", "64"])
    out = capsys.readouterr().out
    assert "req 0: prefix" in out and "req 1: prefix" in out
    assert "2 requests: reuse" in out


@pytest.mark.parametrize("flag", [
    ["--shards", "2", "--shard-rtt", "1e-6"],
    ["--shards", "2", "--shard-bw", "1e9", "--hedge-deadline", "1e-6"],
])
def test_cli_unported_flags_name_the_roadmap(flag, capsys, monkeypatch):
    """The sharding flags (named for when they were not ported, and
    refused): ``--sessions 4`` over two shards, with ``--shard-rtt``, then
    with ``--shard-bw`` and a hedge deadline every fetch passes, so every
    remote document races a rebuild.  The port prints
    ``python -m repro.launch.serve``'s lines with the same flags (all of
    them under ``--sync-prefill``: the schedule is the script's), the
    wall-clock values and the decode route aside.  No decode write-back:
    the CLI samples, ``jax.random`` and ``torch.Generator`` draw different
    tokens, and a continuation's content key (so its home shard) follows
    its tokens."""
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    common = ["--arch", "deepseek-67b", "--reduced", "--doc-len", "256",
              "--sessions", "4", "--shared-docs", "2", "--requests", "2",
              "--new-tokens", "3", "--chunk-tokens", "64", "--sync-prefill",
              "--no-decode-materialize", *flag]
    cli.main(["--device", "cpu", *common])
    port = _multi_report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *common])
    jax_cli.main()
    ref = _multi_report(capsys.readouterr().out)
    assert port == ref
    traffic = [line for line in port if line.startswith("  fetch traffic (2 shards): ")]
    assert traffic and "0 coalesce violations" in traffic[0]
    assert sum(line.startswith(("  shard 0:", "  shard 1:")) for line in port) == 2
    if "--hedge-deadline" in flag:
        assert any(re.match(r"  hedging: [1-9]", line) for line in port)


#: wall-clock values in the multi-session report, and what differs by
#: design: the decode route's name (``repro``'s CPU route is "blocked",
#: the port's the kernel's) and the attention FLOPs that route reads
_MULTI_VOLATILE = (
    (re.compile(r"[0-9.]+ tok/s wall"), "tok/s wall"),
    (re.compile(r"mean join wait [0-9.]+ ms"), "mean join wait"),
    (re.compile(r"\w+ attention\)"), "attention)"),
    (re.compile(r"attn ~[0-9.]+ GFLOP"), "attn GFLOP"),
)
#: lines of the scheduler's schedule: ``repro``'s async prefill polls
#: whether the CPU finished a build, so where it overlapped a build with
#: decode its schedule followed the CPU's timing; under ``--sync-prefill``
#: the schedule is the script's alone and is always compared
_SCHEDULE = ("  scheduler:", "  decode packs", "  pipeline")


def _multi_report(out: str) -> list:
    keep = []
    for line in out.splitlines():
        for pat, repl in _MULTI_VOLATILE:
            line = pat.sub(repl, line)
        keep.append(line)
    return keep


@pytest.mark.parametrize("flags", [
    [],
    ["--edit-every", "1"],
    ["--edit-every", "1", "--edit-kind", "insert", "--segment-precision", "int8"],
    ["--sync-prefill"],
], ids=["sessions", "edit_every", "edit_kind_int8", "sync_prefill"])
def test_cli_multi_session_matches_reference(flags, capsys, monkeypatch):
    """``--sessions 4 --shared-docs 2`` on the CPU (with edit traffic, and
    with an int8 store whose reuse path runs ``quant_kv``'s plain version):
    the port prints ``python -m repro.launch.serve``'s lines with the same
    flags, wall-clock values and the decode route aside.  Under
    ``--sync-prefill`` the scheduler's lines are compared too."""
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    common = ["--arch", "deepseek-67b", "--reduced", "--doc-len", "512",
              "--sessions", "4", "--shared-docs", "2", "--requests", "2",
              "--new-tokens", "5", "--chunk-tokens", "64",
              "--byte-budget", "300000", *flags]
    cli.main(["--device", "cpu", *common])
    port = _multi_report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *common])
    jax_cli.main()
    ref = _multi_report(capsys.readouterr().out)
    assert port[0] == "4 sessions × 2 requests (2 on a shared doc):"
    if "--sync-prefill" in flags:
        assert sum(line.startswith(_SCHEDULE) for line in port) == len(_SCHEDULE)
        assert any(line.startswith("  pipeline (sync prefill): 0 builds launched")
                   for line in port)
    else:
        assert any(line.startswith("  pipeline (async prefill): 8 builds launched, "
                                   "8 joined") for line in port)
    if "--sync-prefill" not in flags and not any("0 decode rounds overlapped" in line
                                                 for line in ref):
        port = [line for line in port if not line.startswith(_SCHEDULE)]
        ref = [line for line in ref if not line.startswith(_SCHEDULE)]
    assert port == ref
    if "--edit-every" in flags:
        assert any(line.startswith("  edits: 8 applied") for line in port)
    if "int8" in flags:
        assert any(re.match(r"  precision \(int8 policy\): [1-9]", line) for line in port)


def test_cli_without_a_card_needs_device_cpu():
    from repro_torch.launch import serve as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--arch", "deepseek-67b", "--reduced"])
    assert "--device cpu" in str(exc.value.code)


@pytest.mark.parametrize("tiered", [False, True], ids=["int8", "int8_tiered"])
def test_int8_store_serving_matches_reference(setup, tmp_path, tiered):
    jm, jparams, tm, params, docs = setup
    doc = docs[0]
    kw = dict(precision="int8", seq_bucket=64)
    jkw, tkw = dict(kw), dict(kw)
    if tiered:
        with torch.no_grad():
            _, caches = tm.prefill(params, {"tokens": torch.from_numpy(doc[None, :64])})
        one = SegmentStore(device="cpu", **kw)
        one.put(Range(0, 64), caches)
        seg = one.nbytes()
        tiers = dict(byte_budget=2 * seg + 1, host_budget=seg + 1)
        jkw.update(tiers, spill_dir=tmp_path / "j")
        tkw.update(tiers, spill_dir=tmp_path / "t")
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=64, store=JaxStore(**jkw))
    teng = ServeEngine(tm, params, doc, chunk_tokens=64, store=SegmentStore(
        device="cpu", **tkw), device="cpu")
    for prefix, n_new in REQUESTS + [(256, 4)]:
        jt, jp = jeng.generate(prefix, n_new, greedy=True)
        tt, tp = teng.generate(prefix, n_new, greedy=True)
        assert _plan_steps(tp) == _plan_steps(jp)
        assert tp.models_used == jp.models_used
        assert tt == jt, (prefix, tt, jt)
    js, ts = jeng.store, teng.store
    js.flush_saves()
    ts.flush_saves()
    assert sorted(ts._segs) == sorted(js._segs)
    assert teng.builder.dequants == jeng.builder.dequants > 0
    assert ts.quantized == js.quantized == len(ts) == ts.quantized_segments()
    for name in ("demotions", "promotions", "evictions", "spill_writes"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.tier_bytes() == js.tier_bytes()
    if tiered:
        assert ts.demotions["host"] > 0 and ts.demotions["disk"] > 0
        assert ts.promotions["host"] + ts.promotions["disk"] > 0
    jl, _, jplan = jeng.builder.prefix_with_logits(doc, 200, doc_id=jeng.doc_id,
                                                   capacity=204)
    tl, _, tplan = teng.builder.prefix_with_logits(doc, 200, doc_id=teng.doc_id,
                                                   capacity=204)
    assert _plan_steps(tplan) == _plan_steps(jplan) and tplan.models_used
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=INT8_LOGIT_ATOL)


def _report(out: str) -> list:
    """The lines of the serve CLI's report that carry reuse and tier counts
    (sampled tokens, times and paths cut off)."""
    keep = []
    for line in out.splitlines():
        if line.startswith("req "):
            keep.append(line.split("tokens")[0])
        elif " requests: reuse " in line:
            keep.append(line.split(", planner")[0])
        elif line.startswith(("  tiers", "  tier traffic", "  precision")):
            keep.append(line)
        elif line.startswith(("warm start", "snapshot:")):
            keep.append(line.split(" from ")[0].split(" -> ")[0])
    return keep


def test_cli_residency_flags_match_reference(tmp_path, capsys, monkeypatch):
    """The residency flags on the CPU, run twice (the second run reloads the
    first run's snapshot): the port prints the reuse and tier counts that
    ``python -m repro.launch.serve`` prints with the same flags."""
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    def flags(root):
        return ["--arch", "deepseek-67b", "--reduced", "--doc-len", "256",
                "--requests", "3", "--new-tokens", "2", "--chunk-tokens", "64",
                "--byte-budget", "20000", "--host-budget", "12000",
                "--spill-dir", str(root / "spill"), "--segment-precision", "int8",
                "--store-dir", str(root / "store"), "--snapshot-every", "1"]

    outs = {}
    for run in (1, 2):
        cli.main(["--device", "cpu", *flags(tmp_path / "t")])
        outs["port", run] = capsys.readouterr().out
        monkeypatch.setattr("sys.argv", ["serve", *flags(tmp_path / "j")])
        jax_cli.main()
        outs["ref", run] = capsys.readouterr().out
    for run in (1, 2):
        port, ref = _report(outs["port", run]), _report(outs["ref", run])
        assert port == ref, (run, port, ref)
    assert any(line.startswith("warm start: reloaded") for line in _report(outs["port", 2]))
    traffic = [line for line in _report(outs["port", 2]) if "tier traffic" in line]
    assert traffic and "disk 0)" not in traffic[0]      # both tiers, both ways


def test_lossless_tiers_keep_streams_bit_identical(setup, tmp_path):
    """Model-precision segments through host and disk tiers are bitwise
    copies: the same greedy streams and logits as a device-only store."""
    _, _, tm, params, docs = setup
    doc = docs[1]
    plain = ServeEngine(tm, params, doc, chunk_tokens=64, device="cpu")
    with torch.no_grad():
        _, caches = tm.prefill(params, {"tokens": torch.from_numpy(doc[None, :64])})
    one = SegmentStore(device="cpu", precision="fp32")
    one.put(Range(0, 64), caches)
    seg = one.nbytes()
    tiered = ServeEngine(tm, params, doc, chunk_tokens=64, device="cpu", store=SegmentStore(
        device="cpu", precision="fp32", byte_budget=2 * seg + 1, host_budget=seg + 1,
        spill_dir=tmp_path / "spill"))
    for prefix, n_new in REQUESTS + [(256, 4)]:
        pt, pp = plain.generate(prefix, n_new)
        tt, tp = tiered.generate(prefix, n_new)
        assert tt == pt and _plan_steps(tp) == _plan_steps(pp)
    st = tiered.store
    assert min(st.demotions.values()) > 0 and min(st.promotions.values()) > 0
    assert st.quantized == 0 and st.evictions == 0
    pl, _, _ = plain.builder.prefix_with_logits(doc, 200, doc_id=plain.doc_id, capacity=204)
    tl, _, _ = tiered.builder.prefix_with_logits(doc, 200, doc_id=tiered.doc_id, capacity=204)
    assert torch.equal(pl, tl)
