"""Serving reduced ``mamba2-130m`` (pure SSD, 2 layers) and
``jamba-v0.1-52b`` (one 8-layer period: SSD at 0–3 and 5–7, GQA at 4, MoE
on every second layer) in the port, against ``repro``.

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``,
documents and cache trees from ``np.random.default_rng``; fp32 on the CPU.
Held:

* the config copies equal ``repro``'s, and the full configs' spec trees
  hold ``repro``'s parameter count; decoding a token after a prefill gives
  a longer prefill's logits (``test_arch_smoke.py``'s serving contracts);
* ``prefill``, ``prefill_extend_many`` (chunk 64 over ``ssm.chunk`` 32:
  the multi-chunk scan, and its per-chunk state snapshots),
  ``prefill_extend`` (16 tokens, one scan chunk) and ``decode_step``:
  logits within ``LOGIT_ATOL``, every cache leaf within ``NORMWISE`` of
  ``repro``'s, normwise (measured: logits at most 3.6e-7, leaves 2.5e-6);
* ``ServeEngine``: reuse equals scratch inside the port, a stored
  segment's state survives the in-place extends of a later request built
  on it, and tokens, plans, segment ids and lowerings equal ``repro``'s
  (``tests/test_torch_ssd_sessions.py`` holds ``SessionManager``, plain
  and sharded, and the CLI);
* the cache helpers, ``quantize_tree`` and an int8 store with host and disk
  tiers and a snapshot keep state leaves (fp32 and bf16) bitwise, as
  ``repro`` does; served over such a store, tokens, plans, ids and tier
  counters equal ``repro``'s;
* a segment with state leaves encodes to ``repro``'s wire frame byte for
  byte on both wires;
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.descriptors import Range as JaxRange  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro.serve import shard_store as jshard  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import session as tsession  # noqa: E402
from repro_torch.serve import shard_store as tshard  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore  # noqa: E402
from _port_config import jax_fields  # noqa: E402

ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
#: each arch's reduced layer kinds
LAYERS = {"mamba2-130m": ["ssd/none"],
          "jamba-v0.1-52b": ["ssd/dense", "ssd/moe", "ssd/dense", "ssd/moe",
                             "attn/dense", "ssd/moe", "ssd/dense", "ssd/moe"]}
#: fp32 logits of a reduced model, XLA against torch
LOGIT_ATOL = 1e-4
#: cache leaves, max|Δ| / max|ref|
NORMWISE = 1e-5


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


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not want.size:                    # a snapshot's placeholder leaf
        return float(got.size)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


def _leaves_close(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        assert tuple(p.shape) == tuple(j.shape)
        assert _normwise(p.numpy(), j) <= NORMWISE, tuple(p.shape)


def _steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    full, jfull = get_config(arch), jax_get_config(arch)
    assert jax_fields(full) == dataclasses.asdict(jfull)
    small = reduced(full)
    assert jax_fields(small) == dataclasses.asdict(jax_reduced(jfull))
    assert (small.ssm.d_state, small.ssm.head_dim, small.ssm.chunk) == (16, 16, 32)
    assert LM(full, device="cpu").specs      # the full-size stack builds (no allocation)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_reference(arch):
    """``test_arch_smoke.py``'s spec-tree contract at the published widths:
    the port's spec tree has ``repro``'s leaves and count, within the
    published scale."""
    from repro.models.common import param_count
    from repro.models.lm import param_specs as jax_param_specs
    from repro_torch.models.lm import param_specs

    cfg = get_config(arch)
    port = {path: s.shape for path, s in _spec_leaves(param_specs(cfg))}
    ref = jax_param_specs(jax_get_config(arch))
    n = sum(int(np.prod(shape)) for shape in port.values())
    assert n == param_count(ref)
    lo, hi = {"mamba2-130m": (0.10e9, 0.16e9), "jamba-v0.1-52b": (46e9, 58e9)}[arch]
    assert lo <= n <= hi


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, tree


def test_decode_equals_a_longer_prefill(models):
    """``test_arch_smoke.py``'s serving contract inside the port: two rows,
    prefill 16 tokens then decode the 17th, against a prefill of 17."""
    _, cfg, _, _, tm, params, _ = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int64))
    with torch.no_grad():
        _, caches = tm.prefill(params, {"tokens": toks[:, :16]})
        caches = tkv.pad_cache_to(caches, 20)
        got, _ = tm.decode_step(params, caches, toks[:, 16:], torch.full((2,), 16,
                                                                         dtype=torch.int32))
        want, _ = tm.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_entry_points_match_reference(models):
    """Prefill 40 tokens, two 64-token chunks through ``prefill_extend_many``
    (three slots), a 16-token extend, then four greedy decode steps."""
    arch, cfg, jm, jparams, tm, params, _ = models
    assert [f"{s.mixer}/{s.mlp}" for period, _ in tm.segments
            for s in period] == LAYERS[arch]
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    s0, chunk, cap = 40, 64, 192
    toks = rng.integers(0, cfg.vocab_size, (1, cap)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks[:, :s0])})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :s0])})
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_ATOL
    _leaves_close(tc, jc)
    jc, tc = jkv.pad_cache_to(jc, cap), tkv.pad_cache_to(tc, cap)

    slots = np.zeros((1, 3, chunk), np.int32)
    slots[0, :2] = toks[0, s0:s0 + 2 * chunk].reshape(2, chunk)
    jl, jc, jsnap = jax.jit(jm.prefill_extend_many)(
        tree, jc, jnp.asarray(slots), jnp.int32(s0), jnp.int32(2))
    with torch.no_grad():
        tl, tc, tsnap = tm.prefill_extend_many(params, tc, torch.from_numpy(slots), s0, 2)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_ATOL
    _leaves_close(tc, jc)
    _leaves_close(tsnap, jsnap)
    # each chunk's snapshot is its own end state (slot 2 was never run)
    snaps = [x for x in tree_leaves(tsnap) if x.numel()]
    assert snaps and all(not torch.equal(x[0], x[1]) and not x[2].any() for x in snaps)

    start = s0 + 2 * chunk
    jl, jc = jax.jit(jm.prefill_extend)(tree, jc, jnp.asarray(toks[:, start:start + 16]),
                                        jnp.int32(start))
    with torch.no_grad():
        tl, tc = tm.prefill_extend(params, tc, torch.from_numpy(toks[:, start:start + 16]),
                                   start)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_ATOL
    _leaves_close(tc, jc)

    pos = start + 16
    for _ in range(4):
        tok = int(np.argmax(np.asarray(jl)[0]))
        assert int(torch.argmax(tl[0])) == tok
        jl, jc = jax.jit(jm.decode_step)(tree, jc, jnp.asarray([[tok]], jnp.int32),
                                         jnp.asarray([pos], jnp.int32))
        with torch.no_grad():
            tl, tc = tm.decode_step(params, tc, torch.tensor([[tok]]),
                                    torch.tensor([pos], dtype=torch.int32))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_ATOL
        pos += 1
    _leaves_close(tc, jc)


def test_reuse_matches_scratch(models):
    _, _, _, _, tm, params, (doc, _) = models
    warm = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    warm.generate(96, 3)
    reused0 = warm.stats.tokens_reused
    toks, plan = warm.generate(160, 3)
    cold = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    toks_ref, _ = cold.generate(160, 3)
    assert toks == toks_ref
    assert warm.stats.tokens_reused > reused0
    assert len(plan.models_used) > 0


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_stored_state_survives_later_extends(models, precision):
    """A request whose plan is one stored segment [0, 32) and then extends
    writes SSD state in place: into its own working cache, never into the
    stored segment, so a repeat of the first request gives its tokens."""
    _, _, _, _, tm, params, (doc, _) = models
    store = SegmentStore(precision=precision, device="cpu")
    eng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu", store=store)
    first, _ = eng.generate(33, 4)
    stored = {sid: [x.clone() for x in tree_leaves(seg.caches)]
              for sid, seg in store._segs.items()}
    _, plan = eng.generate(96, 3)
    assert _steps(plan)[0][2] in stored and _steps(plan)[1][2] is None
    again, plan = eng.generate(33, 4)
    assert again == first and len(plan.models_used) == 1
    for sid, leaves in stored.items():
        assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(store._segs[sid].caches)))


def test_serve_matches_reference(models):
    """``test_serve.py``'s requests and a repeat of a short one: the same
    tokens, plans, segment ids and lowerings as ``repro``."""
    _, _, jm, jparams, tm, params, (doc, _) = models
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=32)
    teng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    for prefix, n_new in ((96, 3), (96, 2), (160, 3), (33, 3), (192, 2)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert _steps(tp) == _steps(jp)
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)
    assert teng.stats.tokens_reused == jeng.stats.tokens_reused > 0
    assert teng.builder.lowerings == jeng.builder.lowerings


# ---------------------------------------------------------------------------
# state leaves through the store, tiers, int8 and snapshots
# ---------------------------------------------------------------------------

def _hybrid_caches(rng, t, b=1, dtype=np.float32):
    """A reduced jamba-like cache tree: SSD layers' conv (L, B, 3, 160) and
    ssm (L, B, 8, 16, 16), one attention layer's k/v (1, B, t, 2, 16)."""
    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)
    return [{"p0": {"conv": r(2, b, 3, 160), "ssm": r(2, b, 8, 16, 16)},
             "p1": {"k": r(1, b, t, 2, 16), "v": r(1, b, t, 2, 16)}}]


def _port(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl) == 4
    for p, j in zip(pl, jl):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_cache_helpers_match_reference_on_state_leaves():
    rng = np.random.default_rng(0)
    a, seg = _hybrid_caches(rng, 40), _hybrid_caches(rng, 16)
    ta, ja = _port(a), _jax(a)
    assert tkv.cache_len(ta) == jkv.cache_len(ja) == 40
    assert tkv.cache_len(_port([{"p0": a[0]["p0"]}])) == 0
    assert tkv.cache_nbytes(ta) == jkv.cache_nbytes(ja) > 0
    _same(tkv.slice_cache(ta, 8, 24), jkv.slice_cache(ja, 8, 24))
    _same(tkv.concat_caches(ta, _port(seg)), jkv.concat_caches(ja, _jax(seg)))
    tpad, jpad = tkv.pad_cache_to(ta, 64), jkv.pad_cache_to(ja, 64)
    _same(tpad, jpad)
    _same(tkv.insert_cache(tpad, _port(seg), 40), jkv.insert_cache(jpad, _jax(seg), 40))
    snaps = [{"p0": {"conv": rng.standard_normal((3, 2, 1, 3, 160)).astype(np.float32),
                     "ssm": rng.standard_normal((3, 2, 1, 8, 16, 16)).astype(np.float32)},
              "p1": {"k": np.zeros((0,), np.float32), "v": np.zeros((0,), np.float32)}}]
    _same(tkv.chunk_segment(ta, _port(snaps), 1, 8, 24),
          jkv.chunk_segment(ja, _jax(snaps), 1, 8, 24))
    adopted = tkv.adopt_cache(ta, 64)
    _same(adopted, jpad)
    assert not {x.data_ptr() for x in tree_leaves(adopted)} & \
        {x.data_ptr() for x in tree_leaves(ta)}
    rows = [_hybrid_caches(rng, 32) for _ in range(3)]
    tb = tsession.batch_caches([_port(r) for r in rows])
    jb = jsession.batch_caches([_jax(r) for r in rows])
    _same(tb, jb)
    for tr, jr in zip(tsession.split_caches(tb, 3), jsession.split_caches(jb, 3)):
        _same(tr, jr)
    assert tsession.batch_signature(tb) == tsession.batch_signature(_port(rows[0]))


def test_int8_codes_leave_state_lossless():
    """``quantize_tree`` quantizes k/v only, bitwise ``repro``'s codes and
    scales; conv/ssm pass through with their dtype, and the round trip
    gives them back bitwise."""
    tree = _hybrid_caches(np.random.default_rng(3), 40)
    tqt, tmeta = tq.quantize_tree(_port(tree), block=16)
    jqt, jmeta = jq.quantize_tree(_jax(tree), block=16)
    _same(tqt, jqt)
    assert sorted(tmeta.scales) == sorted(jmeta.scales) and len(tmeta.scales) == 2
    for key in tmeta.scales:
        np.testing.assert_array_equal(tmeta.scales[key].numpy(), np.asarray(jmeta.scales[key]))
    back = tq.dequantize_tree(tqt, tmeta)
    _same(back, jq.dequantize_tree(jqt, jmeta, mode="ref"))
    for name in ("conv", "ssm"):
        assert tqt[0]["p0"][name].dtype == torch.float32
        np.testing.assert_array_equal(back[0]["p0"][name].numpy(), tree[0]["p0"][name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tiers_and_snapshot_keep_state_bitwise(tmp_path, dtype):
    """Segments with state leaves in an int8 store under a device and a
    host budget: each demoted to host and disk and promoted back, then
    saved and reloaded; the state leaves stay bitwise, k/v keep their
    int8 codes."""
    rng = np.random.default_rng(5)
    trees = [jax.tree.map(lambda x: torch.from_numpy(x).to(dtype), _hybrid_caches(rng, 32))
             for _ in range(4)]
    probe = SegmentStore(precision="int8", seq_bucket=32, device="cpu")
    probe.put(Range(0, 32), trees[0])
    seg = probe.nbytes()
    st = SegmentStore(precision="int8", seq_bucket=32, device="cpu",
                      byte_budget=2 * seg + 1, host_budget=seg + 1,
                      spill_dir=tmp_path / "spill")
    sids = [st.put(Range(32 * i, 32 * (i + 1)), t) for i, t in enumerate(trees)]
    codes = {}
    for sid, t in zip(sids, trees):
        got = st.get(sid)
        assert got.precision == "int8"
        for name in ("conv", "ssm"):
            x = got.caches[0]["p0"][name]
            assert x.dtype == dtype and torch.equal(x, t[0]["p0"][name])
        codes[sid] = [x.clone() for x in tree_leaves(got.caches)]
    assert st.demotions["host"] > 0 and st.demotions["disk"] > 0
    assert st.promotions["host"] + st.promotions["disk"] > 0
    st.flush_saves()
    st.save(tmp_path / "snap")
    back = SegmentStore.load(tmp_path / "snap", device="cpu")
    for sid in sids:
        assert all(torch.equal(a, b) for a, b in
                   zip(codes[sid], tree_leaves(back.get(sid).caches)))


def test_int8_tiered_serving_matches_reference(models, tmp_path):
    arch, cfg, jm, jparams, tm, params, (doc, _) = models
    with torch.no_grad():
        _, caches = tm.prefill(params, {"tokens": torch.from_numpy(doc[None, :32])})
    kw = dict(precision="int8", seq_bucket=32)
    one = SegmentStore(device="cpu", **kw)
    one.put(Range(0, 32), caches)
    seg = one.nbytes()
    tiers = dict(byte_budget=2 * seg + 1, host_budget=seg + 1)
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=32,
                     store=jkv.SegmentStore(spill_dir=tmp_path / "j", **kw, **tiers))
    teng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu", store=SegmentStore(
        device="cpu", spill_dir=tmp_path / "t", **kw, **tiers))
    for prefix, n_new in ((96, 3), (160, 3), (96, 2), (192, 2)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert _steps(tp) == _steps(jp)
    js, ts = jeng.store, teng.store
    js.flush_saves()
    ts.flush_saves()
    assert sorted(ts._segs) == sorted(js._segs)
    assert teng.builder.dequants == jeng.builder.dequants
    for name in ("demotions", "promotions", "evictions", "spill_writes", "quantized"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.tier_bytes() == js.tier_bytes()
    assert ts.demotions["disk"] > 0 and ts.promotions["host"] + ts.promotions["disk"] > 0
    # jamba's k/v are int8 and dequantized on reuse; mamba has no sequence
    # leaf, so nothing is quantized and its segments stay lossless
    assert (teng.builder.dequants > 0) == (arch == "jamba-v0.1-52b")


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["int8", "fp32"])
def test_wire_frame_with_state_is_reference_frame(precision):
    tree = _hybrid_caches(np.random.default_rng(9), 20)
    ours = SegmentStore(seq_bucket=16, precision="fp32", device="cpu")
    theirs = jkv.SegmentStore(seq_bucket=16, precision="fp32")
    ours.put(Range(0, 20), _port(tree), doc_id="d", seg_id="s")
    theirs.put(JaxRange(0, 20), _jax(tree), doc_id="d", seg_id="s")
    data = tshard.encode_segment(ours, ours.get("s"), precision=precision)
    assert data == jshard.encode_segment(theirs, theirs.get("s"), precision=precision)
    got = tshard.decode_segment(data, device="cpu")
    assert got.precision == precision
    for name in ("conv", "ssm"):
        np.testing.assert_array_equal(got.caches[0]["p0"][name].numpy(), tree[0]["p0"][name])
    if precision == "fp32":
        np.testing.assert_array_equal(got.caches[0]["p1"]["k"][:, :, :20].numpy(),
                                      tree[0]["p1"]["k"])
