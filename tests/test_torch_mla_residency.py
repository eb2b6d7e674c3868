"""MLA's headless latent cache leaves (``c_kv`` (L, B, T, kv_lora) and
``k_rope`` (L, B, T, rope), no head axis) through the port's cache-tree
helpers and residency, against ``repro``'s on the same inputs.

Required exactly: ``cache_len``, ``slice_cache``, ``concat_caches``,
``pad_cache_to``, ``insert_cache``, ``cache_nbytes``, ``batch_caches`` /
``split_caches``, ``batch_signature``, and the int8 codes, scales and
round trip of ``quantize_tree`` / ``dequantize_tree`` per leaf.  Then
reduced ``deepseek-v2-236b`` served over an int8 store with host and disk
tiers below a device budget: the same greedy tokens, plans, segment ids,
dequantizations and tier counters as ``repro``'s engine.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.kv_cache import SegmentStore as JaxStore  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import session as tsession  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore  # noqa: E402

ARCH = "deepseek-v2-236b"


def _latent_caches(rng, t, b=1):
    """The reduced model's cache tree: a dense segment of 1 layer and an MoE
    segment of 2, each MLA (kv_lora 16, rope 8)."""
    return [{"p0": {"c_kv": rng.standard_normal((n, b, t, 16)).astype(np.float32),
                    "k_rope": rng.standard_normal((n, b, t, 8)).astype(np.float32)}}
            for n in (1, 2)]


def _port(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl) == 4
    for p, j in zip(pl, jl):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_cache_helpers_match_reference_on_latent_leaves():
    rng = np.random.default_rng(0)
    a, seg = _latent_caches(rng, 40), _latent_caches(rng, 16)
    ta, ja = _port(a), _jax(a)
    assert tkv.cache_len(ta) == jkv.cache_len(ja) == 40
    assert tkv.cache_nbytes(ta) == jkv.cache_nbytes(ja) > 0
    _same(tkv.slice_cache(ta, 8, 24), jkv.slice_cache(ja, 8, 24))
    _same(tkv.concat_caches(ta, _port(seg)), jkv.concat_caches(ja, _jax(seg)))
    tpad, jpad = tkv.pad_cache_to(ta, 64), jkv.pad_cache_to(ja, 64)
    _same(tpad, jpad)
    _same(tkv.insert_cache(tpad, _port(seg), 40), jkv.insert_cache(jpad, _jax(seg), 40))
    rows = [_latent_caches(rng, 32) for _ in range(3)]
    tb = tsession.batch_caches([_port(r) for r in rows])
    jb = jsession.batch_caches([_jax(r) for r in rows])
    _same(tb, jb)
    for tr, jr in zip(tsession.split_caches(tb, 3), jsession.split_caches(jb, 3)):
        _same(tr, jr)
    assert tsession.batch_signature(tb) == tsession.batch_signature(_port(rows[0]))


@pytest.mark.parametrize("block", [8, 16])
def test_int8_latent_leaves_match_reference(block):
    rng = np.random.default_rng(block)
    tree = _latent_caches(rng, 40)
    tqt, tmeta = tq.quantize_tree(_port(tree), block=block)
    jqt, jmeta = jq.quantize_tree(_jax(tree), block=block)
    _same(tqt, jqt)                                  # int8 codes
    assert sorted(tmeta.scales) == sorted(jmeta.scales)
    for key in tmeta.scales:
        np.testing.assert_array_equal(tmeta.scales[key].numpy(),
                                      np.asarray(jmeta.scales[key]))
    _same(tq.dequantize_tree(tqt, tmeta), jq.dequantize_tree(jqt, jmeta, mode="ref"))


def test_int8_tiered_serving_matches_reference(tmp_path):
    cfg = reduced(get_config(ARCH))
    jm = JaxLM(jax_reduced(jax_get_config(ARCH)))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    with torch.no_grad():
        _, caches = tm.prefill(params, {"tokens": torch.from_numpy(doc[None, :64])})
    kw = dict(precision="int8", seq_bucket=64)
    one = SegmentStore(device="cpu", **kw)
    one.put(Range(0, 64), caches)
    seg = one.nbytes()
    tiers = dict(byte_budget=2 * seg + 1, host_budget=seg + 1)
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=64,
                     store=JaxStore(spill_dir=tmp_path / "j", **kw, **tiers))
    teng = ServeEngine(tm, params, doc, chunk_tokens=64, device="cpu", store=SegmentStore(
        device="cpu", spill_dir=tmp_path / "t", **kw, **tiers))
    for prefix, n_new in ((200, 4), (256, 4), (130, 4), (256, 4)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert [(s.rng.lo, s.rng.hi, s.model_id) for s in tp.steps] == \
            [(s.rng.lo, s.rng.hi, s.model_id) for s in jp.steps]
    js, ts = jeng.store, teng.store
    js.flush_saves()
    ts.flush_saves()
    assert sorted(ts._segs) == sorted(js._segs)
    assert teng.builder.dequants == jeng.builder.dequants > 0
    for name in ("demotions", "promotions", "evictions", "spill_writes", "quantized"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.tier_bytes() == js.tier_bytes()
    assert ts.demotions["disk"] > 0 and ts.promotions["host"] + ts.promotions["disk"] > 0
