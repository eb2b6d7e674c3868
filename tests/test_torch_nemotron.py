"""``nemotron-4-340b`` in the port against ``repro``: squared-ReLU (and the
other activations), ``expand_kv``, both attention kernels' plain routes at
head dim 192 with G 12, and the reduced model in two variants:

* ``reduced``: ``reduced(cfg)`` itself (d 64, 4 / 2 heads, hd 16);
* ``wide``: ``reduced(cfg)`` with 24 / 2 heads at hd 192, so G 12 and hd
  192 reach the extend and decode routes as at full width.

Weights come from ``repro``'s ``LM.init`` through ``params_from_jax``;
inputs and documents from ``np.random.default_rng``.  The JAX side runs on
the CPU, its Pallas kernels in interpret mode (``interpret=True``, or
``REPRO_EXTEND_KERNEL=1``, the TPU's route) or its blocked paths, the port
the kernels' plain versions.  Everything is fp32, so what differs is the
reduction order of XLA against torch: module outputs are held to
``MODULE_ATOL``, the model's logits to ``LOGIT_ATOL`` (measured on the CPU
over prefill, extend and decode: 1.5e-7 at hd 16, 7.0e-7 at hd 192), and
greedy streams, plans and segment ids must be equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.decode_attention import ops as jax_decode_ops  # noqa: E402
from repro.kernels.extend_attention import ops as jax_extend_ops  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jax_kv  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.session import SessionManager as JaxManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels.common import within_bf16_ulp  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import SPLIT  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_split  # noqa: E402
from repro_torch.kernels.extend_attention import ops as extend_ops  # noqa: E402
from repro_torch.kernels.extend_attention.ref import (  # noqa: E402
    extend_attention_ref, extend_attention_tiled)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import cache_len  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402
from _port_config import jax_fields  # noqa: E402

ARCH = "nemotron-4-340b"
#: fp32 module and attention outputs, XLA against torch
MODULE_ATOL = 1e-5
#: fp32 logits of the reduced model, XLA against torch
LOGIT_ATOL = 1e-4
#: elementwise activations, XLA against torch (a few fp32 ulps)
ACT_ATOL = 1e-6
KV, G, HD = 2, 12, 192


def _wide(cfg):
    return dataclasses.replace(cfg, n_heads=KV * G, n_kv_heads=KV, head_dim=HD)


VARIANTS = {"reduced": lambda cfg: cfg, "wide": _wide}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, atol=MODULE_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the config copy
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    for name, make in VARIANTS.items():
        assert jax_fields(make(reduced(full))) == \
            dataclasses.asdict(make(jax_reduced(jfull))), name
    assert jax_fields(full) == dataclasses.asdict(jfull)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.n_layers, full.activation, full.tie_embeddings) == \
        (18432, 96, 8, 192, 73728, 256000, 96, "squared_relu", False)


# ---------------------------------------------------------------------------
# activations and feed-forward layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["squared_relu", "silu", "gelu"])
def test_activation_fn_matches_reference(name):
    x = 3.0 * np.random.default_rng(1).standard_normal((64, 33))
    _close(common.activation_fn(name)(_t(x)),
           jax_common.activation_fn(name)(jnp.asarray(x, jnp.float32)), ACT_ATOL)


def test_activation_fn_refuses_swiglu():
    with pytest.raises(KeyError):
        common.activation_fn("swiglu")


@pytest.mark.parametrize("activation", ["squared_relu", "silu", "gelu", "swiglu"])
def test_dense_ffn_matches_reference(activation):
    rng = np.random.default_rng(2)
    d, ff = 64, 128
    w = {"w_up": 0.2 * rng.standard_normal((d, ff)),
         "w_down": 0.2 * rng.standard_normal((ff, d))}
    if activation == "swiglu":
        w["w_gate"] = 0.2 * rng.standard_normal((d, ff))
    x = rng.standard_normal((2, 5, d))
    want = jax_moe.dense_ffn({k: jnp.asarray(v, jnp.float32) for k, v in w.items()},
                             jnp.asarray(x, jnp.float32), activation)
    got = moe.dense_ffn({k: _t(v) for k, v in w.items()}, _t(x), activation)
    _close(got, want)


@pytest.mark.parametrize("activation", ["squared_relu", "gelu"])
def test_moe_ffn_other_activations_match_reference(activation):
    """The routed experts and the shared expert take ``act(x @ w_up) @
    w_down`` for an activation other than SwiGLU, as in ``repro``."""
    rng = np.random.default_rng(3)
    d, cfg = 64, MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                           d_ff_shared=32, capacity_factor=16.0)
    e, ff = cfg.n_experts, cfg.d_ff_expert
    ws = [0.3 * rng.standard_normal((d, e)), 0.1 * rng.standard_normal((e, d, ff)),
          0.1 * rng.standard_normal((e, d, ff)), 0.1 * rng.standard_normal((e, ff, d)),
          0.1 * rng.standard_normal((d, ff)), 0.1 * rng.standard_normal((d, ff)),
          0.1 * rng.standard_normal((ff, d))]
    x = rng.standard_normal((2, 6, d))

    def params(mod, conv):
        return mod.MoEParams(conv(ws[0]), mod.ExpertParams(*(conv(w) for w in ws[1:4])),
                             tuple(conv(w) for w in ws[4:]))

    jout, jaux = jax_moe.moe_ffn(params(jax_moe, lambda a: jnp.asarray(a, jnp.float32)),
                                 cfg, jnp.asarray(x, jnp.float32), activation=activation)
    tout, taux = moe.moe_ffn(params(moe, _t), cfg, _t(x), activation=activation)
    _close(tout, jout)
    assert abs(float(taux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------------------
# expand_kv
# ---------------------------------------------------------------------------

def test_expand_kv_prefill_matches_reference():
    """``self_attention(expand_kv=True)`` against ``repro``'s with the same
    flag and against the port's own grouped form; the cached (k, v) stay
    unexpanded."""
    rng = np.random.default_rng(4)
    d, s = 64, 24
    ws = [0.05 * rng.standard_normal(shape) for shape in
          ((d, KV * G, HD), (d, KV, HD), (d, KV, HD), (KV * G, HD, d))]
    x = rng.standard_normal((2, s, d))
    pos = np.broadcast_to(np.arange(s), (2, s))
    jout, (jk, jv) = jax_attn.self_attention(
        jax_attn.AttnParams(*(jnp.asarray(w, jnp.float32) for w in ws)),
        jnp.asarray(x, jnp.float32), jnp.asarray(pos), causal=True, theta=1e4, block=8,
        expand_kv=True)
    tp = attn.AttnParams(*(_t(w) for w in ws))
    outs = {flag: attn.self_attention(tp, _t(x), torch.from_numpy(pos.copy()), causal=True,
                                      theta=1e4, block=8, expand_kv=flag)
            for flag in (True, False)}
    tout, (tk, tv) = outs[True]
    assert tuple(tk.shape) == (2, s, KV, HD)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close(got, want)
    _close(outs[False][0], tout.numpy())
    k = torch.arange(6.0).reshape(1, 1, 2, 3)
    assert torch.equal(attn.expand_kv_heads(k, 4)[0, 0, :, 0], torch.tensor([0., 0., 3., 3.]))


def test_expand_kv_model_matches_reference():
    """A reduced-wide config with ``expand_kv`` set: ``LM.prefill``'s logits
    and caches against ``repro``'s with the same config."""
    cfg = dataclasses.replace(_wide(reduced(get_config(ARCH))), expand_kv=True)
    jm = JaxLM(dataclasses.replace(_wide(jax_reduced(jax_get_config(ARCH))), expand_kv=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, tree, "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, LOGIT_ATOL)
    for p, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the kernels' plain routes at hd 192, G 12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,t_real", [(1, 1), (1, 150), (7, 70), (32, 96), (32, 160)])
def test_extend_ops_hd192_matches_reference(nb, t_real):
    """The port's extend (its plain version here) against ``repro``'s Pallas
    kernel in interpret mode and against the bf16 kernel's tile walk
    (``extend_attention_tiled``): with P in fp32 within fp32 rounding, with
    bf16 operands and P as three bf16 terms within one bf16 ulp (+1e-6) of
    the fp32 plain version."""
    rng = np.random.default_rng(nb * 13 + t_real)
    b, t = 1, 160
    q = rng.standard_normal((b, nb, KV * G, HD))
    k = rng.standard_normal((b, t, KV, HD))
    v = rng.standard_normal((b, t, KV, HD))
    want = jax_extend_ops.extend_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                                           t_real=t_real, interpret=True)
    got = extend_ops.extend_attention(_t(q), _t(k), _t(v), t_real=t_real)
    assert tuple(got.shape) == (b, nb, KV * G, HD)
    _close(got, want)
    walk = extend_attention_tiled(_t(q), _t(k), _t(v), t_real=t_real)
    torch.testing.assert_close(walk, got, rtol=1e-5, atol=1e-6)
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    want_b = extend_attention_ref(qb.float(), kb.float(), vb.float(), t_real=t_real)
    ok, worst = within_bf16_ulp(
        extend_attention_tiled(qb, kb, vb, t_real=t_real, p_mode="bf16x3"), want_b)
    assert ok, worst


@pytest.mark.parametrize("t", [300, 700])
def test_decode_ops_hd192_matches_reference(t):
    """The port's decode (its plain blocked version here) and the plain form
    of the CUDA kernel's split algorithm against ``repro``'s Pallas decode
    kernel in interpret mode; the split form bitwise invariant to the padded
    capacity (a garbage tail past each row's pos)."""
    rng = np.random.default_rng(t)
    b = 3
    q = rng.standard_normal((b, 1, KV * G, HD)).astype(np.float32)
    k = rng.standard_normal((b, t, KV, HD)).astype(np.float32)
    v = rng.standard_normal((b, t, KV, HD)).astype(np.float32)
    pos = np.asarray([0, SPLIT - 1, t - 1], np.int32)
    want = jax_decode_ops.decode_attention(q, k, v, pos=jnp.asarray(pos), chunk=64,
                                           interpret=True)
    got = decode_ops.decode_attention(_t(q), _t(k), _t(v), pos=torch.from_numpy(pos))
    _close(got, want)
    qg = _t(q)[:, 0].reshape(b, KV, G, HD)
    split = decode_attention_split(qg, _t(k), _t(v), torch.from_numpy(pos), split=SPLIT)
    _close(split.reshape(b, 1, KV * G, HD), want)
    big = 1000 * rng.standard_normal((b, t + 333, KV, HD)).astype(np.float32)
    kb, vb = big.copy(), big[:, ::-1].copy()
    kb[:, :t], vb[:, :t] = k, v
    assert torch.equal(split, decode_attention_split(qg, _t(kb), _t(vb), torch.from_numpy(pos),
                                                     split=SPLIT))


# ---------------------------------------------------------------------------
# the reduced models through params_from_jax
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    make = VARIANTS[request.param]
    cfg = make(reduced(get_config(ARCH)))
    jm = JaxLM(make(jax_reduced(jax_get_config(ARCH))))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, tm, params


def test_param_layout_has_no_gate(models):
    """Squared-ReLU MLPs carry w_up and w_down only, as in ``repro``."""
    _, _, _, tm, params = models
    mlp = params["segments"][0]["p0"]["mlp"]
    assert sorted(mlp) == ["w_down", "w_up"]
    assert [spec.mixer + "/" + spec.mlp for period, _ in tm.segments for spec in period] \
        == ["attn/dense"]


def test_prefill_extend_many_decode_match_reference(models):
    """Prefill, a two-chunk ``prefill_extend_many`` and four decode steps:
    logits within ``LOGIT_ATOL``, caches close, greedy tokens equal."""
    cfg, jm, jparams, tm, params = models
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    s, chunk, cap, n_dec = 40, 16, 96, 4
    toks = rng.integers(0, cfg.vocab_size, (1, s + 2 * chunk)).astype(np.int32)
    worst = 0.0

    def leaves_close(tc, jc, upto):
        for p, j in zip(tree_leaves(tc), jax.tree.leaves(jc), strict=True):
            np.testing.assert_allclose(p.numpy()[:, :, :upto], np.asarray(j)[:, :, :upto],
                                       rtol=1e-4, atol=1e-4)

    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])})
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    leaves_close(tc, jc, s)
    jc, tc = jax_kv.pad_cache_to(jc, cap), kv_cache.pad_cache_to(tc, cap)
    slots = toks[:, s:].reshape(1, 2, chunk)
    jl, jc, _ = jax.jit(jm.prefill_extend_many)(tree, jc, jnp.asarray(slots),
                                                jnp.int32(s), jnp.int32(2))
    with torch.no_grad():
        tl, tc, _ = tm.prefill_extend_many(params, tc, torch.from_numpy(slots),
                                           torch.tensor(s, dtype=torch.int32), 2)
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    leaves_close(tc, jc, s + 2 * chunk)
    jdec = jax.jit(jm.decode_step)
    jtok, ttok = int(np.argmax(np.asarray(jl)[0])), int(torch.argmax(tl[0]))
    assert ttok == jtok
    for i in range(n_dec):
        p = s + 2 * chunk + i
        jl, jc = jdec(tree, jc, jnp.asarray([[jtok]], jnp.int32), jnp.asarray([p], jnp.int32))
        with torch.no_grad():
            tl, tc = tm.decode_step(params, tc, torch.tensor([[ttok]]),
                                    torch.tensor([p], dtype=torch.int32))
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        jtok, ttok = int(np.argmax(np.asarray(jl)[0])), int(torch.argmax(tl[0]))
        assert ttok == jtok, i
        leaves_close(tc, jc, p + 1)
    print(f"{cfg.head_dim=}: max |logit diff| {worst:.3g}")
    assert worst < LOGIT_ATOL, worst


def _steps(plan):
    return [(s.rng.lo, s.rng.hi, s.model_id) for s in plan.steps]


@pytest.mark.parametrize("mode", ["1", "0"], ids=["kernel", "blocked"])
def test_serve_matches_reference(models, mode, monkeypatch):
    """``ServeEngine``: the same greedy tokens, plans (with segment ids) and
    store as ``repro`` with its extend on the Pallas kernel in interpret
    mode and on its blocked path; the warm repeat is served from stored
    segments, and reuse gives scratch's tokens inside the port."""
    monkeypatch.setenv("REPRO_EXTEND_KERNEL", mode)
    cfg, jm, jparams, tm, params = models
    doc = np.random.default_rng(0).integers(0, cfg.vocab_size, 192).astype(np.int32)
    jeng = JaxEngine(jm, jparams, doc, chunk_tokens=32)
    teng = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    for prefix, n_new in ((96, 3), (96, 2), (160, 3)):
        jt, jp = jeng.generate(prefix, n_new)
        tt, tp = teng.generate(prefix, n_new)
        assert tt == jt, (prefix, tt, jt)
        assert _steps(tp) == _steps(jp)
    assert sorted(teng.store._segs) == sorted(jeng.store._segs)
    assert teng.stats.tokens_reused == jeng.stats.tokens_reused > 0
    cold = ServeEngine(tm, params, doc, chunk_tokens=32, device="cpu")
    assert cold.generate(160, 3)[0] == tt


SESSION_KW = dict(chunk_tokens=32, decode_bucket=32, async_prefill=False)


def _mixed_capacity(tm, params, docs, merge):
    mgr = SessionManager(tm, params, max_batch=8, merge_decode_packs=merge, **SESSION_KW)
    s = [mgr.add_session(d) for d in (docs[0], docs[0], docs[1], docs[1])]
    for sid, n in zip(s, (64, 96, 160, 40)):
        mgr.submit(sid, n, 5)
    mgr.step()
    groups = {g: cache_len(c) for g, c in mgr._packs.items()}
    out = mgr.run()
    return groups, [out[sid] for sid in s]


def _script(mgr, docs):
    s = [mgr.add_session(d) for d in (docs[0], docs[0], docs[1], docs[1])]
    streams, plans = [], []
    for reqs in (((s[0], 96, 4), (s[1], 128, 4), (s[2], 160, 4), (s[3], 64, 3)),
                 ((s[0], 192, 3), (s[1], 64, 2), (s[2], 96, 3), (s[3], 160, 2))):
        for sid, n, k in reqs:
            plan = mgr.submit(sid, n, k)
            plans.append(_steps(plan))
        streams.append(mgr.run())
    return streams, plans


def test_sessions_merged_split_and_reference(models):
    """Four sessions over two documents: merged packs of mixed capacity
    stream as capacity-split ones; the port's greedy streams, plans and
    segment ids equal ``repro``'s ``SessionManager``'s."""
    cfg, jm, jparams, tm, params = models
    rng = np.random.default_rng(6)
    docs = [rng.integers(0, cfg.vocab_size, 192).astype(np.int32) for _ in range(2)]
    merged_groups, merged = _mixed_capacity(tm, params, docs, merge=True)
    split_groups, split = _mixed_capacity(tm, params, docs, merge=False)
    assert len(merged_groups) == 1 and len(split_groups) > 1
    assert merged == split and all(len(x) == 5 for x in merged)
    jmgr, tmgr = JaxManager(jm, jparams, **SESSION_KW), SessionManager(tm, params, **SESSION_KW)
    jres, tres = _script(jmgr, docs), _script(tmgr, docs)
    assert tres == jres
    assert sorted(tmgr.store._segs) == sorted(jmgr.store._segs)
    assert tmgr.store.cross_session_hits == jmgr.store.cross_session_hits > 0


def _report(out: str) -> list:
    """The CLI's reuse lines: request lines up to their tokens, the summary
    up to its timings."""
    keep = []
    for line in out.splitlines():
        if line.startswith("req "):
            keep.append(line.split("tokens")[0])
        elif " requests: reuse " in line:
            keep.append(line.split(", planner")[0])
    return keep


def test_cli_on_cpu_matches_reference(capsys, monkeypatch):
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli

    flags = ["--arch", ARCH, "--reduced", "--doc-len", "256", "--requests", "3",
             "--new-tokens", "3", "--chunk-tokens", "64"]
    cli.main(["--device", "cpu", *flags])
    port = _report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jax_cli.main()
    ref = _report(capsys.readouterr().out)
    assert len(port) == 3 + 1 and port == ref
