"""MLA in the port against ``repro``: the extend kernel's MLA form, the MLA
modules, and reduced ``deepseek-v2-236b`` through ``params_from_jax``.

Inputs are made with ``np.random.default_rng``; the JAX side runs on the
CPU, its Pallas extend kernel in interpret mode (``REPRO_EXTEND_KERNEL=1``,
the TPU's route) or its blocked-softmax path (``=0``), the port the
kernels' plain versions.  Everything is fp32, so what differs is the
reduction order of XLA against torch: module outputs are held to
``MODULE_ATOL`` and the model's logits to ``LOGIT_ATOL`` (measured on the
CPU: at most 1.8e-7 over prefill, extend and decode), greedy streams must
be equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.extend_attention import ops as jax_extend_ops  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve import kv_cache as jax_kv  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.common import within_bf16_ulp  # noqa: E402
from repro_torch.kernels.extend_attention import ops as extend_ops  # noqa: E402
from repro_torch.kernels.extend_attention.ref import (  # noqa: E402
    extend_attention_ref, extend_attention_tiled)
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map_with_path  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from _port_config import jax_fields  # noqa: E402

ARCH = "deepseek-v2-236b"
#: fp32 attention outputs and module outputs, XLA against torch
MODULE_ATOL = 1e-5
#: fp32 logits of the reduced model, XLA against torch
LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# the config copy
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH)))):
        # field by field, MLAConfig and MoEConfig included
        assert jax_fields(port) == dataclasses.asdict(ref)
    full = get_config(ARCH)
    assert (full.moe.capacity_factor, full.moe_groups) == (1.25, 1)
    assert (full.mla.qk_nope_head_dim + full.mla.qk_rope_head_dim,
            full.mla.v_head_dim, full.n_heads) == (192, 128, 128)


# ---------------------------------------------------------------------------
# ops.extend_attention_mla against repro's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _mla_operands(rng, b, nb, h, t, nope, rope, hv):
    return (rng.standard_normal((b, nb, h, nope)), rng.standard_normal((b, nb, h, rope)),
            rng.standard_normal((b, t, h, nope)), rng.standard_normal((b, t, rope)),
            rng.standard_normal((b, t, h, hv)))


@pytest.mark.parametrize("nope,rope,hv,b,h,t,nb,t_real", [
    (16, 8, 16, 2, 4, 96, 1, 50),        # reduced widths (q·k 24, v 16)
    (16, 8, 16, 2, 4, 96, 7, 70),
    (16, 8, 16, 1, 4, 96, 32, 64),
    (16, 8, 16, 1, 4, 96, 32, 95),
    (128, 64, 128, 1, 2, 64, 8, 40),     # full widths (q·k 192, v 128)
], ids=["r_nb1", "r_nb7", "r_nb32", "r_nb32_edge", "full"])
def test_extend_attention_mla_matches_reference(nope, rope, hv, b, h, t, nb, t_real):
    ops = _mla_operands(np.random.default_rng(nb + t_real), b, nb, h, t, nope, rope, hv)
    want = jax_extend_ops.extend_attention_mla(
        *(jnp.asarray(x, jnp.float32) for x in ops), t_real=t_real, interpret=True)
    got = extend_ops.extend_attention_mla(*(_t(x) for x in ops), t_real=t_real)
    assert tuple(got.shape) == (b, nb, h, hv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_ATOL)


@pytest.mark.parametrize("nope,rope,hv", [(16, 8, 16), (128, 64, 128)],
                         ids=["reduced", "full"])
@pytest.mark.parametrize("nb,t_real", [(1, 1), (1, 150), (100, 100), (128, 200)])
def test_kernel_walk_at_mla_widths(nope, rope, hv, nb, t_real):
    """The bf16 kernel's tile walk (``extend_attention_tiled``) at MLA's
    widths, G 1: with P in fp32 it is the plain version within fp32
    rounding, and with P as three bf16 terms on bf16 operands it stays
    within one bf16 ulp (+1e-6) of the fp32 plain version, the bound the
    kernel is held to on the card."""
    b, h, t = 1, 2, 256
    rng = np.random.default_rng(nb * 7 + t_real)
    ops = [_t(x) for x in _mla_operands(rng, b, nb, h, t, nope, rope, hv)]
    q, k = extend_ops.pack_mla(*ops[:4])
    v = ops[4]
    want = extend_attention_ref(q, k, v, t_real=t_real)
    walk = extend_attention_tiled(q, k, v, t_real=t_real)
    torch.testing.assert_close(walk, want, rtol=1e-5, atol=1e-6)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want_b = extend_attention_ref(qb.float(), kb.float(), vb.float(), t_real=t_real)
    got_b = extend_attention_tiled(qb, kb, vb, t_real=t_real, p_mode="bf16x3")
    ok, worst = within_bf16_ulp(got_b, want_b)
    assert ok, worst


# ---------------------------------------------------------------------------
# the MLA modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_setup():
    cfg = reduced(get_config(ARCH))
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    rng = np.random.default_rng(3)
    shapes = [(d, m.q_lora_rank), (m.q_lora_rank,),
              (m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
              (d, m.kv_lora_rank + m.qk_rope_head_dim), (m.kv_lora_rank,),
              (m.kv_lora_rank, h, m.qk_nope_head_dim),
              (m.kv_lora_rank, h, m.v_head_dim), (h, m.v_head_dim, d)]
    ws = [1.0 + 0.1 * rng.standard_normal(s) if len(s) == 1
          else 0.2 * rng.standard_normal(s) for s in shapes]
    jp = jax_mla.MLAParams(*(jnp.asarray(w, jnp.float32) for w in ws))
    tp = mla.MLAParams(*(_t(w) for w in ws))
    return cfg, jp, tp, rng


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_ATOL)


def test_mla_self_attention_matches_reference(mla_setup):
    cfg, jp, tp, rng = mla_setup
    x = rng.standard_normal((2, 24, cfg.d_model))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    jout, (jc, jr) = jax_mla.mla_self_attention(jp, cfg.mla, jnp.asarray(x, jnp.float32),
                                                jnp.asarray(pos), theta=cfg.rope_theta,
                                                block=8)
    tout, (tc, tr) = mla.mla_self_attention(tp, cfg.mla, _t(x), torch.from_numpy(pos.copy()),
                                            theta=cfg.rope_theta, block=8)
    for got, want in ((tout, jout), (tc, jc), (tr, jr)):
        _close(got, want)


@pytest.mark.parametrize("mode", ["1", "0"], ids=["kernel", "blocked"])
def test_mla_extend_matches_reference(mla_setup, mode, monkeypatch):
    """The port's extend (the kernel route, its plain version here) against
    ``repro``'s Pallas route and its blocked route; the latent is written in
    place at ``start`` and the cache's tail past start + nb is garbage."""
    monkeypatch.setenv("REPRO_EXTEND_KERNEL", mode)
    cfg, jp, tp, rng = mla_setup
    m = cfg.mla
    b, cap, start, nb = 2, 64, 21, 11
    h = rng.standard_normal((b, nb, cfg.d_model))
    ckv = rng.standard_normal((b, cap, m.kv_lora_rank))
    krope = rng.standard_normal((b, cap, m.qk_rope_head_dim))
    pos = np.broadcast_to(start + np.arange(nb), (b, nb))
    jout, (jc, jr) = jax_mla.mla_extend(
        jp, m, jnp.asarray(h, jnp.float32), jnp.asarray(ckv, jnp.float32),
        jnp.asarray(krope, jnp.float32), jnp.asarray(pos), jnp.int32(start),
        theta=cfg.rope_theta, block=16)
    tc, tr = _t(ckv), _t(krope)
    tout, (tc2, tr2) = mla.mla_extend(tp, m, _t(h), tc, tr, torch.from_numpy(pos.copy()),
                                      torch.tensor(start, dtype=torch.int32),
                                      theta=cfg.rope_theta)
    assert tc2 is tc and tr2 is tr                       # in place
    for got, want in ((tout, jout), (tc, jc), (tr, jr)):
        _close(got, want)


def test_mla_decode_matches_reference(mla_setup):
    """Absorbed decode with a different position per row, written in place."""
    cfg, jp, tp, rng = mla_setup
    m = cfg.mla
    b, cap = 3, 40
    x = rng.standard_normal((b, 1, cfg.d_model))
    ckv = rng.standard_normal((b, cap, m.kv_lora_rank))
    krope = rng.standard_normal((b, cap, m.qk_rope_head_dim))
    pos = np.array([0, 17, 39], np.int32)
    jout, (jc, jr) = jax_mla.mla_decode(
        jp, m, jnp.asarray(x, jnp.float32), jnp.asarray(ckv, jnp.float32),
        jnp.asarray(krope, jnp.float32), jnp.asarray(pos), theta=cfg.rope_theta)
    tc, tr = _t(ckv), _t(krope)
    tout, _ = mla.mla_decode(tp, m, _t(x), tc, tr, torch.from_numpy(pos),
                             theta=cfg.rope_theta)
    for got, want in ((tout, jout), (tc, jc), (tr, jr)):
        _close(got, want)


# ---------------------------------------------------------------------------
# reduced deepseek-v2-236b through params_from_jax
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config(ARCH))
    jm = JaxLM(jax_reduced(jax_get_config(ARCH)))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return cfg, jm, tree, LM(cfg, device="cpu"), params_from_jax(cfg, tree, "cpu")


def test_param_layout_matches_reference(models):
    cfg, _, tree, tm, params = models
    assert [spec.mixer + "/" + spec.mlp for period, _ in tm.segments for spec in period] \
        == ["mla/dense", "mla/moe"]
    jax_shapes = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
                  tuple(np.shape(x))
                  for path, x in jax.tree_util.tree_leaves_with_path(tree)}
    mine = tm.init(torch.Generator().manual_seed(0))
    shapes = {}
    tree_map_with_path(lambda path, x: shapes.update({path: tuple(x.shape)}), mine)
    assert shapes == jax_shapes
    assert len(tree_leaves(params)) == len(jax_shapes)


def _leaves_close(port_caches, jax_caches, upto):
    pl, jl = tree_leaves(port_caches), jax.tree.leaves(jax_caches)
    assert len(pl) == len(jl) == 4                       # c_kv, k_rope per segment
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p.numpy()[:, :, :upto], np.asarray(j)[:, :, :upto],
                                   rtol=1e-4, atol=1e-4)


def test_prefill_extend_many_decode_match_reference(models):
    """Prefill, a two-chunk ``prefill_extend_many`` and four decode steps:
    logits within ``LOGIT_ATOL``, caches close, and the greedy tokens of the
    decode steps equal."""
    cfg, jm, tree, tm, params = models
    rng = np.random.default_rng(0)
    s, chunk, cap, n_dec = 40, 16, 96, 4
    toks = rng.integers(0, cfg.vocab_size, (1, s + 2 * chunk)).astype(np.int32)
    worst = 0.0
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])})
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    _leaves_close(tc, jc, s)

    jc, tc = jax_kv.pad_cache_to(jc, cap), kv_cache.pad_cache_to(tc, cap)
    slots = toks[:, s:].reshape(1, 2, chunk)
    jl, jc, _ = jax.jit(jm.prefill_extend_many)(tree, jc, jnp.asarray(slots),
                                                jnp.int32(s), jnp.int32(2))
    with torch.no_grad():
        tl, tc, states = tm.prefill_extend_many(params, tc, torch.from_numpy(slots),
                                                torch.tensor(s, dtype=torch.int32), 2)
    worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    _leaves_close(tc, jc, s + 2 * chunk)
    assert all(x.numel() == 0 for x in tree_leaves(states))   # no state leaves

    jdec = jax.jit(jm.decode_step)
    jtok = int(np.argmax(np.asarray(jl)[0]))
    ttok = int(torch.argmax(tl[0]))
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
        _leaves_close(tc, jc, p + 1)
    assert worst < LOGIT_ATOL, worst


def test_grouped_moe_model_matches_reference(models):
    """Reduced ``deepseek-v2-236b`` with ``moe_groups=2`` (the same
    parameters: groups change the routing, not the layout): a two-row
    prefill and four two-row greedy decode steps, every row's tokens split
    into two routing groups; logits within ``LOGIT_ATOL`` of ``repro``'s and
    the greedy tokens equal."""
    cfg, _, tree, _, params = models
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), moe_groups=2)
    gcfg = dataclasses.replace(cfg, moe_groups=2)
    jm, tm = JaxLM(jcfg), LM(gcfg, device="cpu")
    rng = np.random.default_rng(5)
    s, cap, n_dec = 40, 64, 4
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(tree, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks)})
    worst = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    jc, tc = jax_kv.pad_cache_to(jc, cap), kv_cache.pad_cache_to(tc, cap)
    jdec = jax.jit(jm.decode_step)
    jtok = np.argmax(np.asarray(jl), -1)
    ttok = torch.argmax(tl, -1)
    assert ttok.tolist() == jtok.tolist()
    for i in range(n_dec):
        pos = np.full(2, s + i, np.int32)
        jl, jc = jdec(tree, jc, jnp.asarray(jtok[:, None], jnp.int32), jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm.decode_step(params, tc, ttok[:, None], torch.from_numpy(pos))
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        jtok, ttok = np.argmax(np.asarray(jl), -1).reshape(-1), torch.argmax(tl, -1).reshape(-1)
        assert ttok.tolist() == jtok.tolist(), i
    assert worst < LOGIT_ATOL, worst
