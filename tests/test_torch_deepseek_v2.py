"""DeepSeek-V2 as the benchmark serves it, against the plain fp32 reference
``bench/reference/deepseek_v2.py``, at a small size on the CPU.

The model is the port's ``LM`` built by the benchmark's driver
(``bench/drivers/serve_sessions_mla_moe.py::arch_config``) from the
benchmark's configuration file with its widths cut to a few dozen: MLA
with YaRN (``original_max_position_embeddings`` cut to 32, so the ramp
between the two corrections falls inside a rope of width 8), a dense first
layer, then MoE layers under the published router (16 routed experts in 8
groups, top 3 groups, top 4, gates the softmax scores × 16), dropless,
holding 4 of the 16, plus 2 shared experts.  Weights come from the driver's
``draw_weights`` and run in fp32 on both sides.

Both sides compute in fp32 from the same weights; they differ in the order
of their reductions (blocked online softmax, absorbed decode, the combine's
order) and in the rope's angles (fp32 against the reference's fp64), so
logits are held to ``LOGIT_ATOL``: about a hundred fp32 ulps of logits of
magnitude ≈2.5 (measured: at most 1.7e-6 over prefill, extend and decode),
where a routing decision or a YaRN constant gone wrong moves them by more
than 1e-2.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import core  # noqa: E402
from bench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch.configs.base import MoEConfig, RopeScaling  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import (rope_angles, yarn_inv_freq, yarn_mscale,  # noqa: E402
                                       yarn_rope_gain, yarn_softmax_gain)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.kv_cache import pad_cache_to  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402

DRIVER = core.driver("serve_sessions_mla_moe")
#: fp32 logits, port against reference (see the module docstring)
LOGIT_ATOL = 2e-5
#: one MoE layer's outputs, summed in another order (8 shares against one)
LAYER_ATOL = 1e-5


def tiny_config(**kw) -> dict:
    cfg = core.config(core.manifest(), "deepseek-v2-l30-ep8")
    cfg.update(hidden_size=64, num_attention_heads=4, q_lora_rank=32, kv_lora_rank=16,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3, vocab_size=512,
               num_experts_per_tok=4, n_routed_experts=4, experts_held_from=0)
    cfg["published"] = dict(cfg["published"], n_routed_experts=16)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], original_max_position_embeddings=32)
    cfg["assumed"] = dict(cfg["assumed"], init_std=0.08)
    cfg["serving"] = dict(cfg["serving"], chunk_tokens=16, decode_bucket=16,
                          byte_budget=8 << 20)
    cfg.update(kw)
    return cfg


def fp32_model(cfg: dict, seed: int = 5):
    """The port's model and weights in fp32 (weights drawn in bf16, as the
    cell draws them) and the reference's view of the same weights."""
    arch = dataclasses.replace(DRIVER.arch_config(cfg), param_dtype="float32",
                               compute_dtype="float32")
    w = DRIVER.draw_weights(cfg, seed, "cpu")
    w32 = torch.utils._pytree.tree_map(lambda x: x.float(), w)
    return LM(arch, device="cpu"), w, w32


def tokens(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

PUBLISHED_YARN = RopeScaling(factor=40.0, original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707)


def test_yarn_frequencies_and_mscale_match_the_closed_form():
    dim, theta = 64, 10000.0
    # the correction range of the published constants: dims [0, 10) keep
    # their frequency, dims past 23 are divided by the factor
    low = math.floor(dim * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(theta)))
    high = math.ceil(dim * math.log(4096 / (1 * 2 * math.pi)) / (2 * math.log(theta)))
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        f = theta ** (-2.0 * i / dim)
        r = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(f / 40.0 * r + f * (1.0 - r))
    got = yarn_inv_freq(dim, theta, PUBLISHED_YARN).double()
    # fp32 against fp64: a few ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert yarn_mscale(40.0, 0.707) == pytest.approx(1 + 0.0707 * math.log(40.0), rel=1e-12)
    assert yarn_softmax_gain(PUBLISHED_YARN) == pytest.approx((1 + 0.0707 * math.log(40.0)) ** 2,
                                                              rel=1e-12)
    assert round(yarn_softmax_gain(PUBLISHED_YARN), 4) == 1.5896
    assert yarn_rope_gain(PUBLISHED_YARN) == 1.0
    assert yarn_softmax_gain(None) == 1.0
    pos = torch.tensor([0, 1, 4095, 8191])
    cos, sin = rope_angles(pos, dim, theta, PUBLISHED_YARN)
    ang = pos.double()[:, None] * torch.tensor(want, dtype=torch.float64)
    # fp32 angles at position 8191: |ang| · 2⁻²³ ≈ 1e-3 for the fastest dim
    np.testing.assert_allclose(cos.numpy(), torch.cos(ang).numpy(), atol=2e-3)
    np.testing.assert_allclose(sin.numpy(), torch.sin(ang).numpy(), atol=2e-3)
    # and the reference's (fp64) frequencies are the same closed form
    inv, gain = ref.yarn_freqs(dim, theta, {"factor": 40, "original_max_position_embeddings": 4096,
                                            "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                                            "mscale_all_dim": 0.707})
    np.testing.assert_allclose(inv.numpy(), want, rtol=1e-12)
    assert gain == 1.0


def test_yarn_is_off_by_default():
    pos = torch.arange(5)
    c0, s0 = rope_angles(pos, 8, 10000.0)
    c1, s1 = rope_angles(pos, 8, 10000.0, None)
    assert torch.equal(c0, c1) and torch.equal(s0, s1)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

GROUPED = MoEConfig(n_experts=8, top_k=3, d_ff_expert=4, topk_method="group_limited_greedy",
                    n_group=4, topk_group=2, norm_topk_prob=False, routed_scaling_factor=16.0)


def test_group_limited_router_by_hand():
    # groups of two: maxima 0.30, 0.22, 0.21, 0.16, so groups 0 and 1 stay;
    # their experts 0..3 score 0.05, 0.30, 0.02, 0.22: the top 3 are 1, 3, 0
    # (a plain top-3 would take expert 4 at 0.21 before expert 0)
    probs = torch.tensor([[0.05, 0.30, 0.02, 0.22, 0.21, 0.01, 0.16, 0.03]])
    gates, ids = moe.select_experts(GROUPED, probs)
    assert ids.tolist() == [[1, 3, 0]]
    # unnormalised: the softmax scores times the routed scaling factor
    assert torch.allclose(gates, torch.tensor([[0.30, 0.22, 0.05]]) * 16.0)
    plain = dataclasses.replace(GROUPED, topk_method="greedy")
    assert moe.select_experts(plain, probs)[1].tolist() == [[1, 3, 4]]
    normed = dataclasses.replace(GROUPED, norm_topk_prob=True)
    g, _ = moe.select_experts(normed, probs)
    assert torch.allclose(g, torch.tensor([[0.30, 0.22, 0.05]]) / 0.57)
    # the reference's router picks the same experts with the same gates
    a = {"n_group": 4, "topk_group": 2, "top_k": 3, "scale": 16.0, "norm_topk": False,
         "topk_method": "group_limited_greedy"}
    r_ids, r_gates = ref.route(torch.log(probs), torch.eye(8), a)   # softmax(log p) = p
    assert r_ids.tolist() == [[1, 3, 0]]
    assert torch.allclose(r_gates, gates)


def test_group_limited_router_ties_go_to_the_lower_index():
    probs = torch.tensor([
        # groups 1 and 2 tie at 0.2 for second place: group 1 stays, so
        # expert 5 (0.2) is out and experts 2 and 3 are in
        [0.05, 0.30, 0.20, 0.10, 0.15, 0.20, 0.00, 0.00],
        # experts 0 and 2 tie at 0.1 inside the kept groups: 0 comes first
        [0.10, 0.30, 0.10, 0.05, 0.00, 0.00, 0.02, 0.01]])
    _, ids = moe.select_experts(GROUPED, probs)
    assert ids.tolist() == [[1, 2, 3], [1, 0, 2]]


# ---------------------------------------------------------------------------
# dropless experts and the held share
# ---------------------------------------------------------------------------

def _moe_params(e: int, d: int, ff: int, seed: int, shared: bool = True):
    g = torch.Generator().manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, generator=g) * 0.2

    ex = moe.ExpertParams(n(e, d, ff), n(e, d, ff), n(e, ff, d))
    sh = (n(d, 2 * ff), n(d, 2 * ff), n(2 * ff, d)) if shared else None
    return moe.MoEParams(n(d, 16), ex, sh)


def test_dropless_keeps_every_assignment():
    d, n = 32, 64
    cfg = dataclasses.replace(GROUPED, n_experts=16, n_group=8, topk_group=3, top_k=4,
                              d_ff_expert=8, capacity_factor=None)
    p = _moe_params(16, d, 8, seed=1)
    x = torch.randn(1, n, d, generator=torch.Generator().manual_seed(2))
    # every token's best expert is expert 5: its router column follows the
    # tokens' common direction
    x = x * 0.1 + torch.ones(d)
    router = p.router.clone()
    router[:, 5] = 10.0
    p = p._replace(router=router)
    r = moe.route(cfg, router, x[0])
    assert r.capacity == n and bool(r.keep.all())
    assert int((r.sorted_expert == 5).sum()) == n
    # GShard's capacity would drop most of expert 5's assignments
    drops = moe.route(dataclasses.replace(cfg, capacity_factor=1.25), router, x[0])
    assert drops.capacity < n and not bool(drops.keep.all())
    got, _ = moe.moe_ffn(p, cfg, x)
    a = {"n_group": 8, "topk_group": 3, "top_k": 4, "scale": 16.0, "norm_topk": False,
         "topk_method": "group_limited_greedy", "held": (0, 16)}
    w = {"router": router, "experts": list(zip(*p.experts)), "shared": p.shared}
    want = ref._moe(x[0], w, a, "none")
    torch.testing.assert_close(got[0], want, atol=LAYER_ATOL, rtol=1e-5)


def test_held_shares_sum_to_the_uncut_layer():
    d, n, shares = 32, 24, 8
    cfg = dataclasses.replace(GROUPED, n_experts=16, n_group=8, topk_group=3, top_k=4,
                              d_ff_expert=8, capacity_factor=None, n_shared=2, d_ff_shared=4)
    p = _moe_params(16, d, 8, seed=3)
    x = torch.randn(2, n // 2, d, generator=torch.Generator().manual_seed(4))
    whole, _ = moe.moe_ffn(p, cfg, x)
    per = 16 // shares
    parts = []
    for s in range(shares):
        held = dataclasses.replace(cfg, experts_held=(s * per, per))
        ex = moe.ExpertParams(*(w[s * per:(s + 1) * per] for w in p.experts))
        parts.append(moe.moe_ffn(moe.MoEParams(p.router, ex, None), held, x)[0])
    shared_only = moe._shared_ffn(p.shared, x.reshape(n, d), "swiglu").reshape(x.shape)
    # the routed parts of the eight shares, and the shared experts once
    torch.testing.assert_close(sum(parts) + shared_only, whole, atol=LAYER_ATOL, rtol=1e-5)
    # a share computes nothing for the experts it does not hold
    ex = moe.ExpertParams(*(w[:per] for w in p.experts))
    with pytest.raises(ValueError, match="experts_held"):
        moe.moe_ffn(moe.MoEParams(p.router, ex, None),
                    dataclasses.replace(cfg, experts_held=(0, per + 1)), x)


def test_defaults_keep_the_generic_router_bitwise():
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=4)
    probs = torch.softmax(torch.randn(5, 8, generator=torch.Generator().manual_seed(6)), -1)
    gates, ids = moe.select_experts(cfg, probs)
    vals, want_ids = moe.top_k_lower_index(probs, 2)
    assert torch.equal(ids, want_ids)
    assert torch.equal(gates, vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = tiny_config()
    model, w, w32 = fp32_model(cfg)
    return cfg, ref.arch(cfg), model, w, w32


def test_config_is_the_published_router_on_a_held_share(small):
    cfg, a, model, w, _ = small
    m = model.cfg.moe
    assert (m.topk_method, m.n_group, m.topk_group, m.norm_topk_prob,
            m.routed_scaling_factor, m.capacity_factor, m.experts_held) == \
        ("group_limited_greedy", 8, 3, False, 16.0, None, (0, 4))
    assert model.cfg.rope_scaling.factor == 40.0
    moe_layer = w["segments"][1]["p0"]["mlp"]
    assert tuple(moe_layer["router"].shape) == (2, 64, 16)
    assert tuple(moe_layer["experts"]["w_gate"].shape) == (2, 4, 64, 32)


def test_prefill_matches_the_reference(small):
    cfg, a, model, w, w32 = small
    toks = tokens(40)
    with torch.no_grad():
        logits, _ = model.prefill(w32, {"tokens": torch.as_tensor(toks[None]).long()})
    want = ref.logits_at(w, a, [toks.tolist()], [[39]], device="cpu")[0]
    torch.testing.assert_close(logits, want, atol=LOGIT_ATOL, rtol=0)


def test_absorbed_decode_matches_the_reference(small):
    cfg, a, model, w, w32 = small
    toks = tokens(46, seed=1)
    with torch.no_grad():
        _, caches = model.prefill(w32, {"tokens": torch.as_tensor(toks[None, :40]).long()})
        caches = pad_cache_to(caches, 48)
        got = []
        for p in range(40, 46):
            lg, caches = model.decode_step(w32, caches, torch.as_tensor(toks[None, p:p + 1]).long(),
                                           torch.tensor([p], dtype=torch.int32))
            got.append(lg[0])
    want = ref.logits_at(w, a, [toks.tolist()], [list(range(40, 46))], device="cpu")[0]
    torch.testing.assert_close(torch.stack(got), want, atol=LOGIT_ATOL, rtol=0)


def test_extend_through_a_stored_segment_matches_the_reference(small):
    cfg, a, model, w, w32 = small
    doc = tokens(80, seed=2)
    mgr = SessionManager(model, w32, chunk_tokens=16, byte_budget=8 << 20, decode_bucket=16,
                         max_batch=4, async_prefill=False)
    sid = mgr.add_session(doc)
    mgr.submit(sid, 64, 1)
    mgr.run()
    mgr.close_session(sid)
    # a ragged prefix past the stored chunks: reused [0, 64), extended to 75
    sid = mgr.add_session(doc)
    plan = mgr.submit(sid, 75, 5)
    assert any(s.model_id is not None for s in plan.steps)
    s = mgr.sessions[sid]
    want = ref.logits_at(w, a, [doc[:75].tolist()], [[74]], device="cpu")[0]
    torch.testing.assert_close(s.logits.float(), want, atol=LOGIT_ATOL, rtol=0)
    out = mgr.run()[sid]
    assert len(out) == 5
    # the served greedy tokens are the reference's own best
    gaps = ref.served_gaps(w, a, [(doc[:75], out)], device="cpu")[0]
    assert max(gaps) < LOGIT_ATOL
    assert mgr.aggregate_stats().tokens_reused >= 48
