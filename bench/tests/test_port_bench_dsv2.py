"""The DeepSeek-V2 cell (``dsv2-docqa-8k``): its configuration file's widths
and cut, its driver's model FLOPs, the per-layer readings of its spans, and
its fp8 control on a small CPU run."""
import time

import pytest
import torch

from bench import core

MAN = core.manifest()
CFG = core.config(MAN, "deepseek-v2-l30-ep8")
DRV = core.driver("serve_sessions_mla_moe")


def test_the_config_file_is_the_published_model_cut_in_depth_and_experts():
    widths = {"hidden_size": 5120, "num_attention_heads": 128, "num_key_value_heads": 128,
              "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
              "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 12288,
              "moe_intermediate_size": 1536, "n_shared_experts": 2, "num_experts_per_tok": 6,
              "n_group": 8, "topk_group": 3, "routed_scaling_factor": 16,
              "norm_topk_prob": False, "topk_method": "group_limited_greedy",
              "first_k_dense_replace": 1, "vocab_size": 102400, "rope_theta": 10000,
              "rms_norm_eps": 1e-06, "tie_word_embeddings": False}
    assert {k: CFG[k] for k in widths} == widths
    assert CFG["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                   "mscale": 0.707, "mscale_all_dim": 0.707,
                                   "original_max_position_embeddings": 4096, "type": "yarn"}
    assert CFG["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert CFG["published"] == {"num_hidden_layers": 60, "n_routed_experts": 160}
    assert (CFG["num_hidden_layers"], CFG["n_routed_experts"], CFG["experts_held_from"]) == \
        (30, 20, 0)
    # one of the 8 routing groups: the held experts are a whole group
    per_group = CFG["published"]["n_routed_experts"] // CFG["n_group"]
    assert CFG["n_routed_experts"] == per_group and CFG["experts_held_from"] % per_group == 0
    entry = next(c for c in MAN["configs"] if c["name"] == "deepseek-v2-l30-ep8")
    assert entry["source"] == "https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json"


def test_the_port_config_and_its_parameters():
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import param_specs

    cfg = DRV.arch_config(CFG)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.experts_held, m.capacity_factor) == (160, 6, (0, 20), None)
    assert (cfg.n_layers, cfg.d_model, cfg.mla.kv_lora_rank, cfg.rope_scaling.factor) == \
        (30, 5120, 512, 40.0)
    specs = param_specs(cfg)
    n = sum(int(torch.tensor(s.shape).prod()) for s in tree_leaves(specs))
    assert n / 1e9 == pytest.approx(20.79, abs=0.005)
    moe = specs["segments"][1]["p0"]["mlp"]
    assert moe["router"].shape == (29, 5120, 160)
    assert moe["experts"]["w_gate"].shape == (29, 20, 5120, 1536)


def test_model_flops_of_a_token():
    a = DRV.arch(CFG)
    w = DRV.layer_weights(a)
    assert w["mla"] == 5120 * 1536 + 1536 * 128 * 192 + 5120 * 576 + 512 * 128 * 256 \
        + 128 * 128 * 5120
    # the held share of the routed experts: top 6 over 160, 20 held
    moe = 2 * (5120 * 160 + 3 * 5120 * 1536 * 2 + 0.75 * 3 * 5120 * 1536)
    head = 2 * 5120 * 102400
    one = DRV.span_flops(a, 30, 1, start=100, n=1)
    attn = 2 * 128 * (192 + 128) * 101
    assert one == pytest.approx(30 * (2 * w["mla"] + attn) + 2 * 3 * 5120 * 12288
                                + 29 * moe + head)
    # a span is its tokens one by one, with the head once
    many = DRV.span_flops(a, 30, 1, start=100, n=3)
    each = sum(DRV.span_flops(a, 30, 1, start=100 + i, n=1) for i in range(3))
    assert many == pytest.approx(each - 2 * head)


def test_span_readings():
    mla = core.metric_reader("mla_expand_ms.serve")
    moe = core.metric_reader("moe_ms.serve")
    rec = {"summary": {"device_by_program_span": {"serve.mla_expand": 0.3, "serve.moe": 0.12}},
           "spans": {"serve.extend": {"count": 60, "s": 2.0}}}
    assert mla(rec) == pytest.approx(5.0) and moe(rec) == pytest.approx(2.0)
    # a program without the spans (or no extend in the window) reads nothing
    assert mla({"summary": {"device_by_program_span": {}}, "spans": {}}) is None
    assert moe({"summary": {}, "spans": {"serve.extend": {"count": 3}}}) is None


def small_config() -> dict:
    """The configuration at widths a CPU runs in a second, with weights
    large enough that bf16 and fp8 part: logits of a few units."""
    cfg = dict(CFG)
    cfg.update(hidden_size=256, num_attention_heads=4, q_lora_rank=32, kv_lora_rank=16,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3, vocab_size=512,
               n_routed_experts=4, experts_held_from=0)
    cfg["published"] = dict(cfg["published"], n_routed_experts=32)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], original_max_position_embeddings=32)
    cfg["assumed"] = dict(cfg["assumed"], init_std=0.4)
    cfg["serving"] = dict(cfg["serving"], chunk_tokens=32, decode_bucket=32, byte_budget=8 << 20)
    return cfg


def test_fp8_control_fails_the_cells_limit_on_a_small_run():
    tr = dict(core.traffic("docqa-8k"), doc_tokens=256, prefix=[64, 256], new_tokens=[4, 8],
              warmup_s=0.3, check_requests=6)
    rec = DRV.run(config=small_config(), traffic=tr, limits=core.limits("dsv2-docqa-8k"),
                  seed=2**31 + 17, seconds=1.0, trace=False, device="cpu",
                  t_start=time.perf_counter(), judge=DRV.control_judge)
    c = rec["check"]
    assert c["served_tokens"] > 0
    assert c["control"]["mean_logit_gap"] > c["numbers"]["mean_logit_gap"]["value"]
    assert c["control_fails"]
