"""Config registry of the PyTorch port (+ reduced smoke variants).

A copy of ``repro.configs``: every architecture the JAX package registers,
in its order.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MLAConfig, MoEConfig, RopeScaling, SSMConfig
from .deepseek_67b import CONFIG as _deepseek_67b
from .deepseek_v2_236b import CONFIG as _deepseek_v2_236b
from .jamba_v01_52b import CONFIG as _jamba
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .llama32_vision_11b import CONFIG as _llama_vision
from .mamba2_130m import CONFIG as _mamba2
from .mixtral_8x7b import CONFIG as _mixtral
from .nemotron_4_340b import CONFIG as _nemotron
from .phi3_medium_14b import CONFIG as _phi3
from .qwen3_32b import CONFIG as _qwen3
from .whisper_large_v3 import CONFIG as _whisper

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [_deepseek_67b, _phi3, _nemotron,
                                                    _qwen3, _whisper, _kimi,
                                                    _deepseek_v2_236b, _jamba,
                                                    _llama_vision, _mamba2, _mixtral]}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None


def list_archs() -> list[str]:
    return sorted(ARCHS)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU-smoke variant: same family/structure, tiny dims.

    Keeps one full structural period (hybrid interleave, cross-attn cadence,
    first-dense-layer MoE pattern) so the smoke exercises every layer kind.
    """
    kw: dict = dict(
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        optimizer="adamw",
        remat="none",
        train_microbatches=1,
        rope_theta=cfg.rope_theta,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16)
        if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
            kw.update(n_kv_heads=4)
    else:
        kw.update(n_heads=0, n_kv_heads=0, head_dim=0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16,
        )
        kw.update(n_heads=4, n_kv_heads=4)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=8,
            top_k=2,
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.n_shared else 0,
            capacity_factor=16.0,  # no drops → decode path bit-matches forward
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.hybrid_period:
        kw["n_layers"] = cfg.hybrid_period  # one full interleave period
    elif cfg.cross_attn_every:
        kw["n_layers"] = cfg.cross_attn_every
    elif cfg.moe is not None and cfg.moe.first_dense_layers:
        kw["n_layers"] = cfg.moe.first_dense_layers + 2
    else:
        kw["n_layers"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_context"] = 16
    if cfg.vision_context:
        kw["vision_context"] = 16
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


__all__ = ["ARCHS", "ArchConfig", "MLAConfig", "MoEConfig", "RopeScaling", "SSMConfig",
           "get_config", "list_archs", "reduced"]
