"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified].

Assignment table: GQA kv=8, d_ff (expert) 2048, 61 layers.  First layer
dense (DeepSeek-V3-style), one shared expert.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,             # dense (first) layer FF
    vocab_size=163840,
    activation="swiglu",
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        d_ff_shared=2048,
        first_dense_layers=1,
    ),
    param_dtype="bfloat16",
    optimizer="adafactor",
    train_microbatches=16,
)
