"""Mixtral-8x7B — bonus arch beyond the assigned ten [arXiv:2401.04088; hf].

Exercises the no-shared-expert, every-layer MoE path (8 experts, top-2).
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
)
