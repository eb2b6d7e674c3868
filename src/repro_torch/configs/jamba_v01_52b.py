"""Jamba-v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Sequence mixer implemented with the Mamba-2 SSD formulation (TPU-native
chunked matmuls) at Jamba's dims — see DESIGN.md §Arch-applicability.
Attention sits at index 4 of every 8-layer period; MoE on every 2nd layer.
"""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_period=8,
    hybrid_attn_idx=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    param_dtype="bfloat16",
    optimizer="adamw",
)
