"""Llama-3.2-Vision 11B — decoder with cross-attn image layers every 5 layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Vision frontend is a stub per the assignment: ``input_specs()`` provides
precomputed (B, 1601, d_model) patch embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    cross_attn_every=5,
    vision_context=1601,
)
