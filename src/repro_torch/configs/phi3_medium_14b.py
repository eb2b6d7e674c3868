"""Phi-3-medium 14B — dense, RoPE+SwiGLU+GQA [arXiv:2404.14219; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    activation="swiglu",
)
