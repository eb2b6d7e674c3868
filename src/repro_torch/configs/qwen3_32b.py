"""Qwen3-32B — dense, GQA + qk-norm [hf:Qwen/Qwen3-8B scaled per assignment; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
)
