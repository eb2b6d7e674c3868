"""Whisper-large-v3 — enc-dec audio transformer [arXiv:2212.04356; unverified].

Backbone only per the assignment: the conv frontend is a stub —
``input_specs()`` provides precomputed (B, 1500, d_model) frame embeddings.
Positional encoding uses RoPE in place of Whisper's sinusoidal/learned
embeddings (recorded in DESIGN.md; backbone compute is unchanged).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,          # plain MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    encoder_layers=32,
    encoder_context=1500,
)
