"""Mamba2-130M — attention-free SSD (state-space duality) [arXiv:2405.21060;
unverified].  24 blocks, no MLP (d_ff=0), ssm_state=128."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                 # no MLP: the SSD block is the whole layer
    vocab_size=50280,
    tie_embeddings=True,    # GPT-NeoX-style tied embeddings (as published)
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_period=0,
    train_microbatches=4,
)
