"""Nemotron-4-340B — dense, GQA, squared-ReLU [arXiv:2402.16819; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    param_dtype="bfloat16",
    optimizer="adafactor",
    train_microbatches=16,
)
