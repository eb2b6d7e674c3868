"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

This registry entry is a copy of the JAX package's and keeps its generic
router for parity with it: a softmax top-6 over all 160 experts with the
gates renormalised, GShard capacity 1.25 (drops), and plain RoPE.  The
published model's router (``topk_method="group_limited_greedy"``,
``n_group`` 8, ``topk_group`` 3, ``norm_topk_prob`` false,
``routed_scaling_factor`` 16), dropless experts (``capacity_factor=None``),
one device's share of the experts (``experts_held``) and YaRN
(``ArchConfig.rope_scaling``) are selected by fields of ``MoEConfig`` and
``ArchConfig`` that default off; the benchmark's configuration
(``bench/configs/deepseek-v2-l30-ep8.json``) sets them.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,         # MLA: heads share the latent cache
    head_dim=128,
    d_ff=12288,             # dense (first) layer FF
    vocab_size=102400,
    activation="swiglu",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared=2,
        d_ff_shared=1536,
        first_dense_layers=1,
    ),
    param_dtype="bfloat16",
    optimizer="adafactor",
    train_microbatches=16,
)
