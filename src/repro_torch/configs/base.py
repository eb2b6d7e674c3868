"""Architecture + shape configuration.

Each assigned architecture gets one ``<id>.py`` next to this file with the
exact published dimensions; ``reduced()`` derives the CPU-smoke variant of
the same family.  ``SHAPES`` are the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.001
    first_dense_layers: int = 0   # leading dense layers (DeepSeek/Kimi style)
    every: int = 1                # MoE on layers where (idx % every == every-1)
    #: GShard-style drop capacity (smokes use 8+); None: dropless, every
    #: expert's bucket holds all of its group's tokens
    capacity_factor: Optional[float] = 1.25
    # -- the fields below are the port's own; their defaults are the JAX
    # package's router (a softmax top-k, gates renormalised to sum to one)
    #: "greedy": top-k over all experts; "group_limited_greedy": DeepSeek-V2's
    #: device-limited routing, the top ``topk_group`` of ``n_group`` groups
    #: (each group's score its best expert's), then the top-k inside them
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    #: renormalise the k gates to sum to one; else scale the softmax scores
    #: by ``routed_scaling_factor``
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    #: (first expert, count) of the routed experts this device holds, None
    #: for all: the layer routes over every expert and computes the part of
    #: the output its own experts give (expert parallelism without the
    #: exchange)
    experts_held: Optional[tuple[int, int]] = None


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RopeScaling:
    """YaRN rope scaling as DeepSeek-V2 publishes it (``rope_scaling`` of its
    ``config.json``, type "yarn"; arXiv:2309.00071): the rotary frequencies
    past a ramp between the ``beta_fast`` and ``beta_slow`` rotations over
    ``original_max_position_embeddings`` positions are divided by
    ``factor``; cos/sin are scaled by mscale(factor, mscale) /
    mscale(factor, mscale_all_dim), and the softmax scale by
    mscale(factor, mscale_all_dim)² (``models/common.py``)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    activation: str = "swiglu"       # swiglu | squared_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    #: YaRN (MLA stacks only; the port's own field, None as in the JAX package)
    rope_scaling: Optional[RopeScaling] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    #: hybrid: attention on layers where (idx % hybrid_period == hybrid_attn_idx)
    hybrid_period: int = 0
    hybrid_attn_idx: int = 0

    #: enc-dec (whisper): encoder layers share d_model/heads; frontend is a stub
    encoder_layers: int = 0
    encoder_context: int = 0         # #frames the stub frontend provides
    #: vlm: a cross-attn layer every `cross_attn_every` layers
    cross_attn_every: int = 0
    vision_context: int = 0          # #image-patch embeddings (stub)

    #: TP-friendly GQA: replicate the (small) KV projections and expand KV
    #: heads to align with the q-head sharding — no head-dim re-homing, no
    #: resharding collectives inside attention (see EXPERIMENTS.md §Perf)
    expand_kv: bool = False
    #: KV-block size of the online-softmax attention scan
    attn_block: int = 512
    #: expert-parallel dispatch groups (0/1 = global single-buffer dispatch);
    #: set to the mesh's data-parallel extent for the EP all-to-all path
    moe_groups: int = 1

    # numerics / memory policy
    param_dtype: str = "float32"     # bf16 for the ≥100B archs
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor
    remat: str = "full"              # none | full | dots_saveable
    # defaults; hillclimb overrides per cell
    train_microbatches: int = 8
    decode_kv_shard: str = "seq"     # seq (split-K) | heads | none
    sequence_parallel: bool = False
    logit_chunk: int = 0             # 0 = whole-sequence logits; >0 = chunked CE

    # -- derived -----------------------------------------------------------
    @property
    def is_causal(self) -> bool:
        return True

    @property
    def n_params_dense_estimate(self) -> float:
        """Rough total parameter count (embeddings + blocks), for rooflines."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        ff_mats = 3 if self.activation == "swiglu" else 2
        total = emb
        for i in range(L):
            if self.ssm is not None and not self._is_attn_layer(i):
                s = self.ssm
                di = s.d_inner(d)
                total += d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d)) + di * d
            else:
                total += attn
            if self._is_cross_layer(i):
                total += attn                      # cross-attention sublayer
            total += self._layer_ff_params(i, ff_mats)
        # encoder stack (whisper): self-attn + dense FF per layer
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ff_mats * d * self.d_ff)
        return float(total)

    def _is_cross_layer(self, idx: int) -> bool:
        if self.encoder_layers:
            return True                            # enc-dec: every decoder layer
        if self.cross_attn_every:
            return idx % self.cross_attn_every == self.cross_attn_every - 1
        return False

    def _is_attn_layer(self, idx: int) -> bool:
        if self.ssm is None:
            return True
        if self.hybrid_period == 0:
            return False  # pure SSM
        return idx % self.hybrid_period == self.hybrid_attn_idx

    def _layer_ff_params(self, idx: int, ff_mats: int) -> int:
        d = self.d_model
        if self.d_ff == 0 and self.moe is None:
            return 0
        if self.moe is None or idx < self.moe.first_dense_layers or (
            self.moe.every > 1 and idx % self.moe.every != self.moe.every - 1
        ):
            dff = self.d_ff if self.d_ff else (self.moe.d_ff_expert if self.moe else 0)
            return ff_mats * d * dff
        m = self.moe
        return ff_mats * d * (m.n_experts * m.d_ff_expert + m.n_shared * (m.d_ff_shared or m.d_ff_expert))

    @property
    def n_params_active_estimate(self) -> float:
        """Activated parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.n_params_dense_estimate
        m = self.moe
        full = self.n_params_dense_estimate
        ff_mats = 3 if self.activation == "swiglu" else 2
        d = self.d_model
        for i in range(self.n_layers):
            if i >= m.first_dense_layers and (m.every <= 1 or i % m.every == m.every - 1):
                full -= ff_mats * d * m.n_experts * m.d_ff_expert
                full += ff_mats * d * m.top_k * m.d_ff_expert
        return full

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic / O(1)-state sequence mixers)
LONG_CONTEXT_OK = {"mamba2-130m", "jamba-v0.1-52b"}


def cells_for(arch: "ArchConfig") -> list[str]:
    """The assigned shape cells this arch actually runs (skips noted in DESIGN.md)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.name in LONG_CONTEXT_OK:
        names.append("long_500k")
    return names
