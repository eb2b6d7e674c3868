"""Language-model assembly for decoder stacks of attention, MLA or SSD layers
with dense or MoE feed-forward layers.

A config compiles into **segments** ``(period, n_periods)`` exactly as in
``repro.models.lm``; parameters and serving caches keep the JAX package's
layer-stacked layout (parameter leaves ``(L, ...)``, cache leaves
``(L, B, T, KV, hd)``, MLA's latent ``(L, B, T, kv_lora)`` and
``(L, B, T, rope)``, the sequence at axis 2; SSD's running state ``conv``
``(L, B, W−1, C)`` and ``ssm`` ``(L, B, h, p, n)``, the state at the
cache's end), so the two packages compare leaf by leaf.  Where JAX scans
over stacked layers the port loops over them in Python, indexing views of
the stacked tensors.

Serving entry points update caches **in place**: ``prefill_extend`` and
``decode_step`` write the new K/V (or latent) rows into the cache tensors
they are given, and an SSD layer computes its new state from the cache
views and then copies it over them; both return the same tree (JAX returns
new arrays).

Mixers: GQA attention (with ``repro``'s ``expand_kv`` prefill), MLA and
the Mamba-2 SSD mixer (pure SSD stacks and hybrid SSD + attention
periods); feed-forward layers: dense and routed MoE, SwiGLU or
squared-ReLU, SiLU and GELU.  Cross-attention layers (``encdec``:
whisper, every decoder layer; ``vlm``: llama-vision, one layer in five)
attend over a context made once, at the cold prefill: an encoder of
bidirectional attention layers over ``batch["enc_feats"]``, or
``vision_proj`` over ``batch["image_embeds"]`` (both frontends are
``repro``'s stubs: precomputed features).  Each cross layer caches its
context K/V as the constant leaves ``ck``/``cv`` ``(L, B, T_ctx, KV,
hd)``; extend and decode read them from the cache and never run the
context again.

Training runs :meth:`LM.loss_fn` (``repro``'s: the forward, fp32 token
cross-entropy, optionally in ``cfg.logit_chunk`` chunks, plus the MoE
router's aux loss) under ``torch.autograd``.  Its forward writes into no
tensor that autograd saves and reaches no kernel (none has a backward):
attention is the plain blocked softmax, as in ``repro``.

Activations pass through ``distributed.sharding.constrain`` where
``repro``'s do: after the embedding of the training forward, after every
layer of the training forward, the prefill and the encoder, and on the
logits.  Outside a rules context the hook returns its input.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (active, all_reduce_over, constrain, in_context,
                                              local_region, mesh_coords)

from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssd as ssd_mod
from .common import (CACHE_CONST_KEYS, CACHE_STATE_KEYS, ParamSpec, cache_leaf_key, dense,
                     rms_norm, spec_map, tree_leaves, tree_map_with_path, tree_unflatten)
from .graphs import StepGraphs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class LayerSpec:
    mixer: str           # attn | attn_bidir | mla | ssd
    mlp: str             # dense | moe | none
    cross: bool = False  # add a cross-attention sublayer


def build_segments(cfg: ArchConfig) -> list[tuple[tuple[LayerSpec, ...], int]]:
    L = cfg.n_layers
    mixer = "mla" if cfg.mla is not None else "attn"

    def mlp_kind(idx: int) -> str:
        if cfg.d_ff == 0 and cfg.moe is None:
            return "none"
        if cfg.moe is None:
            return "dense"
        m = cfg.moe
        if idx < m.first_dense_layers:
            return "dense"
        if m.every > 1 and idx % m.every != m.every - 1:
            return "dense"
        return "moe"

    if cfg.family == "ssm":
        return [((LayerSpec("ssd", "none"),), L)]
    if cfg.family == "hybrid":
        P = cfg.hybrid_period
        period = tuple(
            LayerSpec("attn" if i == cfg.hybrid_attn_idx else "ssd", mlp_kind(i))
            for i in range(P)
        )
        assert L % P == 0
        return [(period, L // P)]
    if cfg.family == "vlm":
        E = cfg.cross_attn_every
        period = tuple(
            LayerSpec("attn", "dense", cross=(i == E - 1)) for i in range(E)
        )
        assert L % E == 0
        return [(period, L // E)]
    if cfg.family == "encdec":
        return [((LayerSpec("attn", "dense", cross=True),), L)]
    # dense / moe decoders, with optional leading dense layers
    segs: list[tuple[tuple[LayerSpec, ...], int]] = []
    kinds = [mlp_kind(i) for i in range(L)]
    i = 0
    while i < L:
        j = i
        while j < L and kinds[j] == kinds[i]:
            j += 1
        segs.append(((LayerSpec(mixer, kinds[i]),), j - i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d), ("heads", None, "embed"), scale=cfg.n_layers ** -0.5),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), "ones")
        s["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return s


def _dense_mlp_specs(cfg: ArchConfig, d_ff: int) -> dict:
    d = cfg.d_model
    s = {
        "w_up": ParamSpec((d, d_ff), ("embed", "ff")),
        "w_down": ParamSpec((d_ff, d), ("ff", "embed"), scale=cfg.n_layers ** -0.5),
    }
    if cfg.activation == "swiglu":
        s["w_gate"] = ParamSpec((d, d_ff), ("embed", "ff"))
    return s


def _mla_specs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), ("embed", None)),
        "q_norm": ParamSpec((m.q_lora_rank,), (None,), "ones"),
        "w_uq": ParamSpec((m.q_lora_rank, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
                          (None, "heads", None)),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), "ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim), (None, "heads", None)),
        "w_uv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim), (None, "heads", None)),
        "w_o": ParamSpec((H, m.v_head_dim, d), ("heads", None, "embed"),
                         scale=cfg.n_layers ** -0.5),
    }


def _ssd_specs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_ch = d_in + 2 * gn
    return {
        "w_in": ParamSpec((d, 2 * d_in + 2 * gn + h), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, conv_ch), (None, "ssm_inner")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), "zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), "ones"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), "zeros"),
        "out_norm": ParamSpec((d_in,), ("ssm_inner",), "ones"),
        "w_out": ParamSpec((d_in, d), ("ssm_inner", "embed"), scale=cfg.n_layers ** -0.5),
    }


def _moe_specs(cfg: ArchConfig) -> dict:
    """The router over every expert; the expert leaves hold the config's
    ``experts_held`` share (all of them by default)."""
    m = cfg.moe
    d = cfg.d_model
    e = m.n_experts if m.experts_held is None else m.experts_held[1]
    s = {
        "router": ParamSpec((d, m.n_experts), ("embed", None)),
        "experts": {
            "w_gate": ParamSpec((e, d, m.d_ff_expert), ("experts", "embed", "ff")),
            "w_up": ParamSpec((e, d, m.d_ff_expert), ("experts", "embed", "ff")),
            "w_down": ParamSpec((e, m.d_ff_expert, d), ("experts", "ff", "embed"),
                                scale=cfg.n_layers ** -0.5),
        },
    }
    if m.n_shared:
        s["shared"] = _dense_mlp_specs(cfg, (m.d_ff_shared or m.d_ff_expert) * m.n_shared)
    return s


def _layer_specs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    mixer = {"attn": _attn_specs, "attn_bidir": _attn_specs, "mla": _mla_specs,
             "ssd": _ssd_specs}[spec.mixer]
    out: dict = {"ln1": ParamSpec((d,), ("embed",), "ones"), "mixer": mixer(cfg)}
    if spec.cross:
        out["cross_ln"] = ParamSpec((d,), ("embed",), "ones")
        out["cross"] = _attn_specs(cfg)
    if spec.mlp != "none":
        out["ln2"] = ParamSpec((d,), ("embed",), "ones")
        out["mlp"] = _moe_specs(cfg) if spec.mlp == "moe" else _dense_mlp_specs(cfg, cfg.d_ff)
    return out


def _stack_specs(tree, n: int):
    """Every leaf stacked over ``n`` layers: a leading ``"layers"`` axis."""
    return spec_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale), tree)


#: the encoder's layer (whisper): bidirectional self-attention, dense MLP
ENCODER_LAYER = LayerSpec("attn_bidir", "dense")


def param_specs(cfg: ArchConfig) -> dict:
    """Spec tree of the config's stack (JAX key names and logical axes)."""
    d = cfg.d_model
    specs: dict = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
        "segments": [
            _stack_specs({f"p{j}": _layer_specs(cfg, ls)
                          for j, ls in enumerate(period)}, n)
            for period, n in build_segments(cfg)
        ],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.encoder_layers:
        specs["encoder"] = {
            "layers": _stack_specs({"p0": _layer_specs(cfg, ENCODER_LAYER)},
                                   cfg.encoder_layers),
            "final_norm": ParamSpec((d,), ("embed",), "ones"),
        }
    if cfg.vision_context:
        specs["vision_proj"] = ParamSpec((d, d), ("embed", None))
    return specs


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> dict:
    """The JAX package's parameter tree as the port's parameters.

    ``tree`` is nested dicts and lists of numpy arrays with JAX's key names
    (e.g. ``jax.tree.map(np.asarray, repro.models.lm.LM(cfg).init(key))``).
    Every leaf is checked against :func:`param_specs` and placed on
    ``device`` in the config's ``param_dtype``.
    """
    dtype = DTYPES[cfg.param_dtype]

    def conv(path, spec, x):
        x = np.array(x, np.float32)           # a writable host copy
        if tuple(x.shape) != spec.shape:
            raise ValueError(f"param {'/'.join(map(str, path))}: shape "
                             f"{tuple(x.shape)}, expected {spec.shape}")
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    return tree_map_with_path(conv, param_specs(cfg), tree)


def _layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters as views into the stacked leaves."""
    return tree_map_with_path(lambda _, x: x[i], stacked)


def _unstack(stacked: dict) -> list:
    """Every layer's parameters as views into the stacked leaves, from one
    ``unbind`` per leaf: its backward stacks the layers' gradients into one
    tensor, where indexing each layer adds a leaf-sized tensor per layer."""
    parts = [x.unbind(0) for x in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [p[i] for p in parts])
            for i in range(len(parts[0]))]


#: ops whose outputs ``remat="dots_saveable"`` keeps: products without batch
#: dimensions (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _attn_params(p: dict) -> attn.AttnParams:
    return attn.AttnParams(p["wq"], p["wk"], p["wv"], p["wo"],
                           p.get("q_norm"), p.get("k_norm"))


def _mla_params(p: dict) -> mla_mod.MLAParams:
    return mla_mod.MLAParams(p["w_dq"], p["q_norm"], p["w_uq"], p["w_dkv"],
                             p["kv_norm"], p["w_uk"], p["w_uv"], p["w_o"])


def _ssd_params(p: dict) -> ssd_mod.SSDParams:
    return ssd_mod.SSDParams(p["w_in"], p["conv_w"], p["conv_b"], p["a_log"],
                             p["d_skip"], p["dt_bias"], p["out_norm"], p["w_out"])


def _moe_params(p: dict) -> moe_mod.MoEParams:
    shared = None
    if "shared" in p:
        sh = p["shared"]
        shared = (sh["w_gate"], sh["w_up"], sh["w_down"])
    e = p["experts"]
    return moe_mod.MoEParams(
        p["router"], moe_mod.ExpertParams(e["w_gate"], e["w_up"], e["w_down"]), shared)


#: the cache leaves of each mixer, in the order its entry points return them
CACHE_LEAVES = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope"), "ssd": ("conv", "ssm")}


def _cache_names(spec: LayerSpec) -> list:
    """A layer's cache leaves in the order ``jax.tree_util`` flattens them
    (sorted keys): a cross layer's ``ck``/``cv`` come before ``k``/``v``,
    so snapshots and wire frames list the leaves as ``repro``'s do."""
    return sorted(CACHE_LEAVES[spec.mixer] + (CACHE_CONST_KEYS if spec.cross else ()))


class LM:
    """Decoder LM for one ArchConfig of attention, MLA or SSD layers with
    dense or MoE feed-forward layers, plus the encoder or vision context of
    its cross-attention layers.

    ``device`` is where :meth:`init` allocates by default; every forward
    entry point runs on the device of the tokens it is given.
    """

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.rope_scaling is not None and cfg.mla is None:
            raise ValueError("rope_scaling (YaRN) is implemented for MLA stacks only")
        self.cfg = cfg
        self.specs = param_specs(cfg)
        self.segments = build_segments(cfg)
        self.device = torch.device(device)
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.param_dtype = DTYPES[cfg.param_dtype]
        #: :meth:`decode_step`'s CUDA graphs
        self.decode_graphs = StepGraphs()

    # -- params ----------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters drawn on ``device`` in ``param_dtype`` directly
        (a full-width init never passes through host memory or fp32).
        ``generator`` must live on the same device."""
        device = self.device if device is None else torch.device(device)
        dtype = self.param_dtype

        def make(_, s: ParamSpec):
            if s.init == "zeros":
                return torch.zeros(s.shape, dtype=dtype, device=device)
            if s.init == "ones":
                return torch.ones(s.shape, dtype=dtype, device=device)
            std = 0.02 * s.scale if s.init == "normal" else 0.006 * s.scale
            return torch.empty(s.shape, dtype=dtype, device=device).normal_(
                0.0, std, generator=generator)

        return tree_map_with_path(make, self.specs)

    # -- pieces ------------------------------------------------------------
    def _embed(self, params, tokens):
        return _embed_region(tokens, params["embed"], dtype=self.compute_dtype,
                             vocab=self.cfg.vocab_size)

    def _mlp(self, spec: LayerSpec, p, x):
        """The feed-forward sublayer: (x + its output, the router's aux
        loss, a 0-d fp32 tensor, or None for a layer without MoE)."""
        cfg = self.cfg
        if spec.mlp == "none":
            return x, None
        hn = rms_norm(x.to(self.compute_dtype), p["ln2"], cfg.norm_eps)
        aux = None
        if spec.mlp == "moe":
            y, aux = moe_mod.moe_ffn(_moe_params(p["mlp"]), cfg.moe, hn,
                                     activation=cfg.activation, groups=cfg.moe_groups)
        else:
            y = moe_mod.dense_ffn(p["mlp"], hn, cfg.activation)
        return x + y.to(x.dtype), aux

    def _self_mix(self, spec: LayerSpec, p, h, positions):
        """A layer's mixer over the whole sequence (prefill and training):
        (its output, its cache leaves in :data:`CACHE_LEAVES` order)."""
        cfg = self.cfg
        if spec.mixer == "ssd":
            return ssd_mod.ssd_block(
                _ssd_params(p["mixer"]), cfg.ssm, cfg.d_model, h,
                norm_eps=cfg.norm_eps, return_state=True)
        if spec.mixer == "mla":
            return mla_mod.mla_self_attention(
                _mla_params(p["mixer"]), cfg.mla, h, positions,
                theta=cfg.rope_theta, block=cfg.attn_block, rope_scaling=cfg.rope_scaling,
                norm_eps=cfg.norm_eps)
        return attn.self_attention(
            _attn_params(p["mixer"]), h, positions, causal=spec.mixer != "attn_bidir",
            theta=cfg.rope_theta, block=cfg.attn_block, expand_kv=cfg.expand_kv)

    def _cross(self, p, x, ctx_kv):
        """The cross-attention sublayer over context K/V ``ctx_kv``."""
        hn = rms_norm(x.to(self.compute_dtype), p["cross_ln"], self.cfg.norm_eps)
        xc = attn.cross_attention(_attn_params(p["cross"]), hn, ctx_kv)
        return x + xc.to(x.dtype)

    def _layers(self, params, caches=None):
        """Yield (segment index, period slot j, layer i, spec, layer params,
        layer cache views or None, context K/V views or None) in execution
        order; a layer's cache views are its mixer's leaves
        (:data:`CACHE_LEAVES`) in order, a cross layer's context its
        ``(ck, cv)``."""
        for s, ((period, n), seg_params) in enumerate(
                zip(self.segments, params["segments"])):
            for i in range(n):
                for j, spec in enumerate(period):
                    cache = ctx = None
                    if caches is not None:
                        c = caches[s][f"p{j}"]
                        cache = tuple(c[name][i] for name in CACHE_LEAVES[spec.mixer])
                        if spec.cross:
                            ctx = (c["ck"][i], c["cv"][i])
                    yield (s, j, i, spec, _layer_params(seg_params[f"p{j}"], i),
                           cache, ctx)

    def _context(self, params, batch, device):
        """The context the cross layers attend to, (B, T_ctx, d) on
        ``device``: the encoder over ``batch["enc_feats"]`` (bidirectional
        self-attention with RoPE over the frames, then the encoder's final
        norm), or ``vision_proj`` over ``batch["image_embeds"]``; None for
        a stack without cross layers."""
        cfg = self.cfg
        if cfg.encoder_layers:
            enc = params["encoder"]
            x = torch.as_tensor(batch["enc_feats"], device=device).to(self.compute_dtype)
            b, t = x.shape[:2]
            pos = torch.arange(t, device=device).expand(b, t)
            for p in _unstack(enc["layers"]["p0"]):
                mixed, _ = self._self_mix(ENCODER_LAYER, p,
                                          rms_norm(x, p["ln1"], cfg.norm_eps), pos)
                x, _ = self._mlp(ENCODER_LAYER, p, x + mixed.to(x.dtype))
                x = constrain(x, "batch", "seq", None)
            return rms_norm(x, enc["final_norm"], cfg.norm_eps)
        if cfg.vision_context:
            x = torch.as_tensor(batch["image_embeds"], device=device)
            return dense(x.to(self.compute_dtype), params["vision_proj"])
        return None

    def logits(self, params, hidden):
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        out = dense(hidden.to(self.compute_dtype), head.to(self.compute_dtype))
        return constrain(out, "batch", None, "vocab")

    def _final_logits(self, params, x):
        hidden = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.logits(params, hidden[:, -1:, :])[:, 0]

    # -- training -----------------------------------------------------------
    def _period(self, period, positions, ctx, x, aux, layers):
        """One period of a segment over the whole sequence (``repro``'s scan
        body): (x, aux with each MoE layer's aux added in layer order)."""
        for spec, p in zip(period, layers):
            h = rms_norm(x.to(self.compute_dtype), p["ln1"], self.cfg.norm_eps)
            mixed, _ = self._self_mix(spec, p, h, positions)
            x = x + mixed.to(x.dtype)
            if spec.cross:
                x = self._cross(p, x, attn.project_context(_attn_params(p["cross"]), ctx))
            x, a = self._mlp(spec, p, x)
            if a is not None:
                aux = aux + a
            x = constrain(x, "batch", "seq", None)
        return x, aux

    def forward(self, params, batch, *, remat=None):
        """tokens (B, S) → (final hidden states (B, S, d), MoE aux loss, a
        0-d fp32 tensor summed over the layers).

        ``remat`` (default ``cfg.remat != "none"``) runs each period under
        ``torch.utils.checkpoint``, as ``repro`` wraps its scan body in
        ``jax.checkpoint``: ``"full"`` keeps only the period's inputs,
        ``"dots_saveable"`` also the outputs of products without batch
        dimensions.  Recomputation changes no value.
        """
        cfg = self.cfg
        remat = (cfg.remat != "none") if remat is None else remat
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = constrain(self._embed(params, tokens), "batch", None, None)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        ctx = self._context(params, batch, tokens.device)
        context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                      if cfg.remat == "dots_saveable" else noop_context_fn)
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        aux = zero
        for (period, n), seg_params in zip(self.segments, params["segments"]):
            layers = [_unstack(seg_params[f"p{j}"]) for j in range(len(period))]
            # remat's recomputation runs on autograd's thread: keep the rules
            body = in_context(functools.partial(self._period, period, positions, ctx))
            seg_aux = zero
            for i in range(n):
                args = (x, seg_aux, [layers[j][i] for j in range(len(period))])
                if remat:
                    x, seg_aux = checkpoint(body, *args, use_reentrant=False,
                                            context_fn=context_fn)
                else:
                    x, seg_aux = body(*args)
            aux = aux + seg_aux
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy plus ``router_aux_weight`` × the
        MoE aux loss: (loss, {"ce", "aux"}).  With ``cfg.logit_chunk``
        dividing the sequence, the logits are made and summed one chunk at
        a time, in order, and the sum divided by the number of targets."""
        cfg = self.cfg
        hidden, aux = self.forward(params, batch)
        targets = batch["targets"]
        s, chunk = hidden.shape[1], cfg.logit_chunk
        if chunk and s % chunk == 0:
            ce = torch.zeros((), dtype=torch.float32, device=hidden.device)
            for c in range(0, s, chunk):
                ll = _token_ce(self.logits(params, hidden[:, c:c + chunk]),
                               targets[:, c:c + chunk])
                ce = ce + ll.sum()
            ce = ce / targets.numel()
        else:
            ce = _token_ce(self.logits(params, hidden), targets).mean()
        moe_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
        return ce + moe_w * aux, {"ce": ce, "aux": aux}

    # -- serving ------------------------------------------------------------
    def prefill(self, params, batch):
        """Returns (last-position logits (B,V), cache tree).  ``batch``
        holds ``tokens`` and, for a stack with cross layers, the context's
        features (``enc_feats`` or ``image_embeds``, numpy arrays or
        tensors, moved onto the tokens' device)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        ctx = self._context(params, batch, tokens.device)
        kv: dict = {}
        for seg, j, _, spec, p, _, _ in self._layers(params):
            h = rms_norm(x.to(self.compute_dtype), p["ln1"], cfg.norm_eps)
            mixed, leaves = self._self_mix(spec, p, h, positions)
            x = x + mixed.to(x.dtype)
            leaves = dict(zip(CACHE_LEAVES[spec.mixer], leaves))
            if spec.cross:
                # projected once and cached (repro projects the same
                # values a second time for the cache)
                ctx_kv = attn.project_context(_attn_params(p["cross"]), ctx)
                leaves.update(zip(CACHE_CONST_KEYS, ctx_kv))
                x = self._cross(p, x, ctx_kv)
            x, _ = self._mlp(spec, p, x)
            x = constrain(x, "batch", "seq", None)
            kv.setdefault((seg, j), []).append(leaves)
        caches = [
            {f"p{j}": {name: torch.stack([lv[name] for lv in kv[(seg, j)]])
                       for name in _cache_names(spec)}
             for j, spec in enumerate(period)}
            for seg, (period, _) in enumerate(self.segments)]
        return self._final_logits(params, x), caches

    def prefill_extend(self, params, caches, tokens, start):
        """Extend a capacity-padded cache with a block of tokens, in place.

        Given caches whose sequence axis is padded to some capacity ``cap``
        and holds valid state for [0, start), process ``tokens`` (B, nb) at
        positions [start, start+nb) — writing their KV into the caches,
        and for SSD layers resuming from the cache's (conv, ssm) state and
        writing the state at start+nb over it — and return (last-position
        logits, the same caches, now valid to start+nb).  ``start`` is an
        int or a 0-d integer tensor; it stays on the device.  ``cap`` must
        be ≥ start+nb (the caller buckets it).
        """
        cfg = self.cfg
        b, nb = tokens.shape
        start = torch.as_tensor(start, dtype=torch.int32, device=tokens.device)
        x = self._embed(params, tokens)
        positions = (start + torch.arange(nb, device=tokens.device)).expand(b, nb)
        for _, _, _, spec, p, (c0, c1), ctx_kv in self._layers(params, caches):
            h = rms_norm(x.to(self.compute_dtype), p["ln1"], cfg.norm_eps)
            if spec.mixer == "ssd":
                mixed, state = ssd_mod.ssd_block(
                    _ssd_params(p["mixer"]), cfg.ssm, cfg.d_model, h,
                    norm_eps=cfg.norm_eps, return_state=True, initial=(c0, c1))
                c0.copy_(state[0])
                c1.copy_(state[1])
            elif spec.mixer == "mla":
                mixed, _ = mla_mod.mla_extend(
                    _mla_params(p["mixer"]), cfg.mla, h, c0, c1, positions, start,
                    theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                    norm_eps=cfg.norm_eps)
            else:
                mixed, _ = attn.extend_attention_cached(
                    _attn_params(p["mixer"]), h, c0, c1, positions, start,
                    theta=cfg.rope_theta)
            x = x + mixed.to(x.dtype)
            if spec.cross:
                x = self._cross(p, x, ctx_kv)
            x, _ = self._mlp(spec, p, x)
        return self._final_logits(params, x), caches

    def prefill_extend_many(self, params, caches, tokens, start, n_chunks: int):
        """Multi-chunk extend: one call fills a whole plan gap.

        tokens (B, n_slots, chunk) is a fixed-slot chunk buffer; slots
        i < ``n_chunks`` hold real document chunks starting at
        ``start + i·chunk`` and later slots are never touched.

        Returns (logits of the last processed chunk's final position,
        caches, chunk_states) where ``chunk_states`` mirrors the cache tree
        with each running-state leaf ("conv"/"ssm") stacked to (n_slots, …)
        — the state at the end of each chunk, which per-chunk segment
        materialization needs — and empty tensors elsewhere.
        """
        b, n_slots, chunk = tokens.shape

        def snap_init(path, x):
            if cache_leaf_key(path) in CACHE_STATE_KEYS:
                return x.new_zeros((n_slots,) + tuple(x.shape))
            return x.new_zeros((0,))

        def snap_write(i, snap, caches):
            def f(path, s, x):
                if cache_leaf_key(path) in CACHE_STATE_KEYS:
                    s[i] = x
                return s
            tree_map_with_path(f, snap, caches)

        snap = tree_map_with_path(snap_init, caches)
        logits = torch.zeros((b, self.cfg.vocab_size), dtype=self.compute_dtype,
                             device=tokens.device)
        start = torch.as_tensor(start, dtype=torch.int32, device=tokens.device)
        for i in range(n_chunks):
            logits, caches = self.prefill_extend(params, caches, tokens[:, i],
                                                 start + i * chunk)
            snap_write(i, snap, caches)
        return logits, caches, snap

    def decode_step(self, params, caches, tokens, pos):
        """One token for every sequence, in place.  tokens (B,1); pos (B,)
        int32 on the tokens' device.  Attention runs the ragged
        flash-decode kernel, whose output is bit-invariant to the cache's
        padded capacity.  MLA runs its absorbed decode: on a CUDA device
        the absorbed decode kernel stops each row at its own ``pos``; the
        plain version on the CPU (``repro``'s route) reduces over the whole
        padded capacity.

        On a CUDA device, with plain tensors, no gradient and no sharding
        rules, the step runs from a CUDA graph once its parameters, caches
        and shapes recur (``models/graphs.py``); the logits returned are the
        caller's own either way."""
        if tokens.is_cuda:
            leaves = tree_leaves(params) + tree_leaves(caches)
            if StepGraphs.applies(leaves, tokens, pos):
                step = functools.partial(self._decode, params, caches)
                return self.decode_graphs.run(step, leaves, (tokens, pos)), caches
        return self._decode(params, caches, tokens, pos), caches

    def _decode(self, params, caches, tokens, pos):
        """The decode step's operations: the logits (B, V); caches in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        for _, _, _, spec, p, (c0, c1), ctx_kv in self._layers(params, caches):
            h = rms_norm(x.to(self.compute_dtype), p["ln1"], cfg.norm_eps)
            if spec.mixer == "ssd":
                mixed, state = ssd_mod.ssd_decode(
                    _ssd_params(p["mixer"]), cfg.ssm, cfg.d_model, h, (c0, c1),
                    norm_eps=cfg.norm_eps)
                c0.copy_(state[0])
                c1.copy_(state[1])
            elif spec.mixer == "mla":
                mixed, _ = mla_mod.mla_decode(
                    _mla_params(p["mixer"]), cfg.mla, h, c0, c1, pos,
                    theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                    norm_eps=cfg.norm_eps)
            else:
                mixed, _ = attn.decode_attention(
                    _attn_params(p["mixer"]), h, c0, c1, pos, theta=cfg.rope_theta)
            x = x + mixed.to(x.dtype)
            if spec.cross:
                x = self._cross(p, x, ctx_kv)
            x, _ = self._mlp(spec, p, x)
        hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, hidden)[:, 0]


def _embed_rows(tokens, table, *, dtype, vocab: int):
    return F.embedding(tokens.long(), table).to(dtype)


def _embed_sharded(tokens, table, *, dtype, vocab: int):
    """One rank's rows of the embedding over its vocabulary slice: tokens
    another rank's slice holds give zeros, and the ranks sum."""
    rules, mesh = active()
    entry = rules.rules.get("vocab")
    n = table.shape[0]
    lo = n * mesh_coords(mesh, entry)[0] if n < vocab else 0
    t = tokens.long() - lo
    mine = (t >= 0) & (t < n)
    rows = F.embedding(torch.where(mine, t, 0), table)
    return torch.where(mine[..., None], rows, 0).to(dtype)


def _embed_layout(ins):
    """Rows as the tokens; summed over the mesh dimensions that split the
    vocabulary."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Shard(0) if tp.is_shard() else Partial() if ep.is_shard() else Replicate()
                 for tp, ep in zip(ins[0], ins[1]))


_embed_region = local_region(_embed_sharded, (("batch", None), ("vocab", None)),
                             (_embed_layout,), plain=_embed_rows)


def _token_ce(logits, targets):
    """Per-token cross-entropy in fp32: logsumexp minus the target's logit.
    In a sharded program each rank scores its vocabulary slice and the
    ranks combine the maxima and sums."""
    return _ce_region(logits, targets, vocab=logits.shape[-1])


def _token_ce_plain(logits, targets, *, vocab: int):
    lg = logits.float()
    true = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - true


def _token_ce_sharded(logits, targets, *, vocab: int):
    rules, mesh = active()
    n = logits.shape[-1]
    if n == vocab:          # a rank holding the whole vocabulary scores it alone
        return _token_ce_plain(logits, targets, vocab=vocab)
    entry = rules.rules.get("vocab")
    lo = n * mesh_coords(mesh, entry)[0]
    lg = logits.float()
    m = all_reduce_over(lg.amax(-1), "max", entry)
    se = all_reduce_over(torch.exp(lg - m[..., None]).sum(-1), "sum", entry)
    t = targets.long() - lo
    mine = (t >= 0) & (t < n)
    true = torch.gather(lg, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    true = all_reduce_over(torch.where(mine, true, 0.0), "sum", entry)
    return m + torch.log(se) - true


_ce_region = local_region(_token_ce_sharded, (("batch", None, "vocab"), ("batch", None)),
                          (("batch", None),), plain=_token_ce_plain)
