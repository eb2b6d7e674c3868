"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The counterpart of ``repro.models.mla``.  Q goes through a LoRA
bottleneck; K/V are reconstructed from a shared ``kv_lora_rank`` latent
plus a decoupled RoPE key, so the serving cache is the latent stream
``(c_kv, k_rope)`` alone.

* prefill (:func:`mla_self_attention`): K/V expanded from the latent, the
  blocked softmax over the packed [nope ‖ rope] width;
* extend (:func:`mla_extend`): the chunk's latents are written **in place**
  at ``start``, K/V are expanded from the whole padded latent, and the
  queries attend through the extend kernel in its MLA form
  (``kernels/extend_attention/ops.py::extend_attention_mla``);
* decode (:func:`mla_decode`): the **absorbed** formulation: query
  projections fold through ``w_uk`` / ``w_uv`` so attention runs in latent
  space; the latent is written in place at each row's ``pos``, and the
  scores, softmax, probabilities times latents and the product with
  ``w_uv`` go through the absorbed decode kernel
  (``kernels/mla_decode/ops.py::mla_decode_attention``; on the CPU its
  plain version, ``repro``'s dense arithmetic in fp32).

``norm_eps`` is the q and kv latents' RMSNorm epsilon (the model's, as
DeepSeek-V2 publishes it; ``repro``'s 1e-5 by default).
``rope_scaling`` (a ``configs.base.RopeScaling``, None as in ``repro``)
gives the rope YaRN's frequencies, and folds YaRN's softmax gain
mscale(factor, mscale_all_dim)² into the queries (both parts), so the
three paths and the extend kernel keep their (nope + rope)^-½ scale.

The K/V expansion from the latent and the packing of [nope ‖ rope] run
under the span ``serve.mla_expand`` (prefill and extend).

In a sharded program (``DTensor`` s inside ``use_rules``) the prefill's
attention runs on each rank's rows and heads, and decode over a latent
cache whose positions are sharded, as ``attention.py``'s decode does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.extend_attention import ops as extend_ops
from repro_torch.kernels.mla_decode import ops as mla_decode_ops

from repro_torch.distributed.sharding import KEEP, local_region

from .attention import (blocked_attention, seq_offset, seq_parallel_write, seq_update,
                        softmax_combine)
from .common import (apply_rope, dense, proj_heads, proj_out, rms_norm, rope_angles,
                     yarn_softmax_gain)


class MLAParams(NamedTuple):
    w_dq: torch.Tensor     # (d, q_lora)
    q_norm: torch.Tensor   # (q_lora,)
    w_uq: torch.Tensor     # (q_lora, H, nope+rope)
    w_dkv: torch.Tensor    # (d, kv_lora + rope)
    kv_norm: torch.Tensor  # (kv_lora,)
    w_uk: torch.Tensor     # (kv_lora, H, nope)
    w_uv: torch.Tensor     # (kv_lora, H, v_dim)
    w_o: torch.Tensor      # (H, v_dim, d)


def _latent(p: MLAParams, m: MLAConfig, x, positions, theta, scaling=None, eps=1e-5):
    """Compressed KV stream: returns (c_kv normed, k_rope roped)."""
    dkv = dense(x, p.w_dkv)                               # (B,T,kv_lora+rope)
    c_kv = rms_norm(dkv[..., : m.kv_lora_rank], p.kv_norm, eps)
    k_rope = dkv[..., m.kv_lora_rank:][..., None, :]      # (B,T,1,rope)
    kc, ks = rope_angles(positions, m.qk_rope_head_dim, theta, scaling)
    k_rope = apply_rope(k_rope, kc, ks)[..., 0, :]        # shared across heads
    return c_kv, k_rope


def _queries(p: MLAParams, m: MLAConfig, x, positions, theta, scaling=None, eps=1e-5):
    q = proj_heads(rms_norm(dense(x, p.w_dq), p.q_norm, eps), p.w_uq)  # (B,S,H,nope+rope)
    gain = yarn_softmax_gain(scaling)
    if gain != 1.0:      # YaRN's softmax gain, folded into q
        q = q * gain
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]
    qc, qs = rope_angles(positions, m.qk_rope_head_dim, theta, scaling)
    return q_nope, apply_rope(q_rope, qc, qs)


def mla_self_attention(p: MLAParams, m: MLAConfig, x, positions, *, theta: float,
                       block: int = 512, rope_scaling=None, norm_eps: float = 1e-5):
    """Prefill: expand K/V from the latent, blocked softmax.

    Returns (out, (c_kv, k_rope)) — the cacheable latent stream.
    """
    q_nope, q_rope = _queries(p, m, x, positions, theta, rope_scaling, norm_eps)
    c_kv, k_rope = _latent(p, m, x, positions, theta, rope_scaling, norm_eps)
    with obs.span("serve.mla_expand"):
        k_nope = proj_heads(c_kv, p.w_uk)                 # (B,T,H,nope)
        v = proj_heads(c_kv, p.w_uv)                      # (B,T,H,v)
    out = _attend_region(q_nope, q_rope, k_nope, k_rope, v, positions, block=block)
    return proj_out(out, p.w_o), (c_kv, k_rope)


def _attend(q_nope, q_rope, k_nope, k_rope, v, positions, *, block: int):
    # the packed width's scale (nope+rope)^-0.5 is MLA's
    with obs.span("serve.mla_expand"):
        q, k = extend_ops.pack_mla(q_nope, q_rope, k_nope, k_rope)
    return blocked_attention(q, k, v, positions, positions, causal=True, block=block)


_HEADS = ("batch", None, "heads", None)
_attend_region = local_region(_attend, (_HEADS, _HEADS, _HEADS, ("batch", None, None), _HEADS,
                                        ("batch", None)), (_HEADS,))


def mla_extend(p: MLAParams, m: MLAConfig, h, cache_ckv, cache_krope,
               positions, start, *, theta: float, rope_scaling=None,
               norm_eps: float = 1e-5):
    """Extend-path MLA over a capacity-padded latent cache, in place.

    h (B, nb, d) is the chunk's normed hidden state; cache_ckv (B, cap,
    kv_lora) / cache_krope (B, cap, rope) hold the valid latent stream for
    [0, start).  The chunk's latents are written at [start, start+nb), K/V
    are expanded from the *whole padded* latent (as ``repro`` does), and
    the extend kernel masks everything past ``t_real = start + nb``.
    ``start`` is a 0-d integer tensor on the cache's device.

    Returns (projected out, (cache_ckv, cache_krope)).
    """
    nb = h.shape[1]
    q_nope, q_rope = _queries(p, m, h, positions, theta, rope_scaling, norm_eps)
    c_new, kr_new = _latent(p, m, h, positions, theta, rope_scaling, norm_eps)
    seq_update(cache_ckv, c_new, start)
    seq_update(cache_krope, kr_new, start)
    # extend_ops.extend_attention_mla, with its packing under the span
    with obs.span("serve.mla_expand"):
        k_nope = proj_heads(cache_ckv, p.w_uk)            # (B, cap, H, nope)
        v = proj_heads(cache_ckv, p.w_uv)                 # (B, cap, H, v)
        q, k = extend_ops.pack_mla(q_nope, q_rope, k_nope, cache_krope)
    out = extend_ops.extend_attention(q, k, v, t_real=start + nb)
    return proj_out(out, p.w_o), (cache_ckv, cache_krope)


def mla_decode(p: MLAParams, m: MLAConfig, x, cache_ckv, cache_krope, pos, *,
               theta: float, rope_scaling=None, norm_eps: float = 1e-5):
    """Absorbed-matrix decode in latent space, in place.

    x (B,1,d); cache_ckv (B,T,kv_lora); cache_krope (B,T,rope); pos (B,)
    int32 on the caches' device.  Writes row b's latent at pos[b], then
    scores = q_nopeᵀ·W_uk·c + q_ropeᵀ·k_rope over positions ≤ pos[b] and
    out = (probs·c)·W_uv, in fp32.
    """
    q_nope, q_rope = _queries(p, m, x, pos[:, None], theta, rope_scaling, norm_eps)
    c_new, kr_new = _latent(p, m, x, pos[:, None], theta, rope_scaling, norm_eps)
    out = _decode_region(q_nope, q_rope, c_new, kr_new, cache_ckv, cache_krope, pos, p.w_uk,
                         p.w_uv, scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    out = out[:, None].to(x.dtype)                        # (B,1,H,v)
    return proj_out(out, p.w_o), (cache_ckv, cache_krope)


def _decode_plain(q_nope, q_rope, c_new, kr_new, cache_ckv, cache_krope, pos, w_uk, w_uv, *,
                  scale: float):
    b = q_nope.shape[0]
    rows = torch.arange(b, device=cache_ckv.device)
    cache_ckv[rows, pos.long()] = c_new[:, 0].to(cache_ckv.dtype)
    cache_krope[rows, pos.long()] = kr_new[:, 0].to(cache_krope.dtype)
    # absorb: q' = q_nope @ W_uk  → latent-space query (B,H,kv_lora)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    return mla_decode_ops.mla_decode_attention(q_lat, q_rope[:, 0], cache_ckv, cache_krope,
                                               w_uv, pos, scale=scale)


def _decode_sharded(q_nope, q_rope, c_new, kr_new, cache_ckv, cache_krope, pos, w_uk, w_uv, *,
                    scale: float):
    """One rank's absorbed decode over its latent positions; the softmax
    partials combine across the ranks that shard the positions."""
    entry, off = seq_offset(cache_ckv.shape[1])
    seq_parallel_write(cache_ckv, c_new[:, 0], pos, off)
    seq_parallel_write(cache_krope, kr_new[:, 0], pos, off)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    sc = torch.einsum("bhl,btl->bht", q_lat.float(), cache_ckv.float())
    sc = sc + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(), cache_krope.float())
    o_lat = softmax_combine(sc * scale, pos, off, entry,
                            lambda p: torch.einsum("bht,btl->bhl", p, cache_ckv.float()))
    return torch.einsum("bhl,lhv->bhv", o_lat, w_uv.float())


_ROWS = ("batch", None, None, None)
_decode_region = local_region(
    _decode_sharded, (_ROWS, _ROWS, ("batch", None, None), ("batch", None, None), KEEP, KEEP,
                      ("batch",), (None, None, None), (None, None, None)),
    (("batch", None, None),), plain=_decode_plain)
