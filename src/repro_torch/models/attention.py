"""GQA attention: blocked-softmax prefill path + cached extend/decode paths.

Prefill uses an online-softmax loop over KV blocks in plain PyTorch ops:
peak activation is O(S·block) instead of O(S²), and KV heads stay
unexpanded — scores are computed in grouped form (B, KV, G, S, block).
The extend and decode paths attend over a capacity-padded KV cache through
the port's hand-written kernels (``kernels/extend_attention``,
``kernels/decode_attention``) on the card, and their plain versions on the
CPU.  Cross-attention (whisper's decoder, llama-vision's image layers)
attends over context K/V projected once per document; like ``repro``'s,
it is the blocked softmax without a mask, on every path.

Caches are updated **in place** here (the JAX reference returns new
arrays): ``seq_update`` and ``write_kv`` write into the cache tensors they
are given, which are views into the caller's layer-stacked cache.

Traced as a sharded program (``DTensor`` s inside ``use_rules``), the
blocked softmax runs on each rank's rows and heads
(``distributed.sharding.local_region``), and decode attends over a cache
whose positions are sharded (``cache_seq``): each rank writes the new row
where it holds its position, scores its own positions, and the ranks
combine their softmax partials (max, then sums) by all-reduce.  On plain
tensors none of this runs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import (KEEP, active, all_reduce_over, local_region,
                                              mesh_coords)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.extend_attention import ops as extend_ops

from .common import apply_rope, proj_heads, proj_out, rms_norm, rope_angles

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor       # (d, H, hd)
    wk: torch.Tensor       # (d, KV, hd)
    wv: torch.Tensor       # (d, KV, hd)
    wo: torch.Tensor       # (H, hd, d)
    q_norm: Optional[torch.Tensor] = None  # (hd,)
    k_norm: Optional[torch.Tensor] = None


def _project_qkv(p: AttnParams, x, kv_x, q_pos, k_pos, theta,
                 qk_norm_eps=1e-6, rope=True):
    q = proj_heads(x, p.wq)            # (B, S, H, hd)
    k = proj_heads(kv_x, p.wk)         # (B, T, KV, hd)
    v = proj_heads(kv_x, p.wv)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, qk_norm_eps)
        k = rms_norm(k, p.k_norm, qk_norm_eps)
    if rope:
        qc, qs = rope_angles(q_pos, q.shape[-1], theta)
        kc, ks = rope_angles(k_pos, k.shape[-1], theta)
        q = apply_rope(q, qc, qs)
        k = apply_rope(k, kc, ks)
    return q, k, v


def _grouped(q, n_kv):
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def blocked_attention(q, k, v, q_pos, k_pos, *, causal: bool, block: int = 512):
    """Online softmax over KV blocks.  q (B,S,H,hd); k/v (B,T,KV,hd).

    Operands keep their dtype into each product with fp32 accumulation
    (bf16 scores at full width); softmax statistics are fp32.  In a
    sharded program each rank runs it on its rows and heads: K/V heads
    shard with the q heads when their count divides the mesh, else each
    rank takes the K/V heads its q heads read.
    """
    st = active()
    if st is None or getattr(q, "placements", None) is None:
        return _blocked_attention(q, k, v, q_pos, k_pos, causal=causal, block=block)
    rules, mesh = st
    n = mesh_coords(mesh, rules.rules.get("heads"))[1]
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    if kv % n and h % n == 0 and ((h // n) % g == 0 or g % (h // n) == 0):
        return _q_heads_region(q, k, v, q_pos, k_pos, causal=causal, block=block, n_heads=h)
    return _blocked_region(q, k, v, q_pos, k_pos, causal=causal, block=block)


def _blocked_attention(q, k, v, q_pos, k_pos, *, causal: bool, block: int = 512):
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = h // kv
    block = min(block, t)
    if t % block != 0:   # smoke-scale fallback: single block
        block = t
    qg = _grouped(q, kv).float()                          # (B,S,KV,G,hd)
    scale = hd ** -0.5
    m = torch.full((b, kv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, s, hd_v), dtype=torch.float32, device=q.device)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None]
    for i in range(t // block):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kblk.float()) * scale
        if causal:
            pblk = k_pos[..., i * block:(i + 1) * block]
            kp = pblk if pblk.ndim == 2 else pblk[None]
            mask = qp[:, None, None, :, None] >= kp[:, None, None, None, :]
            sc = torch.where(mask, sc, NEG_INF)   # a scalar: no host copy
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,S,hd_v)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd_v)
    return out.to(q.dtype)


# q, k and v bear one name for their heads, so a rank holds whole groups
_HEADS = ("batch", None, "heads", None)
_blocked_region = local_region(_blocked_attention, (_HEADS, _HEADS, _HEADS, ("batch", None),
                                                    ("batch", None)), (_HEADS,))


def _q_heads_attention(q, k, v, q_pos, k_pos, *, causal: bool, block: int, n_heads: int):
    """A rank's q heads over the K/V heads they read (K/V whole here)."""
    h = q.shape[2]
    if h < n_heads:
        rules, mesh = active()
        i = mesh_coords(mesh, rules.rules.get("heads"))[0]
        g = n_heads // k.shape[2]
        lo, hi = i * h // g, -(-(i + 1) * h // g)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return _blocked_attention(q, k, v, q_pos, k_pos, causal=causal, block=block)


_ROWS = ("batch", None, None, None)
_q_heads_region = local_region(_q_heads_attention, (_HEADS, _ROWS, _ROWS, ("batch", None),
                                                    ("batch", None)), (_HEADS,))


def seq_update(cache, new, start):
    """Write ``new`` into ``cache`` along the sequence axis (1) at ``start``,
    **in place**.  ``start`` may be a 0-d device tensor (no host sync); the
    caller guarantees ``start + new.shape[1] <= cache.shape[1]``."""
    idx = start + torch.arange(new.shape[1], device=cache.device)
    cache.index_copy_(1, idx, new.to(cache.dtype))
    return cache


def extend_attention_cached(p: AttnParams, h, cache_k, cache_v, positions,
                            start, *, theta: float):
    """Extend-path self-attention over a capacity-padded KV cache.

    h (B, nb, d) is the chunk's normed hidden state; cache_k/v (B, cap, KV,
    hd) hold valid KV for [0, start).  The chunk's K/V are written in place
    at [start, start+nb) and its queries attend causally over the result
    through the extend kernel (``t_real = start + nb``); anything beyond
    start+nb is garbage the mask excludes.  ``start`` is a 0-d integer
    tensor on the cache's device.  Returns (projected out, (cache_k,
    cache_v)).
    """
    nb = h.shape[1]
    q, k_new, v_new = _project_qkv(p, h, h, positions, positions, theta)
    seq_update(cache_k, k_new, start)
    seq_update(cache_v, v_new, start)
    out = extend_ops.extend_attention(q, cache_k, cache_v, t_real=start + nb)
    return proj_out(out, p.wo), (cache_k, cache_v)


def expand_kv_heads(k, n_heads: int):
    """Repeat KV heads up to the q-head count (``repro``'s TP alignment)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def self_attention(p: AttnParams, x, positions, *, causal: bool, theta: float,
                   block: int = 512, expand_kv: bool = False):
    """Full self-attention for prefill.  Returns (out, (k, v) cacheable);
    ``expand_kv`` attends over KV heads repeated to the q heads, as
    ``repro`` does for ``cfg.expand_kv``, and still caches the unexpanded
    (k, v)."""
    q, k, v = _project_qkv(p, x, x, positions, positions, theta)
    if expand_kv:
        h = q.shape[2]
        k_att, v_att = expand_kv_heads(k, h), expand_kv_heads(v, h)
    else:
        k_att, v_att = k, v
    out = blocked_attention(q, k_att, v_att, positions, positions, causal=causal,
                            block=block)
    return proj_out(out, p.wo), (k, v)


def cross_attention(p: AttnParams, x, ctx_kv, *, block: int = 512):
    """Attend x → precomputed context K/V (no RoPE, no mask).  As in
    ``repro``, the context is one KV block unless its length divides
    ``block`` (1500 audio frames and 1601 image patches both run as one)."""
    k, v = ctx_kv
    b, s = x.shape[:2]
    q = proj_heads(x, p.wq)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
    t = k.shape[1]
    pos_q = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    blk = block if t % block == 0 else t
    out = blocked_attention(q, k, v, pos_q, pos_k, causal=False, block=blk)
    return proj_out(out, p.wo)


def project_context(p: AttnParams, ctx):
    """Cross-attention K/V of the context embeddings ``ctx`` (B, T, d),
    computed once per document and cached as the ``ck``/``cv`` leaves."""
    k = proj_heads(ctx, p.wk)
    v = proj_heads(ctx, p.wv)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm)
    return k, v


def decode_attention(p: AttnParams, x, cache_k, cache_v, pos, *, theta: float):
    """One-step decode.  x (B,1,d); cache (B,T,KV,hd); pos (B,) int32.

    Writes the new K/V at ``pos`` (in place) and attends over positions
    ≤ pos through the ragged flash-decode kernel, whose output is
    bit-invariant to the cache's padded capacity.
    """
    q, k_new, v_new = _project_qkv(p, x, x, pos[:, None], pos[:, None], theta)
    out = _decode_region(q, k_new, v_new, cache_k, cache_v, pos)
    return proj_out(out.to(x.dtype), p.wo), (cache_k, cache_v)


def _decode_plain(q, k_new, v_new, cache_k, cache_v, pos):
    decode_ops.write_kv(cache_k, cache_v, k_new, v_new, pos)
    return decode_ops.decode_attention(q, cache_k, cache_v, pos=pos)


def seq_parallel_write(cache, new, pos, off: int):
    """Write ``new`` (B, ...) at global position ``pos`` of each row into
    this rank's positions [off, off + T_local) of ``cache`` (B, T_local,
    ...), in place; a row whose position another rank holds keeps its
    values."""
    t = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    lp = pos.long() - off
    mine = (lp >= 0) & (lp < t)
    idx = lp.clamp(0, t - 1)
    keep = mine.reshape((-1,) + (1,) * (new.ndim - 1))
    cache[rows, idx] = torch.where(keep, new.to(cache.dtype), cache[rows, idx])


def softmax_combine(sc, pos, off: int, entry, values):
    """Masked softmax over positions sharded across the ranks of ``entry``:
    ``sc`` (..., T_local) are this rank's scores for positions off + t,
    masked past each row's ``pos`` (``pos`` broadcasts against ``sc``'s
    leading dimension); returns Σ_t p_t · v_t with ``values(p)`` giving a
    rank's unnormalised sum, the partial maxima and sums all-reduced."""
    t = sc.shape[-1]
    k_pos = off + torch.arange(t, device=sc.device)
    valid = k_pos.view((1,) * (sc.ndim - 1) + (t,)) <= pos.reshape(
        (-1,) + (1,) * (sc.ndim - 1))
    sc = torch.where(valid, sc, NEG_INF)
    m = all_reduce_over(sc.amax(-1), "max", entry)
    p = torch.exp(sc - m[..., None])
    l = all_reduce_over(p.sum(-1), "sum", entry)
    acc = all_reduce_over(values(p), "sum", entry)
    return acc / torch.clamp(l, min=1e-30).reshape(l.shape + (1,) * (acc.ndim - l.ndim))


def _decode_sharded(q, k_new, v_new, cache_k, cache_v, pos):
    """One rank's decode over its cache positions (see the module
    docstring); q holds every head."""
    entry, off = seq_offset(cache_k.shape[1])
    seq_parallel_write(cache_k, k_new[:, 0], pos, off)
    seq_parallel_write(cache_v, v_new[:, 0], pos, off)
    b, _, h, hd = q.shape
    kv = cache_k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, hd).float() * (hd ** -0.5)
    sc = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.float())
    out = softmax_combine(sc, pos, off, entry,
                          lambda p: torch.einsum("bkgt,btkd->bkgd", p, cache_v.float()))
    return out.reshape(b, 1, h, cache_v.shape[-1])


def seq_offset(t_local: int) -> tuple:
    """(mesh entry of ``cache_seq``, this rank's first position) for a
    cache of ``t_local`` positions a rank, in a sharded program."""
    rules, mesh = active()
    entry = rules.rules.get("cache_seq")
    return entry, t_local * mesh_coords(mesh, entry)[0]


_decode_region = local_region(_decode_sharded, (_ROWS, _ROWS, _ROWS, KEEP, KEEP, ("batch",)),
                              (_ROWS,), plain=_decode_plain)
