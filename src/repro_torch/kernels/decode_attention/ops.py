"""Public wrappers: one-token decode attention over a (B, T, KV, hd) cache.

The entry point ``models/attention.py::decode_attention`` routes through.
The TPU layout (``repro``'s ``ops.py``) flattens (batch, KV head) pairs
onto the kernel's stream grid and stacks each KV head's G query heads on
the stream's q rows; the CUDA kernel reads the model's own tensors by index
arithmetic instead (no transposed copy of the cache per step) and cuts each
row's prefix into fixed splits of ``kernel.SPLIT`` positions: one
block per (row, KV head, split) writes an fp32 partial, and a combine
kernel merges a row's live splits in ascending order.  The splits are
fixed by position alone, so the output stays bitwise the same at any
padded capacity and in any batch (:func:`.ref.decode_attention_split` is
the same algorithm in plain PyTorch).

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
blocked version (:func:`.ref.decode_attention_blocked`); see
:mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, cdiv, uses_kernel

from .kernel import decode_attention_cuda
from .ref import DECODE_BLOCK, decode_attention_blocked, live_blocks


def write_kv(cache_k, cache_v, k_new, v_new, pos):
    """Insert the decode step's new K/V row at each sequence's ``pos``.

    cache_k/v (B, T, KV, hd[_v]); k_new/v_new (B, 1, KV, hd[_v]); pos (B,).
    Writes **in place** (the JAX reference returns updated copies) and
    returns the same tensors.
    """
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    p = pos.to(torch.int64)
    cache_k[rows, p] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, p] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def decode_work(q, k, v, *, pos) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: the plain version's two
    products over its live blocks, 2·B·H·(hd + hd_v)·(blocks · block); a
    fake ``pos`` has no values, so its cache counts as full.  Bytes: q,
    pos and the output once, K and V over the live blocks' positions."""
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    span = live_blocks(pos, cdiv(t, DECODE_BLOCK)) * DECODE_BLOCK
    rows = min(span, t)
    nbytes = (q.numel() * q.element_size() + pos.numel() * pos.element_size()
              + b * h * hd_v * q.element_size()
              + b * rows * kv * (hd * k.element_size() + hd_v * v.element_size()))
    return 2 * b * h * (hd + hd_v) * span, nbytes


def decode_attention(q, k, v, *, pos):
    """Single-query grouped attention over a padded cache (see ref.py).

    q (B, 1, H, hd); k/v (B, T, KV, hd) with KV dividing H; pos (B,) int —
    row b attends to cache positions ``≤ pos[b]``.  Returns (B, 1, H, hd)
    in q's dtype.
    """
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("decode_attention", decode_work, _decode_attention, q, k, v,
                              pos=pos)
    return _decode_attention(q, k, v, pos=pos)


def _decode_attention(q, k, v, *, pos):
    b, _, h, hd = q.shape
    kv = k.shape[2]
    if not uses_kernel(q):
        qg = q[:, 0].reshape(b, kv, h // kv, hd)
        out = decode_attention_blocked(qg, k, v, pos)
        return out.reshape(b, 1, h, v.shape[-1]).to(q.dtype)
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), pos)
