"""Plain PyTorch version of the suffix (extend) attention kernel.

Semantics: q holds the *last* ``nb`` positions of a length-``t_real``
stream; kv covers at least ``t_real`` positions (anything beyond is
padding and ignored).  Causal: q at global position ``t_real − nb + i``
attends to kv positions ``≤ t_real − nb + i``.

Grouped layout (GQA): q (B, nb, H, hd) against k/v (B, T, KV, hd[_v]) with
KV dividing H; query head ``h' = k·G + g'`` reads KV head ``k``.  No head
expansion is materialized.
"""
from __future__ import annotations

import torch


def extend_attention_ref(q, k, v, *, t_real=None):
    """q (B, nb, H, hd); k/v (B, T, KV, hd[_v]) → (B, nb, H, hd_v), fp32 math.

    ``t_real`` (int or 0-d integer tensor; default: the full KV length)
    marks the valid KV prefix — positions ≥ ``t_real`` are masked out.
    """
    b, nb, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    if t_real is None:
        t_real = t
    qf = q.float().reshape(b, nb, kv, g, hd)
    sc = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (hd ** -0.5)
    q_pos = t_real - nb + torch.arange(nb, device=q.device)
    k_pos = torch.arange(t, device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < t_real)
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(b, nb, h, v.shape[-1]).to(q.dtype)
