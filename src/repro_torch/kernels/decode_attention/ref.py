"""Plain PyTorch versions of the ragged flash-decode kernel.

Semantics: one new query row per sequence, scored against cache positions
``≤ pos[b]`` of a capacity-padded KV cache; anything beyond ``pos`` is
padding and ignored.

:func:`decode_attention_blocked` is the kernel's plain version (the CPU
path): an online softmax over **fixed-size** KV blocks whose trip count is
``max(pos) // block + 1``.  The block size is not a function of the padded
capacity, and masked tails contribute exact zeros, so a row's output is
bit-invariant to how much padding its cache carries.
:func:`decode_attention_split` is the plain form of the CUDA kernel's
split-KV algorithm (per-split partials, then a combine in ascending split
order); the tests and the smoke run hold the kernel against it.
:func:`decode_attention_ref` is the dense oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis, round_up

NEG_INF = -1e30
DECODE_BLOCK = 256        # fixed KV block; independent of padded capacity


def live_blocks(pos, n_blocks: int, block: int = DECODE_BLOCK) -> int:
    """``max(pos) // block + 1``, the blocks some row reaches, read from
    ``pos`` (a device sync on the card); a fake ``pos`` has no values and
    gives all ``n_blocks``."""
    from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

    if isinstance(pos, FakeTensor) or pos.device.type == "meta":
        return n_blocks
    with unset_fake_temporarily():
        return int(pos.max()) // block + 1


def decode_attention_blocked(q, k, v, pos, *, block: int = DECODE_BLOCK):
    """Grouped single-query attention, online softmax over KV blocks.

    q (B, KV, G, hd); k/v (B, T, KV, hd[_v]); pos (B,) int →
    (B, KV, G, hd_v) float32.  Blocks past every row's ``pos`` are never
    touched (pack-level early exit; the kernel sharpens this to per-row).
    """
    b, kv, g, hd = q.shape
    t = k.shape[1]
    hd_v = v.shape[3]
    t_pad = round_up(t, block)
    if t_pad != t:                                       # mask covers the pad
        k = pad_axis(k, 1, t_pad)
        v = pad_axis(v, 1, t_pad)
    qf = q.float() * (hd ** -0.5)
    pos = pos.to(torch.int64)
    m = torch.full((b, kv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, hd_v), dtype=torch.float32, device=q.device)
    n_live = live_blocks(pos, t_pad // block, block)
    for i in range(n_live):
        # contiguous per-block copies: the reduction sees the same memory
        # layout whatever the padded capacity T is
        kc = k[:, i * block:(i + 1) * block].float().contiguous()
        vc = v[:, i * block:(i + 1) * block].float().contiguous()
        sc = torch.einsum("bkgd,btkd->bkgt", qf, kc)
        k_pos = i * block + torch.arange(block, device=q.device)
        valid = k_pos[None, :] <= pos[:, None]            # (B, block)
        sc = torch.where(valid[:, None, None, :], sc,
                         torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vc)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def decode_attention_ref(q, k, v, pos):
    """Dense oracle: full-T scores, fp32 math, same shapes as blocked."""
    b, kv, g, hd = q.shape
    t = k.shape[1]
    sc = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * (hd ** -0.5)
    valid = torch.arange(t, device=q.device)[None, :] <= pos.to(torch.int64)[:, None]
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.tensor(NEG_INF, device=q.device))
    prob = torch.softmax(sc, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", prob, v.float())


def decode_attention_split(q, k, v, pos, *, split: int):
    """The CUDA kernel's algorithm in plain PyTorch: split-KV, then combine.

    q (B, KV, G, hd); k/v (B, T, KV, hd[_v]); pos (B,) int →
    (B, KV, G, hd_v) float32.  A split is ``split`` consecutive positions;
    row b has live splits ``0 … pos[b] // split``.  Each live split gives a
    partial from its own positions alone: ``m`` (max score), ``l``
    (Σ exp(score − m)) and the unnormalised ``acc`` (Σ exp(score − m)·v).
    The combine takes ``M = max_s m_s`` and sums ``l_s·exp(m_s − M)`` and
    ``acc_s·exp(m_s − M)`` over the live splits in ascending order.  Rows
    are computed one by one on fixed-size slices, so a row's output depends
    neither on T nor on the rest of the batch.
    """
    b, kv, g, hd = q.shape
    hd_v = v.shape[3]
    qf = q.float() * (hd ** -0.5)
    out = torch.empty((b, kv, g, hd_v), dtype=torch.float32, device=q.device)
    offs = torch.arange(split, device=q.device)
    for row, p in enumerate(pos.tolist()):
        n_live = p // split + 1
        kr = pad_axis(k[row, :n_live * split].float(), 0, n_live * split)
        vr = pad_axis(v[row, :n_live * split].float(), 0, n_live * split)
        ms, ls, accs = [], [], []
        for s in range(n_live):
            valid = (s * split + offs <= p)                    # (split,)
            kc = kr[s * split:(s + 1) * split].contiguous()    # (split, KV, hd)
            vc = torch.where(valid[:, None, None],
                             vr[s * split:(s + 1) * split], 0.0).contiguous()
            sc = torch.einsum("kgd,tkd->kgt", qf[row], kc)
            sc = torch.where(valid, sc, torch.tensor(NEG_INF, device=q.device))
            m = sc.amax(-1)                                    # (KV, G)
            pr = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(pr.sum(-1))
            accs.append(torch.einsum("kgt,tkd->kgd", pr, vc))
        big_m = torch.stack(ms).amax(0)
        l_tot = torch.zeros_like(big_m)
        acc = torch.zeros((kv, g, hd_v), dtype=torch.float32, device=q.device)
        for m, l, a in zip(ms, ls, accs):                      # ascending s
            w = torch.exp(m - big_m)
            l_tot = l_tot + l * w
            acc = acc + a * w[..., None]
        out[row] = acc / torch.clamp(l_tot, min=1e-30)[..., None]
    return out
