"""Plain PyTorch version of the suffix (extend) attention kernel.

Semantics: q holds the *last* ``nb`` positions of a length-``t_real``
stream; kv covers at least ``t_real`` positions (anything beyond is
padding and ignored).  Causal: q at global position ``t_real − nb + i``
attends to kv positions ``≤ t_real − nb + i``.

Grouped layout (GQA): q (B, nb, H, hd) against k/v (B, T, KV, hd[_v]) with
KV dividing H; query head ``h' = k·G + g'`` reads KV head ``k``.  No head
expansion is materialized.

:func:`extend_attention_ref` is the kernels' plain version (the CPU path);
:func:`extend_attention_tiled` is the plain form of the CUDA kernel's tile
walk, which the tests and the smoke run hold the bf16 kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis


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


#: how P enters the P·V product of :func:`extend_attention_tiled`: fp32 (the
#: TPU kernel's P), rounded once to bf16, or as a sum of two or three bf16
#: terms (each rounding what the ones before left)
P_MODES = ("fp32", "bf16", "bf16x2", "bf16x3")
NEG_INF = -1e30
TILE = 64          # KV positions per tile (the CUDA kernel's BN)
ROWS = 64          # stacked q rows per block (the CUDA kernel's BM)
GROUPS = 2         # interleaved tile walks per block (the kernel's warp groups)


def _p_terms(p, p_mode: str):
    """P as the operands the second product sees."""
    if p_mode not in P_MODES:
        raise ValueError(f"p_mode must be one of {P_MODES}, got {p_mode!r}")
    if p_mode == "fp32":
        return [p]
    terms, rest = [], p
    for _ in range({"bf16": 1, "bf16x2": 2, "bf16x3": 3}[p_mode]):
        terms.append(rest.bfloat16().float())
        rest = rest - terms[-1]                   # exact in fp32
    return terms


def _kv_tile(x, t0: int, t_real: int):
    """Positions [t0, t0 + TILE) of x (B, T, KV, d) as a contiguous fp32
    tile; positions at or past ``t_real`` are zeros, as the kernel stages
    them, so the padding's contents never enter a sum."""
    part = x[:, t0:min(t0 + TILE, t_real)].float()
    return pad_axis(part, 1, TILE).contiguous()


def extend_attention_tiled(q, k, v, *, t_real=None, p_mode: str = "fp32"):
    """The CUDA kernel's tile walk in plain PyTorch.

    q (B, nb, H, hd); k/v (B, T, KV, hd[_v]) → (B, nb, H, hd_v) in q's
    dtype.  Per (batch, KV head) the G·nb query rows are stacked as
    ``r = g·nb + i`` (``q_pos = t_real − nb + r mod nb``) and cut into
    blocks of :data:`ROWS`.  A block walks the :data:`TILE`-wide KV tiles
    from position 0 to the tile that holds its greatest q_pos, dealt
    round-robin to :data:`GROUPS` walks; each runs an online softmax (S = (q·k)·hd^-0.5 in
    fp32, the mask ``k_pos ≤ q_pos ∧ k_pos < t_real`` at −1e30, fp32 m, l
    and acc), and the walks merge in order before ``acc / max(l, 1e-30)``.
    ``p_mode`` says how P enters the P·V product (:data:`P_MODES`); l
    always sums the fp32 P.  Only tests and the smoke run use this form.
    """
    b, nb, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    hd_v = v.shape[-1]
    t_real = k.shape[1] if t_real is None else int(t_real)
    n_rows = g * nb
    qs = q.float().reshape(b, nb, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kv, n_rows, hd)
    q_pos = t_real - nb + torch.arange(n_rows, device=q.device) % nb
    out = torch.empty((b, kv, n_rows, hd_v), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    for r0 in range(0, n_rows, ROWS):
        qb, qp = qs[:, :, r0:r0 + ROWS], q_pos[r0:r0 + ROWS]
        n_tiles = int(qp.max()) // TILE + 1
        walks = []
        for first in range(GROUPS):
            m = torch.full(qb.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((*qb.shape[:3], hd_v), dtype=torch.float32, device=q.device)
            for t0 in range(first * TILE, n_tiles * TILE, GROUPS * TILE):
                kc = _kv_tile(k, t0, t_real)
                vc = _kv_tile(v, t0, t_real)
                sc = torch.einsum("bkrd,btkd->bkrt", qb, kc) * (hd ** -0.5)
                k_pos = t0 + torch.arange(TILE, device=q.device)
                valid = (k_pos[None, :] <= qp[:, None]) & (k_pos[None, :] < t_real)
                sc = torch.where(valid, sc, neg)
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None]
                for term in _p_terms(p, p_mode):
                    acc = acc + torch.einsum("bkrt,btkd->bkrd", term, vc)
                m = m_new
            walks.append((m, l, acc))
        m = torch.stack([w[0] for w in walks]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(walks[0][2])
        for m_w, l_w, acc_w in walks:                       # in order
            a = torch.exp(m_w - m)
            l = l + l_w * a
            acc = acc + acc_w * a[..., None]
        out[:, :, r0:r0 + ROWS] = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, kv, g, nb, hd_v).permute(0, 3, 1, 2, 4)
    return out.reshape(b, nb, h, hd_v).to(q.dtype)
