"""Plain PyTorch version of the absorbed MLA decode kernel.

Semantics: one new query per (row, head), absorbed into latent space
(``q_lat = q_nope · W_uk``) beside its rope part, scored against the row's
latents and rope keys at cache positions ``≤ pos[b]`` of a capacity-padded
cache; softmax; the probabilities times the latents (``o_lat``), taken
out of latent space through ``W_uv``, in fp32.

:func:`mla_decode_plain` is the CPU path: dense over the padded capacity
with the positions past ``pos`` masked, every operand in fp32 — the
arithmetic the model's absorbed decode ran before the kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mla_decode_plain(q_lat, q_rope, cache_ckv, cache_krope, w_uv, pos, *, scale: float):
    """q_lat (B, H, L); q_rope (B, H, R); cache_ckv (B, T, L); cache_krope
    (B, T, R); w_uv (L, H, V); pos (B,) int → (B, H, V) float32."""
    t = cache_ckv.shape[1]
    sc = torch.einsum("bhl,btl->bht", q_lat.float(), cache_ckv.float())
    sc = sc + torch.einsum("bhr,btr->bht", q_rope.float(), cache_krope.float())
    sc = sc * scale
    valid = torch.arange(t, device=sc.device)[None] <= pos[:, None]
    sc = torch.where(valid[:, None, :], sc, NEG_INF)
    prob = torch.softmax(sc, dim=-1)
    o_lat = torch.einsum("bht,btl->bhl", prob, cache_ckv.float())
    return torch.einsum("bhl,lhv->bhv", o_lat, w_uv.float())
