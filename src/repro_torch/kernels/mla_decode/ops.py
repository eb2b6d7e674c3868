"""Public wrapper: MLA's absorbed decode attention over a latent cache.

The entry point ``models/mla.py``'s absorbed decode routes through, after
the new latent is written at ``pos`` and the query absorbed through
``W_uk``: the scores, softmax, probabilities times latents and the
product with ``W_uv``, in fp32.  The CUDA kernel cuts each row's
positions into fixed splits of ``kernel.SPLIT``: one block per (row, 64
heads, split) writes fp32 partials, and a combine kernel merges a row's
live splits in ascending order and applies ``W_uv``, so a row's output is
bitwise the same at any padded capacity and in any batch.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:func:`.ref.mla_decode_plain`); see
:mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, uses_kernel

from .kernel import SPLIT, mla_decode_cuda
from .ref import mla_decode_plain


def positions_read(live, cap: int, *, kernel: bool) -> int:
    """Cache positions one call scores, summed over its rows: the kernel
    reads each row's ``live`` positions (``pos + 1``) in whole splits of
    ``kernel.SPLIT``, up to the capacity ``cap``; the plain version reads
    the capacity."""
    if not kernel:
        return cap * len(live)
    return sum(min(-(-t // SPLIT) * SPLIT, cap) for t in live)


def mla_decode_work(q_lat, q_rope, cache_ckv, cache_krope, w_uv, *, pos, scale) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: 2·H·(2·L + R) a position read
    (the scores over [latent ‖ rope] and the probabilities times the
    latent), over :func:`positions_read`, and 2·B·H·L·V for ``W_uv``; a
    fake or meta ``pos`` has no values, so its rows count as full.  Bytes:
    q, ``W_uv``, pos and the fp32 output once, the latents and rope keys
    over the positions read."""
    from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

    b, h, l = q_lat.shape
    r = q_rope.shape[-1]
    t = cache_ckv.shape[1]
    v = w_uv.shape[-1]
    kernel = cache_ckv.is_cuda
    if isinstance(pos, FakeTensor) or pos.device.type == "meta":
        rows = positions_read([t] * b, t, kernel=kernel)
    else:
        with unset_fake_temporarily():
            rows = positions_read([p + 1 for p in pos.tolist()], t, kernel=kernel)
    nbytes = ((q_lat.numel() + q_rope.numel()) * q_lat.element_size()
              + w_uv.numel() * w_uv.element_size() + pos.numel() * pos.element_size()
              + 4 * b * h * v
              + rows * (l * cache_ckv.element_size() + r * cache_krope.element_size()))
    return 2 * h * (2 * l + r) * rows + 2 * b * h * l * v, nbytes


def mla_decode_attention(q_lat, q_rope, cache_ckv, cache_krope, w_uv, pos, *,
                         scale: float):
    """Absorbed single-query attention over a padded latent cache.

    q_lat (B, H, L); q_rope (B, H, R); cache_ckv (B, T, L); cache_krope
    (B, T, R); w_uv (L, H, V); pos (B,) int — row b attends to cache
    positions ``≤ pos[b]``.  Returns (B, H, V) in fp32.
    """
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("mla_decode", mla_decode_work, _mla_decode, q_lat, q_rope,
                              cache_ckv, cache_krope, w_uv, pos=pos, scale=scale)
    return _mla_decode(q_lat, q_rope, cache_ckv, cache_krope, w_uv, pos=pos, scale=scale)


def _mla_decode(q_lat, q_rope, cache_ckv, cache_krope, w_uv, *, pos, scale):
    if not uses_kernel(cache_ckv):
        return mla_decode_plain(q_lat, q_rope, cache_ckv, cache_krope, w_uv, pos, scale=scale)
    pos = pos.to(device=cache_ckv.device, dtype=torch.int32).contiguous()
    return mla_decode_cuda(q_lat.contiguous(), q_rope.contiguous(), cache_ckv, cache_krope,
                           w_uv, pos, scale=scale)
