"""Public wrappers: (B, nb, H, hd) suffix attention over (B, T, KV, hd) KV.

The entry point the model's ``prefill_extend`` path routes through.  The
TPU layout (``repro``'s ``ops.py``) flattens (batch, KV head) pairs onto
the kernel's stream grid and stacks each group's G query heads on one
stream's q-row axis (row ``g·nb + i``).  The CUDA kernel does the same
stacking by index arithmetic on the model's own (B, nb, H, hd) and
(B, T, KV, hd) tensors, so no transposed copy of q or of the cache is made.
MLA's packed [nope ‖ rope] layout is assembled by
:func:`extend_attention_mla`, as in ``repro``: the shared rope key is
broadcast across heads, and the v width differs from the q·k width.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, uses_kernel

from .kernel import extend_attention_cuda
from .ref import extend_attention_ref


def extend_attention(q, k, v, *, t_real=None):
    """Causal suffix attention (see ref.py for semantics).

    q (B, nb, H, hd); k (B, T, KV, hd); v (B, T, KV, hd_v) with KV dividing
    H; the scores are scaled by hd^-0.5.  ``t_real``
    (int or 0-d integer tensor, default: the full KV length) marks the
    valid KV prefix of a padded cache; on the card it stays on the device.
    """
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("extend_attention", extend_work, _extend_attention, q, k, v,
                              t_real=t_real)
    return _extend_attention(q, k, v, t_real=t_real)


def extend_work(q, k, v, *, t_real=None) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: the plain version's two
    products over the whole padded length T, 2·B·nb·H·T·(hd + hd_v).  Bytes:
    q, K, V and the output once."""
    b, nb, h, hd = q.shape
    t = k.shape[1]
    hd_v = v.shape[-1]
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v)) \
        + b * nb * h * hd_v * q.element_size()
    return 2 * b * nb * h * t * (hd + hd_v), nbytes


def _extend_attention(q, k, v, *, t_real=None):
    if t_real is None:
        t_real = k.shape[1]
    if not uses_kernel(q):
        return extend_attention_ref(q, k, v, t_real=t_real)
    t_real = torch.as_tensor(t_real, dtype=torch.int32, device=q.device)
    return extend_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), t_real.reshape(1))


def pack_mla(q_nope, q_rope, k_nope, k_rope):
    """MLA's packed operands: q = [q_nope ‖ q_rope] (B, nb, H, nope + rope)
    and k = [k_nope ‖ k_rope broadcast across heads] (B, T, H, nope + rope),
    a copy.  k_rope (B, T, rope) is the decoupled rope key the heads share."""
    b, t, h, _ = k_nope.shape
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, k_rope.shape[-1])],
                      dim=-1))


def extend_attention_mla(q_nope, q_rope, k_nope, k_rope, v, *, t_real=None):
    """MLA suffix attention over an expanded latent cache.

    q_nope (B, nb, H, nope); q_rope (B, nb, H, rope); k_nope (B, T, H, nope);
    k_rope (B, T, rope), the decoupled rope key shared across heads;
    v (B, T, H, hd_v).  Packs [nope ‖ rope] into one q·k width
    (:func:`pack_mla`) so a single kernel pass scores both terms; the
    packed width's scale is MLA's (nope + rope)^-0.5.
    """
    q, k = pack_mla(q_nope, q_rope, k_nope, k_rope)
    return extend_attention(q, k, v, t_real=t_real)
