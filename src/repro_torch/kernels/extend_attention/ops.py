"""Public wrapper: (B, nb, H, hd) suffix attention over (B, T, KV, hd) KV.

The entry point the model's ``prefill_extend`` path routes through.  The
TPU layout (``repro``'s ``ops.py``) flattens (batch, KV head) pairs onto
the kernel's stream grid and stacks each group's G query heads on one
stream's q-row axis (row ``g·nb + i``).  The CUDA kernel does the same
stacking by index arithmetic on the model's own (B, nb, H, hd) and
(B, T, KV, hd) tensors, so no transposed copy of q or of the cache is made.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel

from .kernel import extend_attention_cuda
from .ref import extend_attention_ref


def extend_attention(q, k, v, *, t_real=None):
    """Causal suffix attention (see ref.py for semantics).

    q (B, nb, H, hd); k/v (B, T, KV, hd) with KV dividing H.  ``t_real``
    (int or 0-d integer tensor, default: the full KV length) marks the
    valid KV prefix of a padded cache; on the card it stays on the device.
    """
    if t_real is None:
        t_real = k.shape[1]
    if not uses_kernel(q):
        return extend_attention_ref(q, k, v, t_real=t_real)
    t_real = torch.as_tensor(t_real, dtype=torch.int32, device=q.device)
    return extend_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), t_real.reshape(1))
