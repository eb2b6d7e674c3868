"""Plain PyTorch versions of the int8 block dequantization kernel."""
from __future__ import annotations

import torch


def dequant_blocks_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``q (G, rows, cols)`` int8 × ``scales (G,)`` → fp32 ``(G, rows, cols)``:
    the TPU kernel's layout and function."""
    return q.float() * scales.float()[:, None, None]


def dequantize_leaf_ref(q: torch.Tensor, scale: torch.Tensor, *, block: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """The same function on a stored leaf's own layout: ``q`` (d0, d1, S,
    ...) int8 with ``scale`` (d0, d1, nb[, H]); each row ``s`` takes chunk
    ``s // block``'s scale.  One fp32 multiply, then the cast to ``dtype``."""
    s = q.shape[2]
    rows = scale.float().repeat_interleave(block, dim=2)[:, :, :s]
    rows = rows.reshape(rows.shape + (1,) * (q.ndim - rows.ndim))
    return (q.float() * rows).to(dtype)
