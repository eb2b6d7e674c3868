"""Public wrappers for the int8 KV dequantization kernel.

``dequantize_leaf`` turns one stored int8 cache leaf (document axis at 2,
bucketed layout) back into model precision.  ``repro``'s wrapper pads,
transposes and reshapes the leaf to the TPU kernel's ``(G, rows, cols)``
block layout and slices and casts the result; the CUDA kernel reads the
leaf and its scales in place and writes the model dtype, so nothing here
moves data.  ``dequantize_blocks`` keeps the TPU kernel's own interface.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel

from .kernel import dequant_cuda, leaf_layout
from .ref import dequant_blocks_ref, dequantize_leaf_ref


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the JAX package's dtype name for one."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def dequantize_blocks(q, scales):
    """``q (G, rows, cols)`` int8 × ``scales (G,)`` → fp32."""
    if not uses_kernel(q):
        return dequant_blocks_ref(q, scales)
    g, rows, cols = q.shape
    return dequant_cuda(q, scales, d01=g, S=rows, H=1, cols=cols, nb=1,
                        block=rows, dtype=torch.float32)


def dequantize_leaf(q, scale, *, block: int, dtype):
    """Dequantize one stored int8 cache leaf back to ``dtype``.

    ``scale`` is the per-block scale tensor ``quantize_leaf`` produced:
    ``(d0, d1, nb[, heads])`` for ``nb`` seq chunks of ``block`` rows.
    """
    dtype = _torch_dtype(dtype)
    if not uses_kernel(q):
        return dequantize_leaf_ref(q, scale, block=block, dtype=dtype)
    nb = scale.shape[2]
    d01, s, h, cols = leaf_layout(tuple(q.shape), nb, block)
    return dequant_cuda(q, scale, d01=d01, S=s, H=h, cols=cols, nb=nb,
                        block=block, dtype=dtype)
