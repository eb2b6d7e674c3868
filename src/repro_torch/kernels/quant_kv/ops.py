"""Public wrappers for the int8 KV dequantization kernel.

``dequantize_leaves`` turns the stored int8 cache leaves of one segment
(document axis at 2, bucketed layout) back into model precision in one
launch; ``dequantize_leaf`` is its one-leaf case.  ``repro``'s wrapper pads,
transposes and reshapes each leaf to the TPU kernel's ``(G, rows, cols)``
block layout and slices and casts the result; the CUDA kernel reads the
leaves and their scales in place and writes the model dtype, so nothing
here moves data.  ``dequantize_blocks`` keeps the TPU kernel's own
interface.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, uses_kernel

from .kernel import MAX_LEAVES, dequant_cuda, segment_layout
from .ref import dequant_blocks_ref, dequantize_leaf_ref


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the JAX package's dtype name for one."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def _one(values, n: int, what: str):
    """The single value of one value per leaf, which must all agree (one
    launch takes one block size and one output dtype)."""
    if len(values) != n or len(set(values)) != 1:
        raise ValueError(f"a segment's leaves take one {what}; got {list(values)}")
    return values[0]


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def dequant_blocks_work(q, scales) -> tuple:
    """(FLOPs, bytes) of one call: no product (0 FLOPs, as the plain
    version's count); q and scales read once, the fp32 output written once."""
    return 0, _nbytes(q, scales) + q.numel() * 4


def dequantize_blocks(q, scales):
    """``q (G, rows, cols)`` int8 × ``scales (G,)`` → fp32."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("quant_kv", dequant_blocks_work, _dequantize_blocks, q, scales)
    return _dequantize_blocks(q, scales)


def _dequantize_blocks(q, scales):
    if not uses_kernel(q):
        return dequant_blocks_ref(q, scales)
    g, rows, cols = q.shape
    return dequant_cuda([(q, scales, (g, rows, 1, cols, 1))], block=rows,
                        dtype=torch.float32)[0]


def dequantize_leaves(leaves, *, block, dtype) -> list:
    """Dequantize the stored int8 cache leaves of one segment, in one launch.

    ``leaves`` is ``[(q, scale), …]``, at most :data:`MAX_LEAVES`, where
    ``scale`` is the per-block scale tensor ``quantize_leaf`` produced:
    ``(d0, d1, nb[, heads])`` for ``nb`` seq chunks of ``block`` rows.
    ``block`` and ``dtype`` are one value, or one per leaf that all agree;
    mixed ones are refused.
    """
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("quant_kv", dequant_leaves_work, _dequantize_leaves, leaves,
                              block=block, dtype=dtype)
    return _dequantize_leaves(leaves, block=block, dtype=dtype)


def dequant_leaves_work(leaves, *, block, dtype) -> tuple:
    """(FLOPs, bytes) of one call: 0 FLOPs; every leaf and scale read once,
    every output written once in ``dtype`` (one value per leaf: the
    first)."""
    if isinstance(dtype, (list, tuple)):
        dtype = dtype[0]
    size = _torch_dtype(dtype).itemsize
    return 0, sum(_nbytes(q, s) + q.numel() * size for q, s in leaves)


def _dequantize_leaves(leaves, *, block, dtype) -> list:
    if not 0 < len(leaves) <= MAX_LEAVES:
        raise ValueError(f"a segment call takes 1 to {MAX_LEAVES} leaves; got "
                         f"{len(leaves)}")
    if isinstance(block, (list, tuple)):
        block = _one(block, len(leaves), "block size")
    if isinstance(dtype, (list, tuple)):
        dtype = _one([_torch_dtype(d) for d in dtype], len(leaves), "output dtype")
    dtype = _torch_dtype(dtype)
    if not uses_kernel(leaves[0][0]):
        return [dequantize_leaf_ref(q, s, block=block, dtype=dtype) for q, s in leaves]
    return dequant_cuda([(q, s, segment_layout(q.shape, s.shape[2], block))
                         for q, s in leaves], block=block, dtype=dtype)


def dequantize_leaf(q, scale, *, block: int, dtype):
    """Dequantize one stored int8 cache leaf back to ``dtype``: the one-leaf
    case of :func:`dequantize_leaves`."""
    return dequantize_leaves([(q, scale)], block=block, dtype=dtype)[0]
