"""ctypes binding of ``csrc/quant_kv.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import current_stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_kv.cu"
_I = ctypes.c_int
#: the kernel; ``KERNEL.launches`` counts launches (one per segment)
KERNEL = CudaKernel(SOURCE, "repro_quant_kv",
                    [ctypes.c_char_p, _I, _I, _I, ctypes.c_void_p])
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: leaves one launch takes (the kernel's parameter struct)
MAX_LEAVES = 8
#: int64 words of one leaf's descriptor: q, scales, out, d01, S, H, cols, nb
LEAF_WORDS = 8
#: a leaf's output starts this many elements after the previous one's, at
#: least: 16-byte aligned in fp32 and bf16
OUT_ALIGN = 16
#: items (16-element vectors, or elements) of one leaf, at most: the kernel
#: indexes a leaf in 32 bits
MAX_ITEMS = 2**31 - 1


def leaf_layout(shape: tuple, nb: int, block: int) -> tuple[int, int, int, int]:
    """``(d01, S, H, cols)`` of a stored leaf (document axis at 2): rank ≥ 5
    leaves carry a head axis at 3 and one scale per (d0, d1, chunk, head);
    lower ranks one scale per (d0, d1, chunk)."""
    if len(shape) < 3:
        raise ValueError(f"a SEQ leaf has rank ≥ 3; got shape {shape}")
    d01, s, post = shape[0] * shape[1], shape[2], shape[3:]
    if s > nb * block:
        raise ValueError(f"{s} rows exceed {nb} chunks of {block}")
    if len(post) >= 2:
        return d01, s, post[0], math.prod(post[1:])
    return d01, s, 1, math.prod(post)


@functools.lru_cache(maxsize=1024)
def segment_layout(shape: tuple, nb: int, block: int) -> tuple[int, int, int, int, int]:
    """``(d01, S, H, cols, nb)``: :func:`leaf_layout` and the leaf's chunk
    count, the kernel's view of one leaf, cached by shape."""
    return leaf_layout(tuple(shape), nb, block) + (nb,)


@functools.lru_cache(maxsize=256)
def out_views(shapes: tuple) -> tuple[int, tuple]:
    """The segment's one output allocation for leaves of these shapes: its
    size in elements, and ``(shape, strides, offset)`` of each leaf's view,
    every offset a multiple of :data:`OUT_ALIGN` elements."""
    views, total = [], 0
    for sh in shapes:
        strides = [1] * len(sh)
        for i in range(len(sh) - 2, -1, -1):
            strides[i] = strides[i + 1] * sh[i + 1]
        views.append((sh, tuple(strides), total))
        total += -(-math.prod(sh) // OUT_ALIGN) * OUT_ALIGN
    return total, tuple(views)


def segment_table(leaves) -> bytes:
    """The kernel's descriptor table for one segment: per leaf ``(q,
    scales, out pointer, (d01, S, H, cols, nb))``, the q, scales and out
    pointers, then the layout, as int64 words."""
    words = []
    for q, s, out_ptr, layout in leaves:
        words += (q.data_ptr(), s.data_ptr(), out_ptr, *layout)
    return struct.pack(f"<{len(words)}q", *words)


def check_leaf(q: torch.Tensor, scales: torch.Tensor, layout, device) -> None:
    """What the kernel needs of one leaf: int8 codes and fp32 scales of the
    layout's sizes, contiguous on ``device``, q on a 16-byte boundary."""
    d01, S, H, cols, nb = layout
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scales float32; got {q.dtype}, "
                        f"{scales.dtype}")
    if q.numel() != d01 * S * H * cols or scales.numel() != d01 * nb * H:
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not match (d01 {d01}, S {S}, H {H}, cols {cols}, nb {nb})")
    if q.device != device or scales.device != device or not (
            q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"q and scales must be contiguous on {device}")
    if q.data_ptr() % 16:
        raise ValueError("q and the output must start on a 16-byte boundary "
                         "(the kernel moves them with 16-byte accesses)")
    if d01 * S * H * (cols // 16 if cols % 16 == 0 else cols) > MAX_ITEMS:
        raise ValueError(f"a leaf of {q.numel()} elements exceeds the kernel's "
                         f"32-bit indexing")


def dequant_cuda(leaves, *, block: int, dtype: torch.dtype) -> list[torch.Tensor]:
    """Launch the kernel once over the leaves of one segment:
    ``[(q, scales, (d01, S, H, cols, nb)), …]``, each q read as (d01, S, H,
    cols) int8 with scales (d01, nb, H) fp32.  Returns one tensor of each
    q's shape in ``dtype`` (fp32 or bf16), views of one allocation.  The
    checks run once per segment, before anything is allocated."""
    code = OUT_DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"output dtype {dtype} not built; have {list(OUT_DTYPES)}")
    if not 0 < len(leaves) <= MAX_LEAVES:
        raise ValueError(f"one launch takes 1 to {MAX_LEAVES} leaves; got {len(leaves)}")
    device = leaves[0][0].device
    for q, s, layout in leaves:
        check_leaf(q, s, layout, device)
    total, views = out_views(tuple(q.shape for q, _, _ in leaves))
    flat = torch.empty(total, dtype=dtype, device=device)
    if total:
        base, size = flat.data_ptr(), flat.element_size()
        table = segment_table([(q, s, base + off * size, layout) for (q, s, layout), (_, _, off)
                               in zip(leaves, views)])
        KERNEL(table, len(leaves), block, code, current_stream(device.index))
    return [flat.as_strided(*view) for view in views]
