"""ctypes binding of ``csrc/quant_kv.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_kv.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_quant_kv",
                    [_P, _P, _P, _I, _L, _L, _I, _L, _L, _I, _P])
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def dequant_cuda(q: torch.Tensor, scales: torch.Tensor, *, d01: int, S: int,
                 H: int, cols: int, nb: int, block: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Launch the kernel over ``q`` read as (d01, S, H, cols) int8 with
    ``scales`` (d01, nb, H) fp32.  Returns a tensor of ``q``'s shape in
    ``dtype`` (fp32 or bf16)."""
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scales float32; got {q.dtype}, "
                        f"{scales.dtype}")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"output dtype {dtype} not built; have {list(OUT_DTYPES)}")
    if q.numel() != d01 * S * H * cols or scales.numel() != d01 * nb * H:
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not match (d01 {d01}, S {S}, H {H}, cols {cols}, nb {nb})")
    if scales.device != q.device or not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"q and scales must be contiguous on {q.device}")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("q and the output must start on a 16-byte boundary "
                         "(the kernel moves them with 16-byte accesses)")
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL(q.data_ptr(), scales.data_ptr(), out.data_ptr(), OUT_DTYPES[dtype],
           d01, S, H, cols, nb, block, stream)
    return out
