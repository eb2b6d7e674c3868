"""ctypes binding of ``csrc/decode_attention.cu`` and its launch counter.

One wrapper call launches the source's two kernels (per-split partials,
then the combine) and counts one launch.  The wrapper allocates the
output and the fp32 partials scratch; the kernels allocate nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import cdiv

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_decode_attention",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192)
MAX_GROUP = 16            # query heads per KV head the kernel accepts
#: positions per split: the source's compile-time ``SPLIT``, which its
#: entry point checks against the value the wrapper passes
SPLIT = 128
#: the combine stages two floats per split in the 48 KB of shared memory a
#: launch gets by default, beside its 16 bytes of static warp maxima
MAX_SPLITS = (48 * 1024 - 16) // 8


def partials_shape(b: int, t: int, kv: int, g: int, hd: int, split: int):
    """Scratch for the per-split partials: (B, KV, ⌈T/split⌉, G, hd + 2)
    fp32 records ``[m, l, acc[0:hd]]``."""
    return (b, kv, cdiv(t, split), g, hd + 2)


def decode_attention_cuda(q, k, v, pos, *, kernel=KERNEL, split=SPLIT):
    """Launch the kernel: q (B, 1, H, hd); k/v (B, T, KV, hd); ``pos`` (B,)
    int32 CUDA tensor.  Returns (B, 1, H, hd) in q's dtype.  ``kernel`` and
    ``split`` name another build of the source (a copy at another split
    length, timed by ``decode_turns.py``); the serving path takes the
    defaults."""
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query position, got {one}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, T, KV, {hd}) like q's batch; "
                         f"got k {tuple(k.shape)}, v {tuple(v.shape)}")
    t, kv = k.shape[1], k.shape[2]
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv} KV heads: groups must "
                         f"divide evenly and hold at most {MAX_GROUP} heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not built; have {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must start on a 16-byte boundary (the kernel "
                         "reads them with 16-byte loads)")
    if pos.dtype != torch.int32 or pos.shape != (b,) or pos.device != q.device \
            or not pos.is_contiguous():
        raise TypeError(f"pos must be a contiguous ({b},) int32 tensor on "
                        f"{q.device}")
    if cdiv(t, split) > MAX_SPLITS:
        raise ValueError(f"capacity {t} exceeds the kernel's "
                         f"{MAX_SPLITS * split} positions")
    out = torch.empty_like(q)
    part = torch.empty(partials_shape(b, t, kv, h // kv, hd, split),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           pos.data_ptr(), part.data_ptr(), split, b, h, kv, t, hd, hd ** -0.5,
           DTYPES[q.dtype], stream)
    return out
