"""ctypes binding of ``csrc/mla_decode.cu`` and its launch counter.

One wrapper call launches the source's two kernels (``mla_decode_split``,
the per-split partials, then ``mla_decode_combine``, which merges them and
applies W_uv) and counts one launch.
The wrapper allocates the fp32 output and the partials' scratch with
``torch.empty``; the kernels allocate nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import cdiv, current_stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "mla_decode.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_mla_decode",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: positions per split: the source's compile-time ``SPLIT``, which its
#: entry point checks against the value the wrapper passes
SPLIT = 256
#: the combine's threads a row: they read W_uv's rows in 16-byte pieces
ROW_THREADS = 128


def mla_decode_cuda(q_lat, q_rope, cache_ckv, cache_krope, w_uv, pos, *, scale: float):
    """Launch the kernel: q_lat (B, H, L), q_rope (B, H, R); cache_ckv
    (B, T, L), cache_krope (B, T, R); w_uv (L, H, V), all of one dtype,
    contiguous, on one CUDA device; ``pos`` (B,) int32 there.  Returns
    (B, H, V) fp32.  Checks every operand before it touches the card; the
    entry point refuses a capacity whose splits overflow the combine's
    shared memory (past 200,000 positions at DeepSeek-V2's widths)."""
    ops = (("q_lat", q_lat), ("q_rope", q_rope), ("cache_ckv", cache_ckv),
           ("cache_krope", cache_krope), ("w_uv", w_uv))
    if any(x.ndim != 3 for _, x in ops):
        raise ValueError("q_lat, q_rope, cache_ckv, cache_krope and w_uv must be 3-d")
    b, h, l = q_lat.shape
    r = q_rope.shape[2]
    t = cache_ckv.shape[1]
    v = w_uv.shape[2]
    if q_rope.shape[:2] != (b, h) or cache_ckv.shape != (b, t, l) \
            or cache_krope.shape != (b, t, r) or w_uv.shape[:2] != (l, h):
        raise ValueError(f"want q_lat (B, H, L), q_rope (B, H, R), cache_ckv (B, T, L), "
                         f"cache_krope (B, T, R), w_uv (L, H, V); got "
                         f"{[tuple(x.shape) for _, x in ops]}")
    if q_lat.dtype not in DTYPES or any(x.dtype != q_lat.dtype for _, x in ops):
        raise TypeError(f"q_lat, q_rope, the caches and w_uv must share one of "
                        f"{list(DTYPES)}; got {[x.dtype for _, x in ops]}")
    vec = 16 // q_lat.element_size()
    if l % 8 or r % 8 or v % vec or ROW_THREADS % (v // vec):
        raise ValueError(f"latent and rope widths must be multiples of 8 and the value "
                         f"width a multiple of {vec} dividing {ROW_THREADS * vec} "
                         f"(16-byte rows); got {l}, {r} and {v}")
    for name, x in ops:
        if x.device != cache_ckv.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {cache_ckv.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             f"reads it with 16-byte copies)")
    if pos.dtype != torch.int32 or pos.shape != (b,) or pos.device != cache_ckv.device \
            or not pos.is_contiguous():
        raise TypeError(f"pos must be a contiguous ({b},) int32 tensor on "
                        f"{cache_ckv.device}")
    n_split = cdiv(t, SPLIT)
    dev = cache_ckv.device
    out = torch.empty((b, h, v), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=dev)
    part_o = torch.empty((b, h, n_split, l), dtype=torch.float32, device=dev)
    KERNEL(q_lat.data_ptr(), q_rope.data_ptr(), cache_ckv.data_ptr(), cache_krope.data_ptr(),
           w_uv.data_ptr(), pos.data_ptr(), part_ml.data_ptr(), part_o.data_ptr(),
           out.data_ptr(), SPLIT, b, h, t, l, r, v, scale, DTYPES[q_lat.dtype],
           current_stream(dev.index))
    return out
