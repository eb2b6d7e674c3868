"""ctypes binding of ``csrc/extend_attention.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "extend_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_extend_attention",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the built (q·k width, v width) pairs (``dispatch_widths`` in the source):
#: equal widths for the GQA layout (192 for ``nemotron-4-340b``), MLA's
#: packed [nope ‖ rope] q·k width against its v width (reduced 16 + 8 / 16,
#: full 128 + 64 / 128)
PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 192), (24, 16), (192, 128))


def extend_attention_cuda(q, k, v, t_real, *, kernel=KERNEL):
    """Launch the kernel: q (B, nb, H, HQK); k (B, T, KV, HQK); v (B, T, KV,
    HV); ``t_real`` a 0-d int32 CUDA tensor.  Returns (B, nb, H, HV) in q's
    dtype, with scores scaled by HQK^-0.5.  ``kernel`` names another build
    of the source (a copy timed by ``extend_turns.py``); the serving path
    takes the default."""
    b, nb, h, hqk = q.shape
    if (k.ndim != 4 or v.ndim != 4 or k.shape[0] != b or k.shape[3] != hqk
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"k must be (B, T, KV, {hqk}) like q's batch and v "
                         f"(B, T, KV, HV) like k; got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    t, kv, hv = k.shape[1], k.shape[2], v.shape[3]
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if (hqk, hv) not in PAIRS:
        raise ValueError(f"head dims (q·k {hqk}, v {hv}) not built; have "
                         f"(q·k, v) pairs {PAIRS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q/k/v must start on a 16-byte boundary (the kernel "
                         "reads them with 16-byte copies)")
    if not (isinstance(t_real, torch.Tensor) and t_real.dtype == torch.int32
            and t_real.numel() == 1 and t_real.device == q.device):
        raise TypeError("t_real must be a one-element int32 tensor on "
                        f"{q.device}")
    out = q.new_empty((b, nb, h, hv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           t_real.data_ptr(), b, nb, h, kv, t, hqk, hv, hqk ** -0.5,
           DTYPES[q.dtype], stream)
    return out
