"""ctypes binding of ``csrc/linreg_stats.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import cdiv

SOURCE = Path(__file__).resolve().parent / "csrc" / "linreg_stats.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_linreg_stats",
                    [_P, _P, _L, _P, _L, _I, _I, _L, _I, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                 # wide form: output tile edge
NARROW_D = 16             # largest d + 1 of the narrow (register) form
MIN_SPLIT_ROWS = 256      # fewest rows a block walks (wide form)
NARROW_SPLIT_ROWS = 1024  # fewest rows a block walks (narrow form)
MAX_BLOCKS = 1024         # row splits x output tiles, at most (wide form)
MAX_NARROW_SPLITS = 512
MAX_D = 2048


def narrow(d: int) -> bool:
    """Whether the kernel runs its register form (one row per thread) or
    its tiled form for this d: the one place that decides."""
    return d + 1 <= NARROW_D


def splits_for(n: int, d: int) -> tuple[int, int]:
    """``(splits, rows_per_split)``: a function of the shape alone, so the
    reduction order, and with it every bit of the result, is too."""
    if narrow(d):
        splits = max(1, min(cdiv(n, NARROW_SPLIT_ROWS), MAX_NARROW_SPLITS))
    else:
        side = cdiv(d + 1, TILE)
        splits = max(1, min(cdiv(n, MIN_SPLIT_ROWS), MAX_BLOCKS // (side * side)))
    rows = cdiv(n, splits)
    return cdiv(n, rows), rows


def partial_floats(splits: int, d: int) -> int:
    """Scratch the kernel's first pass writes: one upper triangle per split
    (narrow form) or one set of 32 x 32 tiles per split (wide form)."""
    if narrow(d):
        return splits * (d + 1) * (d + 2) // 2
    return splits * cdiv(d + 1, TILE) ** 2 * TILE * TILE


def zt_z_cuda(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: X (n, d) and y (n,), both fp32 or both bf16,
    contiguous on one CUDA device.  Returns ``[X | y]ᵀ[X | y]``, (d+1, d+1)
    fp32."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = X.shape
    if n == 0 or not 0 < d <= MAX_D:
        raise ValueError(f"need n > 0 and 0 < d <= {MAX_D}; got ({n}, {d})")
    if X.dtype not in DTYPES or y.dtype != X.dtype:
        raise TypeError(f"X and y must share one of {list(DTYPES)}; got "
                        f"{X.dtype}, {y.dtype}")
    if y.device != X.device or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    splits, rows = splits_for(n, d)
    partial = torch.empty(partial_floats(splits, d), dtype=torch.float32,
                          device=X.device)
    out = torch.empty((d + 1, d + 1), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    KERNEL(X.data_ptr(), y.data_ptr(), partial.data_ptr(), partial.numel(),
           out.data_ptr(), n, d, splits, rows, int(narrow(d)), DTYPES[X.dtype],
           stream)
    return out
