"""ctypes binding of ``csrc/nb_stats.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import cdiv

SOURCE = Path(__file__).resolve().parent / "csrc" / "nb_stats.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_nb_stats",
                    [_P, _P, _P, _L, _P, _L, _I, _I, _I, _L, _P])
COLS = 64                 # feature columns per block (the kernel's CW)
MAX_CLASSES = 64
MIN_SPLIT_ROWS = 256      # fewest rows a block walks
MAX_BLOCKS = 1024         # row splits x column tiles, at most


def splits_for(n: int, d: int) -> tuple[int, int]:
    """``(splits, rows_per_split)``, a function of the shape alone (so is
    the reduction order)."""
    splits = max(1, min(cdiv(n, MIN_SPLIT_ROWS), MAX_BLOCKS // cdiv(d, COLS)))
    rows = cdiv(n, splits)
    return cdiv(n, rows), rows


def grouped_stats_cuda(X: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Launch the kernel: X (n, d) fp32 and y (n,) int32, contiguous on one
    CUDA device.  Returns (C, 1 + 2d) fp32: ``[N_c | S_c | SS_c]``."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = X.shape
    if n == 0 or d == 0:
        raise ValueError(f"need n > 0 and d > 0; got ({n}, {d})")
    if not 0 < n_classes <= MAX_CLASSES:
        raise ValueError(f"{n_classes} classes; the kernel takes 1 to {MAX_CLASSES}")
    if X.dtype != torch.float32 or y.dtype != torch.int32:
        raise TypeError(f"X must be float32 and y int32; got {X.dtype}, {y.dtype}")
    if y.device != X.device or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    splits, rows = splits_for(n, d)
    partial = torch.empty(splits * cdiv(d, COLS) * n_classes * (2 * COLS + 1),
                          dtype=torch.float32, device=X.device)
    out = torch.empty((n_classes, 1 + 2 * d), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    KERNEL(X.data_ptr(), y.data_ptr(), partial.data_ptr(), partial.numel(),
           out.data_ptr(), n, d, n_classes, splits, rows, stream)
    return out
