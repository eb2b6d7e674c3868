"""ctypes binding of ``csrc/nb_stats.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import StreamWorkspace, cdiv, current_stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "nb_stats.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_nb_stats",
                    [_P, _P, _P, _L, _P, _L, _I, _I, _I, _L, _I, _P])
COLS = 64                 # wide form: feature columns per block (the kernel's CW)
MAX_CLASSES = 64
NARROW_SUMS = 64          # narrow form: a thread's register sums, C·(2d+1), at most
NARROW_MAX_D = 16
NARROW_MAX_C = 4
SPLIT_ROWS = 256          # fewest rows a block walks
SMS = 132                 # the H100's SMs: the narrow form's split count
NARROW_BLOCK_ROWS = 8192  # rows a narrow block walks before splits pass SMS
MAX_NARROW_SPLITS = 264   # two blocks on each SM (the kernel's own bound)
MAX_WIDE_BLOCKS = 264     # wide form: row splits x column tiles, at most
WIDE_PARTIALS = 1 << 18   # wide form: partial floats the last block sums, at most
TICKET_FLOATS = 4         # the workspace's head: the ticket
#: partials and ticket, one buffer per (device, stream)
WORKSPACE = StreamWorkspace()


def narrow(n_classes: int, d: int) -> bool:
    """Whether the kernel runs its register form (a thread's class sums in
    registers, one launch over staged row spans) or its wide form (class
    sums in shared memory, column tiles) for this shape: the one place that
    decides."""
    return (n_classes <= NARROW_MAX_C and d <= NARROW_MAX_D
            and n_classes * (2 * d + 1) <= NARROW_SUMS)


def splits_for(n: int, d: int, n_classes: int = 2) -> tuple[int, int]:
    """``(splits, rows_per_split)``: a function of the shape alone, so the
    reduction order, and with it every bit of the result, is too.  The
    narrow form gives each SM one block from 132 x 256 rows up (the
    analytics query's 50K rows take 132 splits of 379), more once a block
    would walk 8192 rows, and at most 264 (5M rows); the wide form keeps
    splits x tiles within 264 blocks and the partials within what one last
    block sums quickly."""
    if narrow(n_classes, d):
        wanted = max(SMS, min(cdiv(n, NARROW_BLOCK_ROWS), MAX_NARROW_SPLITS))
    else:
        wanted = min(MAX_WIDE_BLOCKS // cdiv(d, COLS),
                     WIDE_PARTIALS // (n_classes * (1 + 2 * d)))
    splits = max(1, min(cdiv(n, SPLIT_ROWS), wanted))
    rows = cdiv(n, splits)
    return cdiv(n, rows), rows


@functools.lru_cache(maxsize=1024)
def plan(n: int, d: int, n_classes: int) -> tuple[int, int, int, int]:
    """``(splits, rows_per_split, narrow, workspace floats)`` for a shape:
    the ticket, then one partial of C·(1+2d) sums per split."""
    splits, rows = splits_for(n, d, n_classes)
    return (splits, rows, int(narrow(n_classes, d)),
            TICKET_FLOATS + n_classes * (1 + 2 * d) * splits)


def grouped_stats_cuda(X: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Launch the kernel: X (n, d) fp32 and y (n,) int32, contiguous on one
    CUDA device.  Returns G (C, 1 + 2d) fp32: ``[N_c | S_c | SS_c]``.  Per
    call: one allocation (the output) and one launch."""
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
    index = X.get_device()
    if y.get_device() != index or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    splits, rows, is_narrow, floats = plan(n, d, n_classes)
    out = torch.empty((n_classes, 1 + 2 * d), dtype=torch.float32, device=X.device)
    stream = current_stream(index)
    ws = WORKSPACE.get(index, stream, floats)
    KERNEL(X.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), out.data_ptr(),
           n, d, n_classes, splits, rows, is_narrow, stream)
    return out
