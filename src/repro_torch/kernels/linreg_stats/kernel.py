"""ctypes binding of ``csrc/linreg_stats.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import StreamWorkspace, cdiv, current_stream, round_up

SOURCE = Path(__file__).resolve().parent / "csrc" / "linreg_stats.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_linreg_stats",
                    [_P, _P, _P, _L, _P, _L, _I, _I, _L, _I, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                 # wide form: output tile edge
NARROW_D = 16             # largest d + 1 of the narrow (one-launch) form
MIN_SPLIT_ROWS = 256      # fewest rows a block walks (wide form)
NARROW_SPLIT_ROWS = 256   # fewest rows a block walks (narrow form: one chunk)
SMS = 132                 # the H100's SMs: the narrow form's split count
NARROW_BLOCK_ROWS = 8192  # rows a narrow block walks before splits pass SMS
MAX_BLOCKS = 1024         # row splits x output tiles, at most (wide form)
MAX_NARROW_SPLITS = 264   # two blocks on each SM (the kernel's own bound)
MAX_D = 2048
TICKET_FLOATS = 4         # the workspace's head: the narrow form's ticket
#: partials and ticket, one buffer per (device, stream)
WORKSPACE = StreamWorkspace()


def narrow(d: int) -> bool:
    """Whether the kernel runs its one-launch register form (one row per
    thread) or its tiled form for this d: the one place that decides."""
    return d + 1 <= NARROW_D


def splits_for(n: int, d: int) -> tuple[int, int]:
    """``(splits, rows_per_split)``: a function of the shape alone, so the
    reduction order, and with it every bit of the result, is too.  The
    narrow form gives each SM one block from 132 x 256 rows up (the
    analytics query's 50K rows take 132 splits of 379), more once a block
    would walk 8192 rows, and at most 264 (5M rows), so the last block's
    sum over the splits stays short."""
    if narrow(d):
        wanted = max(SMS, min(cdiv(n, NARROW_BLOCK_ROWS), MAX_NARROW_SPLITS))
        splits = max(1, min(cdiv(n, NARROW_SPLIT_ROWS), wanted))
    else:
        side = cdiv(d + 1, TILE)
        splits = max(1, min(cdiv(n, MIN_SPLIT_ROWS), MAX_BLOCKS // (side * side)))
    rows = cdiv(n, splits)
    return cdiv(n, rows), rows


def partial_floats(splits: int, d: int) -> int:
    """Partials the kernel writes: one upper triangle per split, k-major
    with rows padded to a multiple of 4 splits (narrow form), or one set of
    32 x 32 tiles per split (wide form)."""
    if narrow(d):
        return round_up(splits, 4) * (d + 1) * (d + 2) // 2
    return splits * cdiv(d + 1, TILE) ** 2 * TILE * TILE


@functools.lru_cache(maxsize=1024)
def plan(n: int, d: int) -> tuple[int, int, int, int]:
    """``(splits, rows_per_split, narrow, workspace floats)`` for a shape."""
    splits, rows = splits_for(n, d)
    return splits, rows, int(narrow(d)), TICKET_FLOATS + partial_floats(splits, d)


def zt_z_cuda(X: torch.Tensor, y: torch.Tensor, *, kernel: CudaKernel = KERNEL,
              splits: int | None = None) -> torch.Tensor:
    """Launch the kernel: X (n, d) and y (n,), both fp32 or both bf16,
    contiguous on one CUDA device.  Returns ``[X | y]ᵀ[X | y]``, (d+1, d+1)
    fp32.  Per call: one allocation (the output) and one launch.
    ``kernel`` and ``splits`` name another build of the source and another
    split count (timed by ``linreg_turns.py``); the analytics path takes the
    defaults."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = X.shape
    if n == 0 or not 0 < d <= MAX_D:
        raise ValueError(f"need n > 0 and 0 < d <= {MAX_D}; got ({n}, {d})")
    code = DTYPES.get(X.dtype)
    if code is None or y.dtype != X.dtype:
        raise TypeError(f"X and y must share one of {list(DTYPES)}; got "
                        f"{X.dtype}, {y.dtype}")
    index = X.get_device()
    if y.get_device() != index or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    if splits is None:
        splits, rows, is_narrow, floats = plan(n, d)
    else:
        rows = cdiv(n, splits)
        splits, is_narrow = cdiv(n, rows), int(narrow(d))
        floats = TICKET_FLOATS + partial_floats(splits, d)
    out = torch.empty((d + 1, d + 1), dtype=torch.float32, device=X.device)
    stream = current_stream(index)
    ws = WORKSPACE.get(index, stream, floats)
    kernel(X.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), out.data_ptr(),
           n, d, splits, rows, is_narrow, code, stream)
    return out
