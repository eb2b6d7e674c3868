"""ctypes binding of ``csrc/logreg_sgd.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import cdiv, current_stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "logreg_sgd.cu"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_logreg_sgd",
                    [_P, _P, _I, _P, _L, _I, _I, _I, _I, _F, _F, _P])
#: shared memory a block may hold (the card's 227 KB, less room for the
#: block form's static words)
SMEM_LIMIT_BYTES = 227 * 1024 - 1024
INT32_MAX = 2**31 - 1
MAX_PARTS = 8             # block form: row parts of the gradient sum
WARP_MAX_D = 32           # warp form: widest row (a lane keeps w in registers)
STAGES = 4                # warp form: minibatches in each warp's ring
LABELS = {torch.int32: 1, torch.float32: 0}   # label dtypes read in place


def warp_ring_bytes(d: int, batch: int) -> int:
    """One warp's ring: STAGES minibatches, each its rows (at a stride of d
    words, d + 1 when d is a multiple of 4, so reads hit distinct banks) and
    its labels."""
    return 4 * STAGES * batch * (d + (d % 4 == 0) + 1)


def block_smem_bytes(d: int, batch: int) -> int:
    """The block form's dynamic shared memory: w, two minibatch buffers (rows
    padded to an odd stride), their labels, g and the gradient parts."""
    return 4 * (d + 2 * batch * (d | 1) + 3 * batch + MAX_PARTS * d)


def warp_form(d: int, batch: int) -> bool:
    """Whether the kernel runs its warp form (one warp per chunk, w in
    registers) or its block form for this shape: the one place that
    decides, from (d, batch) alone."""
    return (d <= WARP_MAX_D and batch % 32 == 0
            and warp_ring_bytes(d, batch) <= SMEM_LIMIT_BYTES)


def smem_bytes(d: int, batch: int) -> int:
    """Shared memory one chunk needs in the form its shape takes."""
    return warp_ring_bytes(d, batch) if warp_form(d, batch) else block_smem_bytes(d, batch)


def check_chunk(l: int, d: int, batch: int) -> None:
    """Raise ``ValueError`` for a chunk the kernel cannot run: its form's
    minibatch buffers must fit one block's shared memory, and a chunk's
    offsets are 32-bit (``l·d`` ≤ 2³¹ − 1).  This replaces ``repro``'s TPU
    VMEM budget: chunks that fit there but not here (or the reverse) are a
    documented difference between the two."""
    smem = smem_bytes(d, batch)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"batch {batch} x d {d} needs {smem} bytes of shared memory; the "
            f"kernel holds at most {SMEM_LIMIT_BYTES} (shrink batch or d)")
    if l * d > INT32_MAX:
        raise ValueError(f"chunk {l}x{d} exceeds 32-bit indexing; shrink chunk_size")


def sgd_segment_cuda(X: torch.Tensor, y: torch.Tensor, *, chunk_size: int,
                     lam: float, lr: float, batch: int,
                     kernel: CudaKernel = KERNEL) -> torch.Tensor:
    """Launch the kernel: X (n, d) fp32 and y (n,) int32 or fp32, contiguous
    on one CUDA device.  Returns the ⌈n / chunk_size⌉ chunks' weights,
    (p, d+1) fp32, bias last.  Per call: one allocation (the output) and
    one launch.  ``kernel`` names another build of the source (the variants
    that :mod:`.turns` times); the analytics path takes the default."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X must be (n, d) and y (n,); got {tuple(X.shape)}, "
                         f"{tuple(y.shape)}")
    n, d = X.shape
    if min(n, d, chunk_size, batch) <= 0:
        raise ValueError(f"need n, d, chunk_size, batch > 0; got {n}, {d}, "
                         f"{chunk_size}, {batch}")
    check_chunk(chunk_size, d, batch)
    y_int = LABELS.get(y.dtype)
    if X.dtype != torch.float32 or y_int is None:
        raise TypeError(f"X must be float32 and y int32 or float32; got "
                        f"{X.dtype}, {y.dtype}")
    index = X.get_device()
    if y.get_device() != index or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    out = torch.empty((cdiv(n, chunk_size), d + 1), dtype=torch.float32, device=X.device)
    kernel(X.data_ptr(), y.data_ptr(), y_int, out.data_ptr(), n, d, chunk_size,
           batch, int(warp_form(d, batch)), lam, lr, current_stream(index))
    return out
