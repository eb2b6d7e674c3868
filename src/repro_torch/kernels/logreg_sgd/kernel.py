"""ctypes binding of ``csrc/logreg_sgd.cu`` and its launch counter."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "logreg_sgd.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the kernel; ``KERNEL.launches`` counts launches on the card
KERNEL = CudaKernel(SOURCE, "repro_logreg_sgd",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P])
#: shared memory a block may hold: w, two minibatch buffers, the gradient terms
SMEM_LIMIT_BYTES = 227 * 1024 - 1024
INT32_MAX = 2**31 - 1
MAX_PARTS = 8             # row parts of the kernel's gradient sum


def smem_bytes(d: int, batch: int) -> int:
    """The kernel's dynamic shared memory: w, two minibatch buffers (rows
    padded to an odd stride), their labels, g and the gradient parts."""
    return 4 * (d + 2 * batch * (d | 1) + 3 * batch + MAX_PARTS * d)


def check_chunk(l: int, d: int, batch: int) -> None:
    """Raise ``ValueError`` for a chunk the kernel cannot run: the
    minibatch buffers, w and the gradient terms must fit one block's shared
    memory, and a chunk's offsets are 32-bit (``l·d`` ≤ 2³¹ − 1).  This
    replaces ``repro``'s TPU VMEM budget: chunks that fit there but not here
    (or the reverse) are a documented difference between the two."""
    smem = smem_bytes(d, batch)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"batch {batch} x d {d} needs {smem} bytes of shared memory; the "
            f"kernel holds at most {SMEM_LIMIT_BYTES} (shrink batch or d)")
    if l * d > INT32_MAX:
        raise ValueError(f"chunk {l}x{d} exceeds 32-bit indexing; shrink chunk_size")


def sgd_chunks_cuda(X: torch.Tensor, y: torch.Tensor, *, lam: float, lr: float,
                    batch: int):
    """Launch the kernel: X (p, l, d) and y (p, l) fp32, contiguous on one
    CUDA device.  Returns w (p, d) and b (p, 1), fp32."""
    if X.ndim != 3 or y.shape != X.shape[:2]:
        raise ValueError(f"X must be (p, l, d) and y (p, l); got "
                         f"{tuple(X.shape)}, {tuple(y.shape)}")
    p, l, d = X.shape
    if min(p, l, d, batch) <= 0:
        raise ValueError(f"need p, l, d, batch > 0; got {p}, {l}, {d}, {batch}")
    check_chunk(l, d, batch)
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"X and y must be float32; got {X.dtype}, {y.dtype}")
    if y.device != X.device or not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"X and y must be contiguous on {X.device}")
    w = torch.empty((p, d), dtype=torch.float32, device=X.device)
    b = torch.empty((p, 1), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    KERNEL(X.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), p, l, d,
           batch, lam, lr, stream)
    return w, b
