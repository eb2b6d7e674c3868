"""Public wrappers for the chunked SGD kernel (segment, batched, one chunk).

``repro``'s wrapper pads each chunk to a batch multiple (masked) and the
features to 128 lanes, and fits one chunk per call; the CUDA kernel reads
a whole segment in place (X fp32, labels int32 or fp32 as they are), fits
all its chunks in one launch and stops each chunk's last minibatch at the
chunk's end, which adds and counts the same rows.  The plain version keeps
the reference's padding and mask.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import WORK, round_up, uses_kernel

from .kernel import LABELS, check_chunk, sgd_segment_cuda
from .ref import sgd_segment_ref


def logreg_sgd_segment(X, y, *, chunk_size: int, lam: float = 1e-3, lr: float = 0.5,
                       batch: int = 64):
    """One SGD epoch per chunk of a segment X (n, d), y (n,): chunk c is rows
    ``[c·l, min((c+1)·l, n))`` with l = ``chunk_size``, and a short last
    chunk runs its own ⌈m/batch⌉ steps.  Returns (⌈n/l⌉, d+1) fp32
    weights, bias last."""
    counter = getattr(WORK, "counter", None)
    if counter is not None:
        return counter.kernel("logreg_sgd", segment_work, _segment, X, y,
                              chunk_size=chunk_size, lam=lam, lr=lr, batch=batch)
    return _segment(X, y, chunk_size=chunk_size, lam=lam, lr=lr, batch=batch)


def segment_work(X, y, *, chunk_size: int, batch: int = 64, **_) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: the plain version's two products
    per minibatch step (the logits and the weight gradient, 2·batch·d
    each), over every chunk's rows padded to a batch multiple; bytes: X and
    y read once, the (chunks, d+1) fp32 weights written once."""
    n, d = X.shape
    full, rest = divmod(n, chunk_size)
    rows = full * round_up(chunk_size, batch) + round_up(rest, batch)
    chunks = full + (rest > 0)
    return 4 * rows * d, (n * d * 4 + y.numel() * 4 + chunks * (d + 1) * 4)


def _segment(X, y, *, chunk_size: int, lam: float, lr: float, batch: int):
    check_chunk(chunk_size, X.shape[1], batch)
    X = X.to(torch.float32)
    if y.dtype not in LABELS:
        y = y.to(torch.float32)
    if uses_kernel(X):
        return sgd_segment_cuda(X.contiguous(), y.contiguous(), chunk_size=chunk_size,
                                lam=lam, lr=lr, batch=batch)
    return sgd_segment_ref(X, y, chunk_size=chunk_size, lam=lam, lr=lr, batch=batch)


def logreg_sgd(X, y, *, lam: float = 1e-3, lr: float = 0.5, batch: int = 64):
    """One SGD epoch over one chunk (l, d) → (d+1,) weights, bias last."""
    return logreg_sgd_segment(X, y, chunk_size=X.shape[0], lam=lam, lr=lr,
                              batch=batch)[0]


def logreg_sgd_batched(X, y, *, lam: float = 1e-3, lr: float = 0.5, batch: int = 64):
    """(p, l, d), (p, l) → per-chunk weights (p, d) and bias (p, 1): the p
    chunks as one segment of p·l rows."""
    p, l, d = X.shape
    out = logreg_sgd_segment(X.reshape(p * l, d), y.reshape(p * l), chunk_size=l,
                             lam=lam, lr=lr, batch=batch)
    return out[:, :d], out[:, d:]
