"""Public wrappers for the chunked SGD kernel (single-chunk and batched).

``repro``'s wrapper pads the chunk to a batch multiple (masked) and the
features to 128 lanes; the CUDA kernel reads the chunk in place and stops
its last minibatch at the chunk's end, which adds and counts the same rows.
The plain version keeps the reference's padding and mask.

Routing: a CUDA tensor launches the kernel, a CPU tensor runs the plain
version (:mod:`.ref`); see :mod:`repro_torch.kernels.common`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis, round_up, uses_kernel

from .kernel import check_chunk, sgd_chunks_cuda
from .ref import sgd_chunks_ref


def logreg_sgd(X, y, *, lam: float = 1e-3, lr: float = 0.5, batch: int = 64):
    """One SGD epoch over one chunk (l, d) → (d+1,) weights, bias last."""
    w, b = logreg_sgd_batched(X[None], y[None], lam=lam, lr=lr, batch=batch)
    return torch.cat([w[0], b[0]])


def logreg_sgd_batched(X, y, *, lam: float = 1e-3, lr: float = 0.5, batch: int = 64):
    """(p, l, d), (p, l) → per-chunk weights (p, d) and bias (p, 1); the
    kernel runs the p chunks as p blocks."""
    X = X.to(torch.float32)
    y = y.to(torch.float32)
    p, l, d = X.shape
    check_chunk(l, d, batch)
    if uses_kernel(X):
        return sgd_chunks_cuda(X.contiguous(), y.contiguous(), lam=lam, lr=lr,
                               batch=batch)
    lp = round_up(l, batch)
    mask = pad_axis(torch.ones((p, l), dtype=torch.float32, device=X.device), 1, lp)
    return sgd_chunks_ref(pad_axis(X, 1, lp), pad_axis(y, 1, lp), mask,
                          lam=lam, lr=lr, batch=batch)
