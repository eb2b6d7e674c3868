"""Plain PyTorch version of the chunked logistic-regression SGD kernel.

Mirrors ``repro``'s oracle (single epoch, minibatch updates, ``lr/√t``
decay) in fp32 over every chunk at once: the kernel must reproduce this
sequence of updates (same order, same math).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis, round_up


def sgd_chunks_ref(X, y, mask, *, lam: float, lr: float, batch: int):
    """One SGD epoch per chunk.  X (p, l, d), y and mask (p, l) with l a
    multiple of ``batch``; ``mask`` marks real rows (padding rows add
    nothing).  Returns w (p, d) and b (p, 1), fp32."""
    X = X.float()
    y = y.float()
    mask = mask.float()
    p, n, d = X.shape
    if n % batch:
        raise ValueError(f"{n} rows are not a multiple of the batch {batch}")
    w = torch.zeros((p, d), dtype=torch.float32, device=X.device)
    b = torch.zeros((p, 1), dtype=torch.float32, device=X.device)
    for t in range(n // batch):
        xb = X[:, t * batch:(t + 1) * batch]
        yb = y[:, t * batch:(t + 1) * batch]
        mb = mask[:, t * batch:(t + 1) * batch]
        z = torch.einsum("pmd,pd->pm", xb, w) + b
        g = (torch.sigmoid(z) - yb) * mb
        denom = torch.clamp(mb.sum(1, keepdim=True), min=1.0)
        step = lr / torch.sqrt(torch.tensor(t, dtype=torch.float32) + 1.0)
        gw = torch.einsum("pmd,pm->pd", xb, g) / denom + 2.0 * lam * w
        gb = g.sum(1, keepdim=True) / denom
        w = w - step * gw
        b = b - step * gb
    return w, b


def sgd_segment_ref(X, y, *, chunk_size: int, lam: float, lr: float, batch: int):
    """One SGD epoch per chunk of a segment X (n, d), y (n,): chunk c is
    rows ``[c·l, min((c+1)·l, n))``.  The full chunks run batched through
    :func:`sgd_chunks_ref`; a short last chunk runs on its own, padded to a
    batch multiple (masked), so it takes its own ⌈m/batch⌉ steps.  Padding
    it to l instead would not do: a fully masked step still applies
    ``2λw`` and advances t.  Returns (p, d+1) fp32, bias last."""
    n, d = X.shape
    l = chunk_size
    full = n // l
    parts = []
    for lo, p, m in ((0, full, l), (full * l, int(n > full * l), n - full * l)):
        if p == 0:
            continue
        mp = round_up(m, batch)
        Xc = X[lo:lo + p * m].float().reshape(p, m, d)
        yc = y[lo:lo + p * m].float().reshape(p, m)
        mask = pad_axis(torch.ones((p, m), device=X.device), 1, mp)
        w, b = sgd_chunks_ref(pad_axis(Xc, 1, mp), pad_axis(yc, 1, mp), mask,
                              lam=lam, lr=lr, batch=batch)
        parts.append(torch.cat([w, b], 1))
    return torch.cat(parts)
