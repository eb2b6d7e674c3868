"""Plain PyTorch version of the chunked logistic-regression SGD kernel.

Mirrors ``repro``'s oracle (single epoch, minibatch updates, ``lr/√t``
decay) in fp32 over every chunk at once: the kernel must reproduce this
sequence of updates (same order, same math).
"""
from __future__ import annotations

import torch


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
