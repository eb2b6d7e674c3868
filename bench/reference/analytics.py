"""Plain reference of the paper's three model families over a table's rows.

It reads the rows the benchmark made and the query's range (for logistic
regression also the signed ranges of the program's plan, an output judged
here: the mixture depends on where its chunks start) and imports nothing of
the program.  The reference computes in float64.  ``dtype=torch.bfloat16``
is the control: the same arithmetic on rows, statistics and weights rounded
to bfloat16, the precision below the float32 the tables are served in.

* linear regression: A = XᵀX, B = Xᵀy, w solves (A + λI) w = B (§2.1);
* Gaussian Naive Bayes: per class the count, mean and variance of each
  feature (§2.2);
* logistic regression: the mixture weight method (§4): one SGD epoch per
  chunk of ``chunk`` rows from each range's start (minibatch 64, step
  lr/√t, L2 λ), the chunk weights averaged.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def linreg(X, y, *, lam: float, dtype=F64) -> np.ndarray:
    X = torch.as_tensor(X).to(dtype)
    y = torch.as_tensor(y).to(dtype)
    A = (X.T @ X).double()
    B = (X.T @ y).double()
    return torch.linalg.solve(A + lam * torch.eye(A.shape[0], dtype=F64), B).numpy()


def gaussian_nb(X, y, *, classes: int, dtype=F64) -> dict:
    """Per class: count, mean and variance of each feature."""
    X = torch.as_tensor(X).to(dtype)
    y = torch.as_tensor(y).long()
    out = {"counts": [], "mu": [], "var": []}
    for c in range(classes):
        xc = X[y == c]
        n = xc.shape[0]
        s = xc.sum(0)
        ss = (xc * xc).sum(0)
        mu = (s / max(n, 1)).double()
        out["counts"].append(float(n))
        out["mu"].append(mu.numpy())
        out["var"].append(np.maximum(((ss / max(n, 1)).double() - mu * mu).numpy(), 1e-9))
    return {k: np.asarray(v) for k, v in out.items()}


def sgd_chunks(X, y, *, chunk: int, lam: float, lr: float, batch: int = 64,
               dtype=F64) -> torch.Tensor:
    """One SGD epoch per chunk of (X, y): chunk c is rows [c·chunk,
    min((c+1)·chunk, n)), from zero weights; (chunks, d + 1), bias last."""
    X = torch.as_tensor(X).to(dtype)
    y = torch.as_tensor(y).to(dtype)
    n, d = X.shape
    out = []
    # the full chunks together, a short last chunk on its own
    full = n // chunk
    parts = [(0, full, chunk)] if full else []
    if n > full * chunk:
        parts.append((full * chunk, 1, n - full * chunk))
    for lo, p, m in parts:
        xs = X[lo:lo + p * m].reshape(p, m, d)
        ys = y[lo:lo + p * m].reshape(p, m)
        w = torch.zeros((p, d), dtype=dtype)
        b = torch.zeros((p, 1), dtype=dtype)
        for t, s in enumerate(range(0, m, batch)):
            xb, yb = xs[:, s:s + batch], ys[:, s:s + batch]
            z = torch.einsum("pmd,pd->pm", xb, w) + b
            g = torch.sigmoid(z) - yb
            step = lr / float(np.sqrt(t + 1))
            gw = torch.einsum("pmd,pm->pd", xb, g) / xb.shape[1] + 2.0 * lam * w
            gb = g.mean(1, keepdim=True)
            w = (w - step * gw).to(dtype)
            b = (b - step * gb).to(dtype)
        out.append(torch.cat([w, b], 1).double())
    return torch.cat(out)


def logreg_mixture(X, y, lo: int, ranges, *, chunk: int, lam: float, lr: float,
                   dtype=F64) -> np.ndarray:
    """The mixture over ``ranges`` (absolute row ranges, each chunked from
    its own start); ``X``, ``y`` hold the rows from ``lo`` on."""
    ws = [sgd_chunks(X[a - lo:b - lo], y[a - lo:b - lo], chunk=chunk, lam=lam, lr=lr,
                     dtype=dtype) for a, b in ranges]
    return torch.cat(ws).mean(0).numpy()


def covers_exactly(steps, lo: int, hi: int) -> bool:
    """Do the signed ranges (sign, a, b) sum to the indicator of [lo, hi)?"""
    delta: dict[int, int] = {}
    for sign, a, b in steps:
        delta[a] = delta.get(a, 0) + sign
        delta[b] = delta.get(b, 0) - sign
    return {k: v for k, v in delta.items() if v} == {lo: 1, hi: -1}


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
