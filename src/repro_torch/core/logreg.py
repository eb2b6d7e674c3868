"""Incremental logistic regression via mixture weights (§2.3, §4).

The paper approximates SGD-on-the-whole-range by the Mixture Weight Method
(Mann et al., 2009): split the range into chunks of size ``l``, run a single
SGD pass per chunk (embarrassingly parallel — Alg 1's outer loop), and
average the chunk weights (Alg 2).  Chunk models are the materialized unit;
combining is exact *for the mixture*, deleting is not supported.

``mixture_bound`` computes the Theorem-1 deviation bound
``‖w_μ − w_SGD‖ ≤ (R√2/λ)(1/√l + 1/√|Dq|) + (2√2 R)/(λ√(p l)) · √log(1/δ)``.

Mirrors ``repro.core.logreg``.  ``sgd_pass`` follows the data: numpy
arrays take the float64 host loop, tensors the chunked SGD kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import to_host
from repro_torch.kernels.logreg_sgd import ops as k_ops

from .suffstats import LogRegMixtureStats


def _sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


@dataclass
class LogRegModel:
    stats: LogRegMixtureStats
    weights: np.ndarray  # (d+1,) bias last
    lam: float

    def decision(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        return X @ self.weights[:-1] + self.weights[-1]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return _sigmoid(self.decision(X))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.decision(X) >= 0.0).astype(np.int64)

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(y)).mean())


def sgd_pass(
    X,
    y,
    lam: float = 1e-3,
    lr: float = 0.5,
    batch: int = 64,
    w0: np.ndarray | None = None,
    *,
    seed: int = 0,
) -> np.ndarray:
    """One SGD epoch (the paper: "SGD requires a single pass to converge").

    Vectorized minibatch updates; ``lr/√t`` decay.  Returns (d+1,) weights
    with the bias folded in as the last coordinate.  A tensor chunk runs
    the chunked SGD kernel (fp32, from zero weights, as ``repro``'s kernel
    path: ``w0`` applies to the host loop only).
    """
    if isinstance(X, torch.Tensor):
        (w,) = to_host(k_ops.logreg_sgd(X, y, lam=lam, lr=lr, batch=batch))
        return w
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n, d = X.shape
    w = np.zeros(d + 1) if w0 is None else np.asarray(w0, np.float64).copy()
    t = 0
    for s in range(0, n, batch):
        xb = X[s : s + batch]
        yb = y[s : s + batch]
        t += 1
        z = xb @ w[:-1] + w[-1]
        g = _sigmoid(z) - yb                       # (m,)
        step = lr / math.sqrt(t)
        gw = xb.T @ g / len(yb) + 2.0 * lam * w[:-1]
        gb = g.mean()
        w[:-1] -= step * gw
        w[-1] -= step * gb
    return w


def fit_chunk(X, y, lam: float = 1e-3, lr: float = 0.5) -> LogRegMixtureStats:
    """Materialize one chunk model (Alg 2 line 11)."""
    w = sgd_pass(X, y, lam=lam, lr=lr)
    return LogRegMixtureStats.from_chunk_weights(w, n_points=len(y))


def solve(stats: LogRegMixtureStats, lam: float = 1e-3) -> LogRegModel:
    """Average chunk weights → mixture model (Alg 2 line 12)."""
    return LogRegModel(stats=stats, weights=stats.weights, lam=lam)


def fit_direct(X, y, lam: float = 1e-3, lr: float = 0.5) -> LogRegModel:
    """The paper's accuracy baseline: plain SGD over the whole range."""
    w = sgd_pass(X, y, lam=lam, lr=lr)
    stats = LogRegMixtureStats.from_chunk_weights(w, n_points=len(y))
    return LogRegModel(stats=stats, weights=w, lam=lam)


def mixture_bound(
    R: float, lam: float, chunk_size: int, query_size: int, n_chunks: int, delta: float = 0.05
) -> float:
    """Theorem 1 upper bound on ``‖w_μ − w_SGD‖`` (probability ≥ 1−δ)."""
    if min(chunk_size, query_size, n_chunks) <= 0:
        raise ValueError("sizes must be positive")
    t1 = (R * math.sqrt(2.0) / lam) * (1.0 / math.sqrt(chunk_size) + 1.0 / math.sqrt(query_size))
    t2 = (2.0 * math.sqrt(2.0) * R) / (lam * math.sqrt(n_chunks * chunk_size)) * math.sqrt(
        math.log(1.0 / delta)
    )
    return t1 + t2
