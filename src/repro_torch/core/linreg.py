"""Incremental L2-regularized linear regression (§2.1, §3.1.1, §3.2.1).

The model is fully determined by its sufficient statistics
``A = XᵀX``, ``B = Xᵀy``: parameters solve ``(A + λI) w = B``.  Because the
statistics live in :class:`~repro_torch.core.suffstats.LinRegStats` (an
abelian group), building a model over any id-range reduces to combining /
subtracting materialized statistics plus scanning only *uncovered* data.
The resulting model is **exactly** the from-scratch model (§3.3 Case 1/2).

Mirrors ``repro.core.linreg``.  The statistics pass follows the data (see
:mod:`repro_torch.core.families`): numpy arrays take the float64 host path,
tensors the fused statistics kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import to_host
from repro_torch.kernels.linreg_stats import ops as k_ops

from .suffstats import LinRegStats


@dataclass
class LinRegModel:
    """Solved model: weights + the statistics that regenerate it."""

    stats: LinRegStats
    weights: np.ndarray
    lam: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, self.weights.dtype) @ self.weights

    def sse(self, X: np.ndarray, y: np.ndarray) -> float:
        r = self.predict(X) - np.asarray(y)
        return float(r @ r)

    def r2(self, X: np.ndarray, y: np.ndarray) -> float:
        y = np.asarray(y, np.float64)
        ss_res = self.sse(X, y)
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-30)


def compute_stats(X, y) -> LinRegStats:
    """One pass over raw data → sufficient statistics.

    numpy arrays take the float64 host path (BLAS); tensors go through the
    fused statistics kernel (``kernels/linreg_stats``: the Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor) in fp32.
    """
    if isinstance(X, torch.Tensor):
        A, B = to_host(*k_ops.linreg_stats(X, y))
        return LinRegStats(n=np.asarray(float(X.shape[0]), np.float64), A=A, B=B)
    return LinRegStats.from_data(X, y)


def solve(stats: LinRegStats, lam: float = 1e-3) -> LinRegModel:
    """``w = (XᵀX + λI)⁻¹ Xᵀy`` via Cholesky (SPD by construction)."""
    A = np.asarray(stats.A, np.float64)
    B = np.asarray(stats.B, np.float64)
    d = A.shape[0]
    M = A + lam * np.eye(d)
    try:
        L = np.linalg.cholesky(M)
        w = _cho_solve(L, B)
    except np.linalg.LinAlgError:  # degenerate (e.g. n < d, λ→0): lstsq fallback
        w = np.linalg.lstsq(M, B, rcond=None)[0]
    return LinRegModel(stats=stats, weights=w, lam=lam)


def _cho_solve(L: np.ndarray, b: np.ndarray) -> np.ndarray:
    # two triangular solves; np.linalg.solve is fine at analytics dims (d ≲ 4k)
    z = np.linalg.solve(L, b)
    return np.linalg.solve(L.T, z)


def fit(X, y, lam: float = 1e-3) -> LinRegModel:
    """From-scratch fit (the paper's baseline path)."""
    return solve(compute_stats(X, y), lam)


def add_points(stats: LinRegStats, X: np.ndarray, y: np.ndarray) -> LinRegStats:
    """§3.2.1 incremental insert: ``A' = A + XᵀX``, ``B' = B + Xᵀy``."""
    return stats + LinRegStats.from_data(X, y)


def remove_points(stats: LinRegStats, X: np.ndarray, y: np.ndarray) -> LinRegStats:
    """§3.2.1 incremental delete (group inverse)."""
    return stats - LinRegStats.from_data(X, y)
