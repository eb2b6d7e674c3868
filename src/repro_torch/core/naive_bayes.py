"""Incremental Naive Bayes — Gaussian and multinomial variants (§2.2, §3.1.2).

Both variants are parameterized entirely by additive count statistics, so
combine/delete are exact (abelian group), mirroring linear regression.

Mirrors ``repro.core.naive_bayes``.  The Gaussian statistics pass follows
the data (numpy: float64 host path; tensors: the grouped-statistics
kernel); the multinomial variant has no kernel and stays on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import to_host
from repro_torch.kernels.nb_stats import ops as k_ops

from .suffstats import GaussianNBStats, MultinomialNBStats

_VAR_FLOOR = 1e-9


@dataclass
class GaussianNBModel:
    stats: GaussianNBStats
    log_prior: np.ndarray  # (C,)
    mu: np.ndarray         # (C, d)
    var: np.ndarray        # (C, d)

    def log_joint(self, X: np.ndarray) -> np.ndarray:
        """(n, C) log P(Y=c) + Σ_j log N(x_j | μ_jc, σ²_jc)."""
        X = np.asarray(X, np.float64)
        # (n, 1, d) vs (1, C, d)
        diff = X[:, None, :] - self.mu[None]
        ll = -0.5 * (np.log(2 * np.pi * self.var)[None] + diff * diff / self.var[None])
        return self.log_prior[None] + ll.sum(-1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.log_joint(X), axis=-1)

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(y)).mean())


@dataclass
class MultinomialNBModel:
    stats: MultinomialNBStats
    log_prior: np.ndarray   # (C,)
    log_theta: np.ndarray   # (C, d)

    def log_joint(self, X: np.ndarray) -> np.ndarray:
        return self.log_prior[None] + np.asarray(X, np.float64) @ self.log_theta.T

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.log_joint(X), axis=-1)

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(y)).mean())


def compute_gaussian_stats(X, y, n_classes: int) -> GaussianNBStats:
    if isinstance(X, torch.Tensor):
        counts, S, SS = to_host(*k_ops.nb_stats(X.float(), y, n_classes))
        return GaussianNBStats(counts=counts, S=S, SS=SS)
    return GaussianNBStats.from_data(X, y, n_classes)


def solve_gaussian(stats: GaussianNBStats) -> GaussianNBModel:
    counts = np.asarray(stats.counts, np.float64)
    S = np.asarray(stats.S, np.float64)
    SS = np.asarray(stats.SS, np.float64)
    n = counts.sum()
    safe = np.maximum(counts, 1.0)[:, None]
    mu = S / safe
    var = np.maximum(SS / safe - mu * mu, _VAR_FLOOR)
    with np.errstate(divide="ignore"):
        log_prior = np.where(counts > 0, np.log(np.maximum(counts, 1e-300) / max(n, 1.0)), -np.inf)
    return GaussianNBModel(stats=stats, log_prior=log_prior, mu=mu, var=var)


def fit_gaussian(X, y, n_classes: int) -> GaussianNBModel:
    return solve_gaussian(compute_gaussian_stats(X, y, n_classes))


def solve_multinomial(stats: MultinomialNBStats) -> MultinomialNBModel:
    counts = np.asarray(stats.counts, np.float64)
    Nci = np.asarray(stats.Nci, np.float64)
    d = Nci.shape[1]
    n = counts.sum()
    # smoothed MLE: θ_ci = (N_ci + 1) / (N_c + d), N_c = Σ_i N_ci  (§2.2)
    Nc_tokens = Nci.sum(axis=1, keepdims=True)
    log_theta = np.log(Nci + 1.0) - np.log(Nc_tokens + d)
    with np.errstate(divide="ignore"):
        log_prior = np.where(counts > 0, np.log(np.maximum(counts, 1e-300) / max(n, 1.0)), -np.inf)
    return MultinomialNBModel(stats=stats, log_prior=log_prior, log_theta=log_theta)


def fit_multinomial(X, y, n_classes: int) -> MultinomialNBModel:
    return solve_multinomial(MultinomialNBStats.from_data(X, y, n_classes))
