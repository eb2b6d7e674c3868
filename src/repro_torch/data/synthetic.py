"""Synthetic data with ordered ids (§6 "Data").

The paper uses scikit-learn-style synthesizers with added noise and
inter-feature dependency; we reproduce that: features are drawn from a
random-covariance Gaussian (dependency), targets from a planted linear /
logistic / per-class-Gaussian model plus noise.  Everything is seeded and
chunk-streamable so multi-GB sets can be written without resident memory.

A copy of ``repro.data.synthetic`` (numpy only): both packages make the
same data from the same seed.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _mixing(rng: np.random.Generator, d: int, dependency: float) -> np.ndarray:
    """Feature-mixing matrix: identity blended with a random rotation."""
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (1.0 - dependency) * np.eye(d) + dependency * Q


def make_regression(
    n: int, d: int = 10, noise: float = 0.5, dependency: float = 0.3, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    M = _mixing(rng, d, dependency)
    w = rng.standard_normal(d)
    X = rng.standard_normal((n, d)) @ M
    y = X @ w + noise * rng.standard_normal(n)
    return X.astype(np.float64), y.astype(np.float64)


def make_classification(
    n: int,
    d: int = 10,
    n_classes: int = 2,
    sep: float = 1.5,
    dependency: float = 0.3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    M = _mixing(rng, d, dependency)
    centers = rng.standard_normal((n_classes, d)) * sep
    y = rng.integers(0, n_classes, size=n)
    X = (centers[y] + rng.standard_normal((n, d))) @ M
    return X.astype(np.float64), y.astype(np.int64)


def make_multinomial(
    n: int, d: int = 10, n_classes: int = 2, total_count: int = 50, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Count features for the multinomial NB variant."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.ones(d) * 0.7, size=n_classes)  # (C, d)
    y = rng.integers(0, n_classes, size=n)
    X = np.stack([rng.multinomial(total_count, theta[c]) for c in y])
    return X.astype(np.float64), y.astype(np.int64)


def stream_regression(
    n: int, d: int = 10, chunk: int = 250_000, **kw
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Chunked generator with per-chunk derived seeds (stable under chunk size)."""
    seed = kw.pop("seed", 0)
    rng = np.random.default_rng(seed)
    M = _mixing(rng, d, kw.get("dependency", 0.3))
    w = rng.standard_normal(d)
    noise = kw.get("noise", 0.5)
    done = 0
    while done < n:
        m = min(chunk, n - done)
        crng = np.random.default_rng((seed, 1000 + done))
        X = crng.standard_normal((m, d)) @ M
        y = X @ w + noise * crng.standard_normal(m)
        yield X.astype(np.float64), y.astype(np.float64)
        done += m
