"""Sufficient-statistics algebra — the paper's materialized-model state.

§3.1 of the paper: a materialized model stores, besides its parameters, the
*extra information* that makes it incrementally maintainable.  For every
model family that information forms a commutative **monoid** under "combine"
(§3.3), and for linear regression / Naive Bayes additionally an abelian
**group** (deletions = subtraction, §3.2).  Logistic-regression mixtures
(§4) are combine-only.

Mirrors ``repro.core.suffstats``.  The statistics are plain dataclasses of
float64 numpy arrays on the host (a kernel's small fp32 result is widened
once per pass); combine/uncombine work field by field over
``dataclasses.fields`` where the reference maps over a JAX pytree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, TypeVar

import numpy as np

T = TypeVar("T", bound="Combinable")


def _fieldwise(fn, *objs: T) -> T:
    first = objs[0]
    return type(first)(**{f.name: fn(*(getattr(o, f.name) for o in objs))
                          for f in dataclasses.fields(first)})


def _leaves(obj) -> list:
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


class Combinable:
    """Mixin: combine/uncombine via elementwise field arithmetic."""

    #: whether subtraction (point/model deletion) is exact for this family
    SUPPORTS_DELETE: bool = True

    def combine(self: T, other: T) -> T:
        self._check_compat(other)
        return _fieldwise(lambda x, y: x + y, self, other)

    def uncombine(self: T, other: T) -> T:
        """Remove ``other``'s contribution (group inverse).  §3.2/§3.3."""
        if not self.SUPPORTS_DELETE:
            raise TypeError(f"{type(self).__name__} does not support deletion")
        self._check_compat(other)
        return _fieldwise(lambda x, y: x - y, self, other)

    def __add__(self: T, other: T) -> T:
        return self.combine(other)

    def __sub__(self: T, other: T) -> T:
        return self.uncombine(other)

    def _check_compat(self, other: Any) -> None:
        if type(other) is not type(self):
            raise TypeError(f"cannot combine {type(self).__name__} with {type(other).__name__}")

    # -- misc -------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return sum(np.asarray(x).nbytes for x in _leaves(self))

    def to_numpy(self: T) -> T:
        return _fieldwise(np.asarray, self)

    def allclose(self: T, other: T, rtol: float = 1e-6, atol: float = 1e-8) -> bool:
        la, lb = _leaves(self), _leaves(other)
        return len(la) == len(lb) and all(
            np.allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol) for x, y in zip(la, lb)
        )


@dataclass
class LinRegStats(Combinable):
    """Linear regression sufficient statistics (§3.1.1).

    ``A = XᵀX`` (d×d), ``B = Xᵀy`` (d,), ``n`` point count.  ``d² + d`` extra
    values, independent of n — the paper's headline storage bound.
    """

    n: Any  # scalar
    A: Any  # (d, d)
    B: Any  # (d,)

    SUPPORTS_DELETE = True

    @classmethod
    def zero(cls, d: int, dtype=np.float64) -> "LinRegStats":
        return cls(n=np.zeros((), dtype), A=np.zeros((d, d), dtype), B=np.zeros((d,), dtype))

    @classmethod
    def from_data(cls, X: np.ndarray, y: np.ndarray, dtype=np.float64) -> "LinRegStats":
        X = np.asarray(X, dtype)
        y = np.asarray(y, dtype)
        return cls(n=np.asarray(float(X.shape[0]), dtype), A=X.T @ X, B=X.T @ y)

    @property
    def dim(self) -> int:
        return int(np.asarray(self.B).shape[0])


@dataclass
class GaussianNBStats(Combinable):
    """Gaussian Naive Bayes statistics (§3.1.2): ``N_c``, ``S_jc``, ``SS_jc``."""

    counts: Any  # (C,)   N_c
    S: Any       # (C, d) Σ x_j over class c
    SS: Any      # (C, d) Σ x_j² over class c

    SUPPORTS_DELETE = True

    @classmethod
    def zero(cls, d: int, n_classes: int, dtype=np.float64) -> "GaussianNBStats":
        return cls(
            counts=np.zeros((n_classes,), dtype),
            S=np.zeros((n_classes, d), dtype),
            SS=np.zeros((n_classes, d), dtype),
        )

    @classmethod
    def from_data(cls, X: np.ndarray, y: np.ndarray, n_classes: int, dtype=np.float64) -> "GaussianNBStats":
        X = np.asarray(X, dtype)
        y = np.asarray(y)
        onehot = np.eye(n_classes, dtype=dtype)[y.astype(np.int64)]  # (n, C)
        return cls(counts=onehot.sum(0), S=onehot.T @ X, SS=onehot.T @ (X * X))

    @property
    def dim(self) -> int:
        return int(np.asarray(self.S).shape[1])

    @property
    def n_classes(self) -> int:
        return int(np.asarray(self.counts).shape[0])


@dataclass
class MultinomialNBStats(Combinable):
    """Multinomial NB statistics (§3.1.2): ``N_c`` sample counts and ``N_ci``
    per-class feature-count table (plus derived ``N_c`` token totals)."""

    counts: Any  # (C,)   samples per class
    Nci: Any     # (C, d) Σ x_i over class c

    SUPPORTS_DELETE = True

    @classmethod
    def zero(cls, d: int, n_classes: int, dtype=np.float64) -> "MultinomialNBStats":
        return cls(counts=np.zeros((n_classes,), dtype), Nci=np.zeros((n_classes, d), dtype))

    @classmethod
    def from_data(cls, X, y, n_classes: int, dtype=np.float64) -> "MultinomialNBStats":
        X = np.asarray(X, dtype)
        onehot = np.eye(n_classes, dtype=dtype)[np.asarray(y).astype(np.int64)]
        return cls(counts=onehot.sum(0), Nci=onehot.T @ X)


@dataclass
class LogRegMixtureStats(Combinable):
    """Mixture-weight logistic regression state (§4, Mann et al. 2009).

    A materialized model is a *set of chunk models*; its state is the sum of
    chunk weight vectors plus the chunk count.  Combining two disjoint
    mixtures = adding sums (uniform μ_k).  Deletion is **not** supported —
    the monoid-only case that switches the planner to its DAG variant.
    """

    w_sum: Any      # (d+1,) Σ_k w_k  (bias folded in at index d)
    n_chunks: Any   # scalar p
    n_points: Any   # scalar

    SUPPORTS_DELETE = False

    @classmethod
    def zero(cls, d: int, dtype=np.float64) -> "LogRegMixtureStats":
        return cls(
            w_sum=np.zeros((d + 1,), dtype),
            n_chunks=np.zeros((), dtype),
            n_points=np.zeros((), dtype),
        )

    @classmethod
    def from_chunk_weights(cls, w: np.ndarray, n_points: int) -> "LogRegMixtureStats":
        w = np.asarray(w, np.float64)
        return cls(w_sum=w, n_chunks=np.asarray(1.0), n_points=np.asarray(float(n_points)))

    @property
    def weights(self) -> np.ndarray:
        """Mixture weight vector ``w_μ = (1/p) Σ_k w_k``."""
        p = float(np.asarray(self.n_chunks))
        if p <= 0:
            raise ValueError("empty mixture has no weights")
        return np.asarray(self.w_sum) / p


STATS_FAMILIES = {
    "linreg": LinRegStats,
    "gaussian_nb": GaussianNBStats,
    "multinomial_nb": MultinomialNBStats,
    "logreg": LogRegMixtureStats,
}


def stats_from_fields(family: str, fields: Mapping[str, Any]) -> Combinable:
    """Carry statistics across from another implementation, field by field.

    ``fields`` maps each field name of the family's stats type to an array
    (for example ``vars(stats)`` of the JAX package's object, whose fields
    have the same names); each becomes a float64 numpy array.  Missing or
    extra fields raise, so a renamed field cannot pass silently.
    """
    cls = STATS_FAMILIES[family]
    names = [f.name for f in dataclasses.fields(cls)]
    if set(fields) != set(names):
        raise ValueError(f"{cls.__name__} has fields {names}; got {sorted(fields)}")
    return cls(**{k: np.asarray(fields[k], np.float64) for k in names})
