"""Model-family registry: binds each paper model to its stats algebra,
from-data computation, and solver.  The planner/executor are generic over
this interface — adding a new incremental model (the paper's §8 future work)
means registering one more family here.

Mirrors ``repro.core.families``, with one routing rule in place of
``repro``'s ``backend="numpy" | "pallas"`` parameter: **the fetched data
decide the route.**  A numpy fetch takes the float64 host path (``repro``'s
``backend="numpy"``); a tensor fetch takes the kernel route — the
hand-written Hopper kernel for a CUDA tensor, its plain PyTorch version for
a CPU tensor (``repro_torch.kernels.common.uses_kernel``).  The engine over
a device ``ArrayBackend`` therefore reaches the kernels with no flag, and
nothing sends a CUDA tensor to a plain version.  The multinomial variant
has no kernel: its tensor fetches are copied to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from . import linreg, logreg, naive_bayes
from .suffstats import (
    Combinable,
    GaussianNBStats,
    LinRegStats,
    LogRegMixtureStats,
    MultinomialNBStats,
)


@dataclass(frozen=True)
class ModelFamily:
    name: str
    stats_cls: type
    supports_delete: bool
    #: (X, y, params) → Combinable  — one full pass over raw data
    compute_stats: Callable[[Any, Any, dict], Combinable]
    #: (stats, params) → solved model object with .predict etc.
    solve: Callable[[Combinable, dict], Any]
    #: stats bytes estimate for cost model, from (d, params)
    stats_bytes: Callable[[int, dict], int]
    #: default hyper-parameters
    defaults: dict = field(default_factory=dict)
    #: (X, y, params) → one Combinable per chunk of ``params["chunk_size"]``
    #: rows, in row order — for families whose unit of materialization is
    #: the chunk model (§4); None for the families that do not chunk
    fit_chunks: Optional[Callable[[Any, Any, dict], list]] = None


def _linreg_stats(X, y, params):
    return linreg.compute_stats(X, y)


def _gnb_stats(X, y, params):
    return naive_bayes.compute_gaussian_stats(X, y, params["n_classes"])


def _mnb_stats(X, y, params):
    if isinstance(X, torch.Tensor):
        X, y = X.cpu().numpy(), y.cpu().numpy()
    return MultinomialNBStats.from_data(X, y, params["n_classes"])


def _logreg_chunks(X, y, params):
    return logreg.fit_chunks(X, y, int(params.get("chunk_size", 10_000)),
                             lam=params.get("lam", 1e-3), lr=params.get("lr", 0.5))


def _logreg_stats(X, y, params):
    """Fit the whole segment as chunk models of size l, combined (Alg 2)."""
    total = LogRegMixtureStats.zero(X.shape[1])
    for cs in _logreg_chunks(X, y, params):
        total = total + cs
    return total


FAMILIES: dict[str, ModelFamily] = {
    "linreg": ModelFamily(
        name="linreg",
        stats_cls=LinRegStats,
        supports_delete=True,
        compute_stats=_linreg_stats,
        solve=lambda st, p: linreg.solve(st, lam=p.get("lam", 1e-3)),
        stats_bytes=lambda d, p: 8 * (d * d + d + 1),
        defaults={"lam": 1e-3},
    ),
    "gaussian_nb": ModelFamily(
        name="gaussian_nb",
        stats_cls=GaussianNBStats,
        supports_delete=True,
        compute_stats=_gnb_stats,
        solve=lambda st, p: naive_bayes.solve_gaussian(st),
        stats_bytes=lambda d, p: 8 * (p.get("n_classes", 2) * (2 * d + 1)),
        defaults={"n_classes": 2},
    ),
    "multinomial_nb": ModelFamily(
        name="multinomial_nb",
        stats_cls=MultinomialNBStats,
        supports_delete=True,
        compute_stats=_mnb_stats,
        solve=lambda st, p: naive_bayes.solve_multinomial(st),
        stats_bytes=lambda d, p: 8 * (p.get("n_classes", 2) * (d + 1)),
        defaults={"n_classes": 2},
    ),
    "logreg": ModelFamily(
        name="logreg",
        stats_cls=LogRegMixtureStats,
        supports_delete=False,
        compute_stats=_logreg_stats,
        solve=lambda st, p: logreg.solve(st, lam=p.get("lam", 1e-3)),
        stats_bytes=lambda d, p: 8 * (d + 3),
        defaults={"lam": 1e-3, "lr": 0.5, "chunk_size": 10_000},
        fit_chunks=_logreg_chunks,
    ),
}


def get_family(name: str) -> ModelFamily:
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; have {sorted(FAMILIES)}") from None
