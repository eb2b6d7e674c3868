"""The paper's own workload configuration (§6 experimental setting).

Not an LM architecture — the paper's "model" is the analytics engine; this
config pins its published experimental parameters so benchmarks and the
analytics driver share one source of truth.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperWorkloadConfig:
    n_points: int = 5_000_000       # base data set (rows)
    dim: int = 10                   # features per point
    n_queries: int = 1_000          # queries per experiment (§6 "query set S")
    query_mean: int = 50_000        # N(50K, 12.5K) query sizes
    query_std: int = 12_500
    model_size_mean: int = 50_000   # materialized-model sizes (same dist)
    model_size_std: int = 12_500
    coverages: tuple = (0.2, 0.4, 0.6, 0.8, 0.9)
    logreg_chunk: int = 10_000      # chunk size l (§4)
    logreg_lam: float = 1e-3
    table1_model_size: int = 5_000  # Table 1 storage experiment
    fig3_model_sizes: tuple = (5_000, 10_000, 20_000, 30_000, 50_000, 70_000)
    fig4_regimes: tuple = (
        ("M1", 25_000, 50_000),
        ("M2", 75_000, 100_000),
        ("M3", 150_000, 200_000),
        ("M4", 250_000, 500_000),
    )


PAPER_WORKLOAD = PaperWorkloadConfig()
