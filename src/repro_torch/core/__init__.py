"""Core of the paper: model materialization + incremental model reuse.

Mirrors ``repro.core``'s exports.

Public API:
  Range, DescriptorIndex            — id-range descriptors (§3.3, Alg 3)
  LinRegStats / GaussianNBStats / MultinomialNBStats / LogRegMixtureStats
                                    — sufficient-statistics algebra (§3.1)
  linreg / naive_bayes / logreg     — fit / solve / incremental ops (§3.2, §4)
  CostModel, shortest_plan          — cost-based planning (§5, Alg 4)
  ModelStore                        — materialized-model store
  IncrementalAnalyticsEngine        — the middle layer tying it together
"""
from . import linreg, logreg, naive_bayes
from .cost import CostModel, calibrate, serve_cost_model
from .descriptors import DescriptorIndex, Range, coalesce, covered_size, subtract_cover
from .engine import IncrementalAnalyticsEngine, QueryResult
from .families import FAMILIES, ModelFamily, get_family
from .optimizer import Plan, PlanStep, baseline_plan, shortest_plan
from .planner import ExecResult, ExecTimings, execute
from .store import ModelStore, StoredModel
from .suffstats import (
    Combinable,
    GaussianNBStats,
    LinRegStats,
    LogRegMixtureStats,
    MultinomialNBStats,
    STATS_FAMILIES,
)

__all__ = [
    "CostModel",
    "Combinable",
    "DescriptorIndex",
    "ExecResult",
    "ExecTimings",
    "FAMILIES",
    "GaussianNBStats",
    "IncrementalAnalyticsEngine",
    "LinRegStats",
    "LogRegMixtureStats",
    "ModelFamily",
    "ModelStore",
    "MultinomialNBStats",
    "Plan",
    "PlanStep",
    "QueryResult",
    "Range",
    "STATS_FAMILIES",
    "StoredModel",
    "baseline_plan",
    "calibrate",
    "coalesce",
    "serve_cost_model",
    "covered_size",
    "execute",
    "get_family",
    "linreg",
    "logreg",
    "naive_bayes",
    "shortest_plan",
    "subtract_cover",
]
