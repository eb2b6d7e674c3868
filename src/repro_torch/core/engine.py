"""IncrementalAnalyticsEngine — the paper's middle layer, as a library.

Sits between the data backend (RDBMS in 2015; sharded columnar store here)
and the "analytical language layer".  Every model-construction query runs
the optimizer (its cost is negligible — §6.4), executes the winning plan
(reuse vs. baseline), and optionally materializes new models.

A copy of ``repro.core.engine``.  Over a device ``ArrayBackend``
(``repro_torch.data.tabular``) the base table stays on the card and every
statistics pass goes through a Hopper kernel (see
:mod:`repro_torch.core.families`); statistics, plans and solves stay on the
host in float64.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Literal, Optional

from .. import obs
from .cost import CostModel
from .descriptors import Range, coalesce
from .families import get_family
from .optimizer import Plan, baseline_plan, shortest_plan
from .planner import ExecResult, ExecTimings, execute
from .store import ModelStore

MaterializePolicy = Literal["never", "always", "chunks"]


@dataclass
class QueryResult:
    model: Any
    stats: Any
    plan: Plan
    timings: ExecTimings
    used_reuse: bool
    baseline_cost: float
    plan_cost: float
    materialized_ids: list[str] = field(default_factory=list)

    @property
    def total_s(self) -> float:
        return self.timings.total_s


class IncrementalAnalyticsEngine:
    def __init__(
        self,
        backend: Any,
        store: Optional[ModelStore] = None,
        cost_model: Optional[CostModel] = None,
        materialize: MaterializePolicy = "always",
    ) -> None:
        self.backend = backend
        if cost_model is not None:
            self.cost = cost_model
        elif hasattr(backend, "cost_model"):
            self.cost = backend.cost_model()   # backend-calibrated F(n)/C(M)
        else:
            self.cost = CostModel()
        # an engine-owned store evicts with the engine's cost model, so
        # planning and victim selection price F(n)/C(M) identically
        self.store = store if store is not None else ModelStore(cost_model=self.cost)
        self.materialize: MaterializePolicy = materialize
        self.stats = {"queries": 0, "reused": 0, "optimizer_s": 0.0}

    # ------------------------------------------------------------------
    def query(self, family_name: str, rng: Range, *, force_baseline: bool = False,
              **overrides: Any) -> QueryResult:
        with obs.span("analytics.query"):
            return self._query(family_name, rng, force_baseline, overrides)

    def _query(self, family_name: str, rng: Range, force_baseline: bool,
               overrides: dict) -> QueryResult:
        family = get_family(family_name)
        params = {**family.defaults, **overrides}
        if family_name in ("gaussian_nb", "multinomial_nb") and "n_classes" not in overrides:
            params["n_classes"] = getattr(self.backend, "n_classes", params["n_classes"])

        with obs.span("analytics.plan"):
            base = baseline_plan(rng, self.cost)
            plan = shortest_plan(
                self.store.index(family_name),
                rng,
                self.cost,
                self.store.model_bytes(family_name),
                directed=not family.supports_delete,
            )
        self.stats["optimizer_s"] += plan.optimizer_seconds

        use_reuse = (plan.cost < base.cost) and not force_baseline
        chosen = plan if use_reuse else base
        if not use_reuse:
            # keep the measured optimizer overhead attributed to the query
            chosen.optimizer_seconds = plan.optimizer_seconds

        res = execute(
            chosen, family, self.store, self.backend, params,
            materialize_chunks=(self.materialize != "never"),
        )
        if self.materialize == "always" and family.supports_delete:
            mid = self.store.put(family_name, rng, res.stats, meta={"query": True})
            res.materialized_ids.append(mid)

        self.stats["queries"] += 1
        self.stats["reused"] += int(use_reuse and any(s.model_id for s in chosen.steps))
        return QueryResult(
            model=res.model,
            stats=res.stats,
            plan=chosen,
            timings=res.timings,
            used_reuse=use_reuse,
            baseline_cost=base.cost,
            plan_cost=plan.cost,
            materialized_ids=res.materialized_ids,
        )

    # ------------------------------------------------------------------
    def baseline(self, family_name: str, rng: Range, **overrides: Any) -> QueryResult:
        """Build from scratch, no store interaction (the paper's baseline T0)."""
        family = get_family(family_name)
        params = {**family.defaults, **overrides}
        if family_name in ("gaussian_nb", "multinomial_nb") and "n_classes" not in overrides:
            params["n_classes"] = getattr(self.backend, "n_classes", params["n_classes"])
        timings = ExecTimings()
        t0 = time.perf_counter()
        X, y = self.backend.fetch(rng)
        timings.io_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = family.compute_stats(X, y, params)
        timings.compute_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = family.solve(stats, params)
        timings.merge_s = time.perf_counter() - t0
        plan = baseline_plan(rng, self.cost)
        return QueryResult(
            model=model, stats=stats, plan=plan, timings=timings, used_reuse=False,
            baseline_cost=plan.cost, plan_cost=plan.cost,
        )

    # ------------------------------------------------------------------
    def warm(self, family_name: str, ranges: list[Range], **overrides: Any) -> list[str]:
        """Materialize models for given ranges (experiment setup helper)."""
        family = get_family(family_name)
        params = {**family.defaults, **overrides}
        if family_name in ("gaussian_nb", "multinomial_nb") and "n_classes" not in overrides:
            params["n_classes"] = getattr(self.backend, "n_classes", params["n_classes"])
        ids = []
        for rng in ranges:
            X, y = self.backend.fetch(rng)
            stats = family.compute_stats(X, y, params)
            ids.append(self.store.put(family_name, rng, stats, meta={"warm": True}))
        return ids

    def coverage(self, family_name: str) -> float:
        uni = Range(0, self.backend.n_rows)
        return self.store.coverage(family_name, uni)

    # ------------------------------------------------------------------
    # Delta maintenance: the paper's add/delete move, planner-priced.
    def update(self, family_name: str, coverage: list[Range], stats: Any, *,
               add: list[Range] = (), delete: list[Range] = (),
               **overrides: Any) -> "UpdateResult":
        """Maintain a materialized stats object through adds/deletes.

        The incremental core of the source paper: given ``stats`` built
        over ``coverage``, produce the stats (and solved model) for
        ``coverage ∪ add ∖ delete`` *without* rescanning the surviving
        rows — one base scan per delta range plus group
        ``combine``/``uncombine``.  The cost model arbitrates
        (:meth:`CostModel.update_action`): when the deltas outweigh a
        clean rebuild of the new coverage — or the family is monoid-only
        (logreg) and a delete arrives, where uncombine does not exist —
        the engine refits instead.  Either way the result is exact (group
        families' delta stats equal the refit stats up to fp rounding;
        pinned at rtol 1e-6 by ``tests/test_delta_property.py``).

        ``add`` ranges must be disjoint from the current coverage and
        ``delete`` ranges contained in it — a delta over rows the stats
        never saw (or saw twice) would silently corrupt the sums.
        """
        family = get_family(family_name)
        params = {**family.defaults, **overrides}
        if family_name in ("gaussian_nb", "multinomial_nb") and "n_classes" not in overrides:
            params["n_classes"] = getattr(self.backend, "n_classes", params["n_classes"])
        add, delete = list(add), list(delete)
        cov = coalesce(coverage)
        for a in add:
            if any(a.overlaps(c) for c in cov):
                raise ValueError(f"add range {a} overlaps current coverage")
        for d in delete:
            if not any(c.contains(d) for c in cov):
                raise ValueError(f"delete range {d} not within current coverage")
        new_cov = coalesce(cov + add)
        for d in delete:
            new_cov = [p for r in new_cov for p in r.difference(d)]

        delta_points = [r.size for r in add + delete]
        refit_points = [r.size for r in new_cov]
        action = self.cost.update_action(
            delta_points, refit_points,
            supports_delete=family.supports_delete, deleting=bool(delete))
        delta_cost = (self.cost.delta_update_s(delta_points)
                      if family.supports_delete or not delete else float("inf"))
        refit_cost = (sum(self.cost.fetch_points(n) for n in refit_points)
                      + self.cost.merge(len(refit_points)))

        timings = ExecTimings()
        if action == "delta":
            new_stats = stats
            for rng, sign in [(r, +1) for r in add] + [(r, -1) for r in delete]:
                t0 = time.perf_counter()
                X, y = self.backend.fetch(rng)
                timings.io_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                d = family.compute_stats(X, y, params)
                timings.compute_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                new_stats = new_stats + d if sign > 0 else new_stats - d
                timings.merge_s += time.perf_counter() - t0
        else:
            new_stats = None
            for rng in new_cov:
                t0 = time.perf_counter()
                X, y = self.backend.fetch(rng)
                timings.io_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                d = family.compute_stats(X, y, params)
                timings.compute_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                new_stats = d if new_stats is None else new_stats + d
                timings.merge_s += time.perf_counter() - t0
            if new_stats is None:
                raise ValueError("update would leave empty coverage")
        t0 = time.perf_counter()
        model = family.solve(new_stats, params)
        timings.merge_s += time.perf_counter() - t0

        materialized: list[str] = []
        if (self.materialize == "always" and family.supports_delete
                and len(new_cov) == 1):
            materialized.append(self.store.put(
                family_name, new_cov[0], new_stats, meta={"update": True}))
        return UpdateResult(
            model=model, stats=new_stats, coverage=new_cov, action=action,
            delta_cost_s=delta_cost, refit_cost_s=refit_cost,
            timings=timings, materialized_ids=materialized)

    def add_data(self, family_name: str, coverage: list[Range], stats: Any,
                 rng: Range, **overrides: Any) -> "UpdateResult":
        """Fold newly arrived rows ``rng`` into a materialized model."""
        return self.update(family_name, coverage, stats, add=[rng], **overrides)

    def delete_data(self, family_name: str, coverage: list[Range], stats: Any,
                    rng: Range, **overrides: Any) -> "UpdateResult":
        """Retract rows ``rng`` from a materialized model (uncombine)."""
        return self.update(family_name, coverage, stats, delete=[rng],
                           **overrides)


@dataclass
class UpdateResult:
    """Outcome of one delta-maintenance call (see ``update``)."""

    model: Any
    stats: Any
    coverage: list[Range]       # the stats' post-update coverage, coalesced
    action: str                 # "delta" | "refit" (the cost model's call)
    delta_cost_s: float
    refit_cost_s: float
    timings: ExecTimings
    materialized_ids: list[str] = field(default_factory=list)
