"""Plan execution (Fig 1c) and edit-rebuild planning.

A framework-free copy of ``repro.core.planner``.  ``execute`` turns an
optimizer path into a solved model: group families combine/uncombine
materialized statistics and scan only the base-data segments the plan asks
for; monoid families (logreg) fit chunk models for uncovered segments
(Alg 2 lines 9–11) and may materialize them for future queries.
``plan_edit`` prices serving an edited document (reuse-prefix +
rebuild-suffix).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .cost import CostModel
from .descriptors import DescriptorIndex, Range, covered_size
from .families import ModelFamily
from .optimizer import Plan
from .store import ModelStore


@dataclass
class ExecTimings:
    """Fig 5 decomposition."""

    optimizer_s: float = 0.0
    io_s: float = 0.0        # base-data fetches + model loads
    compute_s: float = 0.0   # stats passes / chunk SGD
    merge_s: float = 0.0     # stat combine/uncombine + solve

    @property
    def total_s(self) -> float:
        return self.optimizer_s + self.io_s + self.compute_s + self.merge_s


@dataclass
class ExecResult:
    model: Any
    stats: Any
    plan: Plan
    timings: ExecTimings
    materialized_ids: list[str] = field(default_factory=list)


def execute(
    plan: Plan,
    family: ModelFamily,
    store: ModelStore,
    backend: Any,  # data backend: fetch(Range) -> (X, y)
    params: dict,
    *,
    materialize_chunks: bool = True,
) -> ExecResult:
    timings = ExecTimings(optimizer_s=plan.optimizer_seconds)
    pos: Optional[Any] = None
    neg: Optional[Any] = None
    new_ids: list[str] = []

    chunk_size = int(params.get("chunk_size", 10_000))
    monoid = not family.supports_delete

    # Chunk materialization below may trigger eviction; pin every model this
    # plan still has to read so a put cannot invalidate a later step
    # (put-during-execute).
    with store.pinned(plan.models_used):
        for step in plan.steps:
            if step.model_id is not None:
                t0 = time.perf_counter()
                stats = store.get(step.model_id).stats
                timings.io_s += time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                X, y = backend.fetch(step.rng)
                timings.io_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                if monoid and materialize_chunks:
                    # fit chunk-by-chunk and materialize each chunk (§4)
                    stats = None
                    for s in range(0, step.rng.size, chunk_size):
                        sub = Range(step.rng.lo + s, min(step.rng.lo + s + chunk_size, step.rng.hi))
                        cs = family.compute_stats(X[s : s + chunk_size], y[s : s + chunk_size], params)
                        new_ids.append(store.put(family.name, sub, cs, meta={"chunked": True}))
                        stats = cs if stats is None else stats + cs
                else:
                    stats = family.compute_stats(X, y, params)
                timings.compute_s += time.perf_counter() - t0

            t0 = time.perf_counter()
            if step.sign > 0:
                pos = stats if pos is None else pos + stats
            else:
                neg = stats if neg is None else neg + stats
            timings.merge_s += time.perf_counter() - t0

    if pos is None:
        raise RuntimeError("empty plan")
    t0 = time.perf_counter()
    total = pos if neg is None else pos - neg
    model = family.solve(total, params)
    timings.merge_s += time.perf_counter() - t0
    return ExecResult(model=model, stats=total, plan=plan, timings=timings,
                      materialized_ids=new_ids)


# ---------------------------------------------------------------------------
# Delta updates: edit-rebuild planning (reuse-prefix + rebuild-suffix)
# ---------------------------------------------------------------------------

def token_divergence(old_ids, new_ids) -> int:
    """Length of the common prefix of two token sequences.

    The first divergence point bounds KV reuse exactly: position ``i``'s
    cached KV depends on *all* tokens ``[0, i]``, so a stored segment
    ``[lo, hi)`` built for the old document is valid for the edited one
    iff ``hi ≤ divergence``.
    """
    old = np.asarray(old_ids).ravel()
    new = np.asarray(new_ids).ravel()
    n = int(min(old.size, new.size))
    if n == 0:
        return 0
    neq = old[:n] != new[:n]
    i = int(np.argmax(neq))
    return n if not neq[i] else i


@dataclass
class EditPlan:
    """Reuse-prefix + rebuild-suffix plan for one document edit.

    ``reuse`` lists the stored segments that survive the edit (every
    descriptor strictly before the divergence point), ``orphans`` the ids
    valid only for the old content.  ``action`` is the cost model's call:
    ``"scratch"`` means the reuse path is priced above a clean rebuild, in
    which case callers skip the rekey and every segment orphans.
    """

    divergence: int             # first differing token index
    length: int                 # tokens of the edited document to build
    reuse: list                 # [(seg_id, Range)], rng.hi <= divergence
    orphans: list               # seg ids invalidated by the edit
    reused_tokens: int          # covered_size of the reuse ranges
    rebuild_tokens: int         # length - reused_tokens (priced extent)
    edit_cost_s: float
    scratch_cost_s: float
    action: str                 # "edit" | "scratch"

    @property
    def rebuild_frac(self) -> float:
        return self.rebuild_tokens / self.length if self.length else 0.0


def plan_edit(old_ids, new_ids, index: DescriptorIndex, cost: CostModel,
              segment_bytes: dict, *, length: Optional[int] = None) -> EditPlan:
    """Price serving an edited document against its stored segments
    (``cost.edit_rebuild_s`` against a from-scratch ``F(n)``)."""
    new = np.asarray(new_ids).ravel()
    n_total = int(new.size) if length is None else int(length)
    div = min(token_divergence(old_ids, new), n_total)
    reuse: list = []
    orphans: list = []
    for sid, rng in index.items():
        if rng.hi <= div:
            reuse.append((sid, rng))
        else:
            orphans.append(sid)
    reused = covered_size([rng for _, rng in reuse])
    reuse_nbytes = sum(segment_bytes.get(sid, 0) for sid, _ in reuse)
    edit_cost = cost.edit_rebuild_s(n_total, reused, reuse_nbytes,
                                    k_segments=max(len(reuse), 1))
    scratch_cost = cost.fetch_points(n_total)
    action = "edit" if reuse and edit_cost < scratch_cost else "scratch"
    if action == "scratch":
        orphans = orphans + [sid for sid, _ in reuse]
        reuse, reused = [], 0
    return EditPlan(divergence=div, length=n_total, reuse=reuse,
                    orphans=orphans, reused_tokens=reused,
                    rebuild_tokens=n_total - reused,
                    edit_cost_s=edit_cost, scratch_cost_s=scratch_cost,
                    action=action)
