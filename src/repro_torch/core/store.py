"""Materialized-model store, and the pin-aware eviction it shares with the
serving store.

A framework-free copy of the pinning and eviction half of
``repro.core.store.PinnedStore`` and of ``ModelStore`` / ``StoredModel``
(descriptors + sufficient statistics, byte budget).  Persistence (npz +
manifest snapshots), residency tiers and the background writer wait for
ROADMAP.md §1 item 6.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional

from .cost import CostModel
from .descriptors import DescriptorIndex, Range
from .suffstats import STATS_FAMILIES, Combinable

#: eviction policies understood by :class:`PinnedStore`
EVICTION_POLICIES = ("cost", "lru")


class PinnedStore:
    """Pin-aware, cost-model-weighted eviction for byte-budgeted stores.

    Entries are materialized *during* plan execution, so a put-triggered
    eviction must never reclaim an entry a still-running plan references.
    Pins are reentrant counts.  Subclasses provide ``byte_budget``,
    ``nbytes()`` and ``evictions`` plus the ``_entries()`` /
    ``_evict(victim)`` hooks.

    Victim selection (``policy="cost"``, the default) is *benefit per
    byte*: ``recompute_s · decayed_frequency / nbytes``, where
    ``recompute_s`` is the cost model's F(n) over the entry's descriptor,
    ``decayed_frequency`` is ``prior + hits`` decayed by idle time
    (half-life ``decay_half_life_s``) and ``nbytes`` the budget the entry
    occupies.  Exact score ties fall back to least recently used.
    ``policy="lru"`` is plain recency.
    """

    def __init__(self, *, cost_model: Optional[CostModel] = None,
                 policy: Optional[str] = None,
                 decay_half_life_s: float = 300.0) -> None:
        self._pins: dict[str, int] = {}
        self.cost = cost_model if cost_model is not None else CostModel()
        policy = "cost" if policy is None else policy
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"expected one of {EVICTION_POLICIES}")
        self.policy = policy
        self.decay_half_life_s = decay_half_life_s

    def pin(self, ids: Iterable[str]) -> tuple:
        """Acquire reentrant pins on ``ids``; returns the token for
        :meth:`unpin`.  ``None`` ids (gap plan steps) are skipped."""
        token = tuple(i for i in ids if i is not None)
        for i in token:
            self._pins[i] = self._pins.get(i, 0) + 1
        return token

    def unpin(self, token: Iterable[str]) -> None:
        """Release pins taken by :meth:`pin` and re-enforce the byte budget
        (puts while pinned may have left the store over budget)."""
        for i in token:
            n = self._pins.get(i, 0) - 1
            if n > 0:
                self._pins[i] = n
            else:
                self._pins.pop(i, None)
        self._maybe_evict()

    @contextmanager
    def pinned(self, ids: Iterable[str]):
        """Hold the given entries in the store for the duration of the block."""
        token = self.pin(ids)
        try:
            yield
        finally:
            self.unpin(token)

    def _entries(self) -> dict:
        raise NotImplementedError

    def _evict(self, victim) -> None:
        raise NotImplementedError

    def _recompute_s(self, entry) -> float:
        """Estimated seconds to rebuild ``entry`` if it is evicted and
        later needed — the cost model's F over the entry's descriptor."""
        return self.cost.recompute_s(entry.rng.size)

    def _expected_reuses(self, entry) -> float:
        """Prior on how often ``entry`` will be hit again (the cost model's
        static ``expected_reuses``; the serving store uses observed rates)."""
        return self.cost.expected_reuses

    def retention_score(self, entry, now: Optional[float] = None) -> float:
        """Benefit-per-byte of keeping ``entry`` resident (higher = keep):
        ``recompute_s · (prior + hits) · 2^(−idle/half_life) / nbytes``."""
        now = time.time() if now is None else now
        idle = max(now - entry.last_used_s, 0.0)
        freq = (self._expected_reuses(entry) + entry.hits) \
            * 2.0 ** (-idle / self.decay_half_life_s)
        return self._recompute_s(entry) * freq / max(entry.nbytes, 1)

    def _pick_victim(self, candidates: list):
        if self.policy == "lru":
            return min(candidates, key=lambda e: e.last_used_s)
        now = time.time()
        # score ties (identical entries, quantized clocks) degrade to LRU
        return min(candidates,
                   key=lambda e: (self.retention_score(e, now), e.last_used_s))

    def _maybe_evict(self) -> None:
        if self.byte_budget is None:
            return
        while self.nbytes() > self.byte_budget:
            candidates = [e for k, e in self._entries().items()
                          if k not in self._pins]
            if not candidates or len(self._entries()) <= 1:
                break  # everything under pressure is pinned, or one is left
            self._evict(self._pick_victim(candidates))
            self.evictions += 1


@dataclass
class StoredModel:
    model_id: str
    family: str
    rng: Range
    stats: Combinable
    created_s: float = field(default_factory=time.time)
    last_used_s: float = field(default_factory=time.time)
    hits: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return self.stats.nbytes


class ModelStore(PinnedStore):
    """Per-family materialized models, indexed for Alg 3/4."""

    def __init__(self, byte_budget: Optional[int] = None, *,
                 cost_model: Optional[CostModel] = None,
                 policy: Optional[str] = None) -> None:
        super().__init__(cost_model=cost_model, policy=policy)
        self._models: dict[str, StoredModel] = {}
        self._indexes: dict[str, DescriptorIndex] = {}
        self._seq = 0
        self.byte_budget = byte_budget
        self.evictions = 0

    # -- crud --------------------------------------------------------------
    def put(self, family: str, rng: Range, stats: Combinable, meta: dict | None = None,
            model_id: str | None = None) -> str:
        if family not in STATS_FAMILIES:
            raise KeyError(f"unknown family {family!r}")
        if model_id is None:
            self._seq += 1
            model_id = f"{family}:{rng.lo}-{rng.hi}#{self._seq}"
        sm = StoredModel(model_id=model_id, family=family, rng=rng,
                         stats=stats.to_numpy(), meta=meta or {})
        self._models[model_id] = sm
        self.index(family).add(model_id, rng)
        self._maybe_evict()
        return model_id

    def get(self, model_id: str) -> StoredModel:
        sm = self._models[model_id]
        sm.last_used_s = time.time()
        sm.hits += 1
        return sm

    def drop(self, model_id: str) -> None:
        sm = self._models.pop(model_id)
        self.index(sm.family).remove(model_id)

    def index(self, family: str) -> DescriptorIndex:
        if family not in self._indexes:
            self._indexes[family] = DescriptorIndex()
        return self._indexes[family]

    def models(self, family: str | None = None) -> Iterator[StoredModel]:
        for sm in self._models.values():
            if family is None or sm.family == family:
                yield sm

    def __len__(self) -> int:
        return len(self._models)

    # -- accounting ----------------------------------------------------------
    def nbytes(self, family: str | None = None) -> int:
        return sum(sm.nbytes for sm in self.models(family))

    def model_bytes(self, family: str) -> dict[str, int]:
        return {sm.model_id: sm.nbytes for sm in self.models(family)}

    def coverage(self, family: str, universe: Range) -> float:
        return self.index(family).coverage(universe)

    def _entries(self) -> dict:
        return self._models

    def _evict(self, victim: StoredModel) -> None:
        self.drop(victim.model_id)

    # -- persistence ----------------------------------------------------------
    def save(self, path: str | Path) -> None:
        raise NotImplementedError(
            "ModelStore.save is not ported to repro_torch yet: ROADMAP.md §1 "
            "item 6 (persistence)")

    @classmethod
    def load(cls, path: str | Path, byte_budget: Optional[int] = None,
             verify: bool = True) -> "ModelStore":
        raise NotImplementedError(
            "ModelStore.load is not ported to repro_torch yet: ROADMAP.md §1 "
            "item 6 (persistence)")
