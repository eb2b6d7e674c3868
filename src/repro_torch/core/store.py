"""Pin-aware, cost-model-weighted eviction shared by byte-budgeted stores.

A framework-free copy of the pinning and eviction half of
``repro.core.store.PinnedStore``.  Persistence (npz + manifest snapshots),
residency tiers and the background writer wait for ROADMAP.md §1 item 6.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterable, Optional

from .cost import CostModel

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
