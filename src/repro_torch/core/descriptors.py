"""Model descriptors: half-open id ranges over a totally ordered data set.

The paper (§3.3) attaches to every materialized model a *descriptor* — a
range of point ids ``[l, u)`` over the base data set ``D``.  Descriptors are
the planner's currency: overlap tests, coalescing (Alg 3
``PreprocessDescriptors``), and the endpoint set that seeds the query graph
(Alg 4) all operate on them.

We use half-open integer intervals throughout (``l`` inclusive, ``u``
exclusive); the paper's closed ranges map 1:1.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence


@dataclass(frozen=True, order=True)
class Range:
    """Half-open id interval ``[lo, hi)``."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"invalid range [{self.lo}, {self.hi})")

    # -- basic predicates ------------------------------------------------
    @property
    def size(self) -> int:
        return self.hi - self.lo

    def is_empty(self) -> bool:
        return self.hi <= self.lo

    def contains(self, other: "Range") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def contains_point(self, x: int) -> bool:
        return self.lo <= x < self.hi

    def overlaps(self, other: "Range") -> bool:
        return self.lo < other.hi and other.lo < self.hi

    def touches(self, other: "Range") -> bool:
        """Overlapping *or* adjacent (shares an endpoint)."""
        return self.lo <= other.hi and other.lo <= self.hi

    # -- algebra ---------------------------------------------------------
    def intersect(self, other: "Range") -> "Range":
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return Range(lo, max(lo, hi))

    def union_hull(self, other: "Range") -> "Range":
        return Range(min(self.lo, other.lo), max(self.hi, other.hi))

    def difference(self, other: "Range") -> list["Range"]:
        """Set difference ``self − other`` as 0–2 ranges."""
        out: list[Range] = []
        if other.lo > self.lo:
            out.append(Range(self.lo, min(self.hi, other.lo)))
        if other.hi < self.hi:
            out.append(Range(max(self.lo, other.hi), self.hi))
        return [r for r in out if not r.is_empty()]

    def __repr__(self) -> str:  # compact, planner logs print many of these
        return f"[{self.lo},{self.hi})"


def coalesce(ranges: Iterable[Range]) -> list[Range]:
    """Merge touching/overlapping ranges into a minimal sorted cover."""
    rs = sorted((r for r in ranges if not r.is_empty()), key=lambda r: (r.lo, r.hi))
    out: list[Range] = []
    for r in rs:
        if out and r.lo <= out[-1].hi:
            out[-1] = Range(out[-1].lo, max(out[-1].hi, r.hi))
        else:
            out.append(r)
    return out


def covered_size(ranges: Iterable[Range]) -> int:
    return sum(r.size for r in coalesce(ranges))


def subtract_cover(target: Range, cover: Iterable[Range]) -> list[Range]:
    """Parts of ``target`` not covered by ``cover`` (sorted, disjoint)."""
    gaps = [target]
    for c in coalesce(cover):
        nxt: list[Range] = []
        for g in gaps:
            nxt.extend(g.difference(c))
        gaps = nxt
        if not gaps:
            break
    return gaps


@dataclass
class EnhancedDescriptor:
    """Alg 3 output: a coalesced hull + the materialized models under it."""

    hull: Range
    members: list[str] = field(default_factory=list)  # model ids


class DescriptorIndex:
    """Pre-processed view of the materialized-model descriptors (Alg 3).

    ``relevant(query)`` returns the paper's relevant set ``S_R``
    (Definition 1): every model whose *enhanced descriptor* (transitive
    overlap closure) intersects the query.  The index is incrementally
    maintainable: ``add``/``remove`` keep the coalesced hull list sorted so
    queries stay ``O(log m + |answer|)``.
    """

    def __init__(self) -> None:
        self._ranges: dict[str, Range] = {}
        self._hulls: list[EnhancedDescriptor] = []  # sorted by hull.lo
        self._dirty = False

    # -- maintenance -----------------------------------------------------
    def add(self, model_id: str, rng: Range) -> None:
        if model_id in self._ranges:
            raise KeyError(f"duplicate model id {model_id!r}")
        self._ranges[model_id] = rng
        self._dirty = True

    def remove(self, model_id: str) -> None:
        del self._ranges[model_id]
        self._dirty = True

    def __len__(self) -> int:
        return len(self._ranges)

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._ranges

    def range_of(self, model_id: str) -> Range:
        return self._ranges[model_id]

    def items(self) -> Iterator[tuple[str, Range]]:
        return iter(self._ranges.items())

    # -- Alg 3: PreprocessDescriptors -------------------------------------
    def _rebuild(self) -> None:
        entries = sorted(self._ranges.items(), key=lambda kv: (kv[1].lo, kv[1].hi))
        hulls: list[EnhancedDescriptor] = []
        for mid, r in entries:
            # paper coalesces on *overlap*; we also merge adjacency, which
            # only grows S_R (a superset of relevant models is still correct)
            if hulls and r.lo <= hulls[-1].hull.hi:
                h = hulls[-1]
                h.hull = Range(h.hull.lo, max(h.hull.hi, r.hi))
                h.members.append(mid)
            else:
                hulls.append(EnhancedDescriptor(hull=r, members=[mid]))
        self._hulls = hulls
        self._dirty = False

    @property
    def enhanced(self) -> list[EnhancedDescriptor]:
        if self._dirty:
            self._rebuild()
        return self._hulls

    # -- Definition 1: relevant set S_R -----------------------------------
    def relevant(self, query: Range) -> list[str]:
        hulls = self.enhanced
        los = [h.hull.lo for h in hulls]
        out: list[str] = []
        # first hull that could intersect: hull.hi > query.lo
        i = bisect.bisect_right(los, query.hi)
        for h in hulls[:i]:
            if h.hull.overlaps(query):
                out.extend(h.members)
        return out

    def coverage(self, universe: Range) -> float:
        """Fraction of ``universe`` covered by materialized descriptors."""
        if universe.size == 0:
            return 0.0
        inter = [universe.intersect(r) for r in self._ranges.values()]
        return covered_size(inter) / universe.size


def endpoints(ranges: Sequence[Range], query: Range) -> list[int]:
    """Sorted unique endpoint set for the query graph (Alg 4 vertices)."""
    pts = {query.lo, query.hi}
    for r in ranges:
        pts.add(r.lo)
        pts.add(r.hi)
    return sorted(pts)
