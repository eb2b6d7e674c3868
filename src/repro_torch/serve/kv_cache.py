"""KV segment store: materialized caches with range descriptors.

The serving-side instance of the paper's idea (see ``repro.serve.kv_cache``
for the full account).  A prefill over document positions ``[0, b)``
yields cache tensors; they are sliced into segments ``[a_i, a_{i+1})`` and
stored under their descriptors.  KV values for a position depend only on
the document prefix, so a stored segment is reusable by any later request;
segments compose under concatenation, the planner's directed case.

Stored-segment invariants (shared with the JAX package):

  * segment trees are layer-stacked, so SEQ leaves carry the document axis
    at axis 2 — ``(layers, batch, seq, ...)`` — with batch 1 in the store;
  * segments are stored padded to ``bucket_len(rng.size, seq_bucket)``
    along axis 2, the exact valid length recorded on the entry;
  * running-state leaves hold the state at the segment's end; constant
    leaves are prefix-invariant.

PyTorch slices are views, so every tree the store keeps is a copy: a
stored segment never aliases a working cache that later steps update in
place.  This store is device-only at model precision; host/disk tiers,
int8 residency and snapshots wait for ROADMAP.md §1 item 6.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cost import CostModel, serve_cost_model
from repro_torch.core.descriptors import DescriptorIndex, Range
from repro_torch.core.store import PinnedStore
from repro_torch.kernels.common import bucket_len
from repro_torch.models.common import CACHE_SEQ_KEYS as SEQ_KEYS
from repro_torch.models.common import CACHE_STATE_KEYS as STATE_KEYS
from repro_torch.models.common import cache_leaf_key as _leaf_key
from repro_torch.models.common import tree_leaves, tree_map_with_path


def slice_cache(caches, lo: int, hi: int, *, base: int = 0):
    """Segment [lo, hi) of caches covering [base, base+T), as a copy."""

    def f(path, x):
        if _leaf_key(path) in SEQ_KEYS:
            return x[:, :, lo - base:hi - base].clone()
        return x.clone()  # states & constants: value at end of the range
    return tree_map_with_path(f, caches)


def clone_cache(caches):
    return tree_map_with_path(lambda _, x: x.clone(), caches)


def concat_caches(a, b):
    """Concatenate segment caches along the document axis; running state and
    constants are taken from the *later* segment."""

    def f(path, xa, xb):
        if _leaf_key(path) in SEQ_KEYS:
            return torch.cat([xa, xb], dim=2)
        return xb
    return tree_map_with_path(f, a, b)


def cache_len(caches) -> int:
    lens = []

    def f(path, x):
        if _leaf_key(path) in SEQ_KEYS:
            lens.append(x.shape[2])
        return x

    tree_map_with_path(f, caches)
    return max(lens) if lens else 0


def pad_cache(caches, extra: int):
    """Grow capacity along the sequence axis (zeros; returns new tensors)."""

    def f(path, x):
        if _leaf_key(path) in SEQ_KEYS:
            return F.pad(x, [0, 0] * (x.ndim - 3) + [0, extra])
        return x

    return tree_map_with_path(f, caches)


def pad_cache_to(caches, target: int):
    """Grow the sequence axis of SEQ leaves up to ``target`` capacity.
    Returns ``caches`` itself (not a copy) when it is already that large."""
    cur = cache_len(caches)
    if cur >= target:
        return caches
    return pad_cache(caches, target - cur)


def insert_cache(caches, seg, start: int):
    """Write a (bucket-padded) segment into a capacity-padded cache at
    ``start``, **in place**; returns ``caches``.

    The segment's rows past its valid length are garbage; callers apply
    inserts in ascending document order so each step's valid rows
    overwrite the previous step's padded tail, and garbage past the final
    valid length is excluded by causal masking.  ``start + seg capacity``
    must fit the cache (checked: the JAX reference's
    ``dynamic_update_slice`` would clamp instead).  State and constant
    leaves are taken from the (later) segment, matching concat semantics.
    """

    def f(path, big, small):
        if _leaf_key(path) in SEQ_KEYS:
            n = small.shape[2]
            if start < 0 or start + n > big.shape[2]:
                raise ValueError(f"segment [{start}, {start + n}) does not fit "
                                 f"a cache of capacity {big.shape[2]}")
            big[:, :, start:start + n] = small.to(big.dtype)
            return big
        return small.clone()
    return tree_map_with_path(f, caches, seg)


def chunk_segment(caches, chunk_states, i: int, lo: int, hi: int):
    """Materialized segment for multi-chunk extend chunk ``i`` covering
    [lo, hi): sequence leaves sliced out of the post-loop caches,
    running-state leaves from the per-chunk snapshot."""
    seg = slice_cache(caches, lo, hi)

    def f(path, s, snap):
        if _leaf_key(path) in STATE_KEYS:
            return snap[i].clone()
        return s
    return tree_map_with_path(f, seg, chunk_states)


def cache_nbytes(caches) -> int:
    """Total payload bytes of a cache tree (shape metadata only)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(caches))


DEFAULT_DOC = "doc"


@dataclass
class StoredSegment:
    seg_id: str
    rng: Range
    #: cache tree with SEQ leaves padded to ``capacity`` along axis 2; rows
    #: in ``[valid, capacity)`` are garbage consumers overwrite or mask
    caches: Any
    doc_id: str = DEFAULT_DOC
    #: exact number of valid positions (``rng.size``)
    valid: int = 0
    created_by: Optional[int] = None   # session id that materialized it
    hits: int = 0
    cross_session_hits: int = 0
    last_used_s: float = field(default_factory=time.time)
    #: extra document ids whose descriptor indexes also reference this
    #: segment
    aliases: set = field(default_factory=set)
    #: bucketed SEQ-axis capacity
    capacity: int = 0

    def __post_init__(self):
        if not self.valid:
            self.valid = self.rng.size
        if not self.capacity:
            self.capacity = cache_len(self.caches)

    @cached_property
    def nbytes(self) -> int:
        # the *padded* residency — what the byte budget actually pays
        return cache_nbytes(self.caches)

    def doc_ids(self) -> set:
        return {self.doc_id} | self.aliases


class SegmentStore(PinnedStore):
    """Document-keyed, descriptor-indexed KV segments under one byte budget.

    Each document gets its own :class:`DescriptorIndex` so plans never
    cross documents, while eviction is global and cost-model-weighted
    (``PinnedStore.retention_score``, with the observed per-document reuse
    rate as prior).  Segments referenced by an in-flight plan are protected
    via the inherited ``pinned`` context.
    """

    def __init__(self, byte_budget: Optional[int] = None, *,
                 cost_model: Optional[CostModel] = None,
                 policy: Optional[str] = None,
                 seq_bucket: int = 64) -> None:
        if cost_model is None:
            cost_model = serve_cost_model()
        super().__init__(cost_model=cost_model, policy=policy)
        self._indexes: dict[str, DescriptorIndex] = {}
        self._segs: dict[str, StoredSegment] = {}
        self._seq = 0
        self.byte_budget = byte_budget
        #: SEQ-axis bucket granularity stored segments are padded to
        self.seq_bucket = seq_bucket
        self.evictions = 0
        self.cross_session_hits = 0
        #: per-document observed traffic: doc_id -> [segments put, hits]
        self._doc_stats: dict[str, list[int]] = {}

    def index(self, doc_id: str = DEFAULT_DOC) -> DescriptorIndex:
        if doc_id not in self._indexes:
            self._indexes[doc_id] = DescriptorIndex()
        return self._indexes[doc_id]

    def doc_ids(self) -> list[str]:
        return list(self._indexes)

    def bucket_capacity(self, n: int) -> int:
        """SEQ-axis capacity a segment of ``n`` valid positions occupies."""
        return bucket_len(n, self.seq_bucket)

    def capacity(self, sid: str) -> int:
        """Stored SEQ capacity of ``sid`` — without counting as a hit."""
        return self._segs[sid].capacity

    def put(self, rng: Range, caches, *, doc_id: str = DEFAULT_DOC,
            created_by: Optional[int] = None,
            seg_id: Optional[str] = None) -> str:
        """Store a copy of ``caches`` covering ``rng``, padded to the bucket
        capacity (any input length ≥ ``rng.size`` is normalized)."""
        cap = self.bucket_capacity(rng.size)
        cur = cache_len(caches)
        if cur and cur < rng.size:
            raise ValueError(
                f"segment caches cover {cur} positions but the "
                f"descriptor claims {rng.size}")
        if cur > cap:
            caches = slice_cache(caches, 0, rng.size)
        else:
            caches = clone_cache(caches)
        caches = pad_cache_to(caches, cap)
        if seg_id is None:
            self._seq += 1
            seg_id = f"kv:{doc_id}:{rng.lo}-{rng.hi}#{self._seq}"
        seg = StoredSegment(seg_id, rng, caches, doc_id=doc_id,
                            valid=rng.size, created_by=created_by)
        self._segs[seg_id] = seg
        self.index(doc_id).add(seg_id, rng)
        self._doc_stats.setdefault(doc_id, [0, 0])[0] += 1
        self._maybe_evict()
        return seg_id

    def get(self, sid: str, *, requester: Optional[int] = None) -> StoredSegment:
        seg = self._segs[sid]
        seg.last_used_s = time.time()
        seg.hits += 1
        self._doc_stats.setdefault(seg.doc_id, [0, 0])[1] += 1
        if requester is not None and seg.created_by is not None \
                and requester != seg.created_by:
            seg.cross_session_hits += 1
            self.cross_session_hits += 1
        return seg

    def prefetch_ids(self, ids) -> int:
        """Device-only store: every resident segment is already on the
        device, so there is nothing to promote."""
        return 0

    # -- admission priors from observed traffic ----------------------------
    def observed_reuses(self, doc_id: str) -> float:
        """Smoothed per-document reuse rate: hits per stored segment, with
        one pseudo-observation at the cost model's static prior."""
        puts, hits = self._doc_stats.get(doc_id, (0, 0))
        return (hits + self.cost.expected_reuses) / (puts + 1.0)

    def _expected_reuses(self, entry: StoredSegment) -> float:
        return self.observed_reuses(entry.doc_id)

    def release_doc(self, doc_id: str) -> int:
        """Forget a document id: drop its index and unreference its
        segments; segments only this document referenced are dropped
        (never one pinned by an in-flight plan).  Returns the number of
        segments dropped."""
        idx = self._indexes.pop(doc_id, None)
        self._doc_stats.pop(doc_id, None)
        if idx is None:
            return 0
        dropped = 0
        for sid, _ in list(idx.items()):
            seg = self._segs.get(sid)
            if seg is None:
                continue
            seg.aliases.discard(doc_id)
            if seg.doc_id == doc_id:
                if seg.aliases:
                    seg.doc_id = seg.aliases.pop()  # promote a live reference
                elif sid not in self._pins:
                    del self._segs[sid]
                    dropped += 1
        return dropped

    def rekey(self, old_doc: str, new_doc: str, *, upto: int) -> int:
        """Move every segment of ``old_doc`` ending at or before ``upto``
        (the edit's divergence point) to ``new_doc``'s index, with its
        traffic history.  Returns the number of segments migrated."""
        if old_doc == new_doc or old_doc not in self._indexes:
            return 0
        old_idx = self._indexes[old_doc]
        new_idx = self.index(new_doc)
        moved = 0
        for sid, rng in list(old_idx.items()):
            if rng.hi > upto:
                continue
            seg = self._segs.get(sid)
            if seg is None:
                continue
            old_idx.remove(sid)
            if sid not in new_idx:
                new_idx.add(sid, rng)
            if seg.doc_id == old_doc:
                seg.doc_id = new_doc
            else:
                seg.aliases.add(new_doc)
            seg.aliases.discard(old_doc)
            moved += 1
        stats = self._doc_stats.pop(old_doc, None)
        if stats is not None:
            dst = self._doc_stats.setdefault(new_doc, [0, 0])
            dst[0] += stats[0]
            dst[1] += stats[1]
        return moved

    def nbytes(self, doc_id: Optional[str] = None) -> int:
        return sum(s.nbytes for s in self._segs.values()
                   if doc_id is None or doc_id in s.doc_ids())

    def __len__(self) -> int:
        return len(self._segs)

    def __contains__(self, sid: str) -> bool:
        return sid in self._segs

    def segment_bytes(self, doc_id: str = DEFAULT_DOC) -> dict[str, int]:
        return {sid: s.nbytes for sid, s in self._segs.items()
                if doc_id in s.doc_ids()}

    def _entries(self) -> dict:
        return self._segs

    def _evict(self, victim: StoredSegment) -> None:
        del self._segs[victim.seg_id]
        for doc_id in victim.doc_ids():
            idx = self._indexes.get(doc_id)
            if idx is None or victim.seg_id not in idx:
                continue
            idx.remove(victim.seg_id)
            if len(idx) == 0:
                del self._indexes[doc_id]
