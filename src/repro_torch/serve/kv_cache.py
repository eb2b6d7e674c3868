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

PyTorch slices are views, so every tree the store keeps is a compact copy
(each leaf owns storage of its own size): a stored segment never shares
bytes with a working cache or a decode pack that later steps update in
place.

Residency: a segment lives on one rung of the device → host → disk
ladder and at one precision (the model's, or blockwise int8 with scales,
see :mod:`repro_torch.core.quant`); the store round-trips through the
npz-plus-manifest snapshots of :mod:`repro_torch.core.store`, in the JAX
package's format.
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cost import CostModel, serve_cost_model
from repro_torch.core.descriptors import DescriptorIndex, Range
from repro_torch.core.quant import QuantMeta, quantize_tree, resolve_precision
from repro_torch.core.store import (TIER_POLICIES, BackgroundWriter, PinnedStore,
                                    _link_or_copy, flatten_tree, to_numpy,
                                    to_torch, unflatten_tree)
from repro_torch.kernels.common import bucket_len
from repro_torch.models.common import CACHE_SEQ_KEYS as SEQ_KEYS
from repro_torch.models.common import CACHE_STATE_KEYS as STATE_KEYS
from repro_torch.models.common import cache_leaf_key as _leaf_key
from repro_torch.models.common import (tree_items_sorted, tree_leaves,
                                       tree_map_with_path)


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


def adopt_cache(seg, target: int):
    """A working cache started from the segment ``seg``: SEQ leaves grown to
    ``target`` capacity, every leaf in storage of its own.  The working
    cache is written in place (K/V rows, and SSD state over its whole
    leaf), so it must share nothing with the stored copy."""

    def f(path, x):
        if _leaf_key(path) in SEQ_KEYS and x.shape[2] < target:
            return F.pad(x, [0, 0] * (x.ndim - 3) + [0, target - x.shape[2]])
        return x.clone()

    return tree_map_with_path(f, seg)


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


def holds_state(caches) -> bool:
    """Whether the tree has a running-state leaf (SSD conv / ssm), whose
    value is the state at the end of what was last processed."""
    return any(_leaf_key(p) in STATE_KEYS for p, _ in tree_items_sorted(caches))


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
    created_s: float = field(default_factory=time.time)
    last_used_s: float = field(default_factory=time.time)
    #: extra document ids whose descriptor indexes also reference this
    #: segment
    aliases: set = field(default_factory=set)
    #: residency rung: "device" (tensors on the store's device), "host"
    #: (CPU tensors, pinned when the device is a card) or "disk"
    #: (``caches is None``; payload behind ``spill``)
    tier: str = "device"
    #: bucketed SEQ-axis capacity; stored rather than derived because a
    #: disk-resident segment has no cache tree to measure
    capacity: int = 0
    #: disk-tier state: {"file", "record", "sha256"}; kept across a
    #: promotion, so re-demoting to disk while the file survives is free
    spill: Optional[dict] = field(default=None, repr=False)
    #: spill payload (numpy) whose background write has not landed yet
    pending_arrays: Optional[dict] = field(default=None, repr=False)
    #: storage precision: "fp32" (lossless, the model's own dtypes) or
    #: "int8" (blockwise symmetric; ``quant`` holds the scales)
    precision: str = "fp32"
    #: per-block scale sidecar when ``precision == "int8"``
    quant: Optional[QuantMeta] = field(default=None, repr=False)
    #: CUDA event recorded after the device-to-host copies of a demotion;
    #: the host buffers are readable once it has completed
    host_event: Any = field(default=None, repr=False)
    #: a transient copy fetched from another shard (the sharded store's
    #: fetch cache), not a resident of any store
    fetched: bool = False

    def __post_init__(self):
        if not self.valid:
            self.valid = self.rng.size
        if self.caches is not None:
            if not self.capacity:
                self.capacity = cache_len(self.caches)
            self.nbytes  # prime while caches exist (shape metadata only)

    @cached_property
    def nbytes(self) -> int:
        # the *padded* residency, plus the scale sidecar of an int8 entry;
        # computed once so it survives demotion to disk
        return cache_nbytes(self.caches) + \
            (self.quant.nbytes() if self.quant is not None else 0)

    def doc_ids(self) -> set:
        return {self.doc_id} | self.aliases


def _tree_map(fn, tree):
    return tree_map_with_path(lambda _, x: fn(x), tree)


class SegmentStore(PinnedStore):
    """Document-keyed, descriptor-indexed KV segments under one byte budget,
    on a device → host → disk residency ladder.

    Each document gets its own :class:`DescriptorIndex` so plans never
    cross documents, while eviction is global and cost-model-weighted
    (``PinnedStore.retention_score``, with the observed per-document reuse
    rate as prior).  Segments referenced by an in-flight plan are protected
    via the inherited ``pinned`` context.

    ``byte_budget`` caps the device tier; ``host_budget`` (if set) enables
    and caps the host tier (CPU tensors, pinned when the device is a card);
    ``spill_dir`` (if set) enables the unbounded disk tier (npz spill
    files, the snapshot entry format).  Under pressure the cost model
    prices demotion against a drop (``demotion_action``); a hit on a
    demoted segment promotes it back.  ``precision`` is the rung above
    host: "int8" quantizes every admitted segment, "auto" quantizes
    victims the cost model prices so, "fp32" never quantizes.  Tier round
    trips are bitwise copies of the padded buffers.

    ``device`` is where device-tier segments live and promotions land;
    ``None`` takes the device of the first segment put.
    """

    def __init__(self, byte_budget: Optional[int] = None, *,
                 cost_model: Optional[CostModel] = None,
                 policy: Optional[str] = None,
                 seq_bucket: int = 64,
                 host_budget: Optional[int] = None,
                 spill_dir: Optional[str | Path] = None,
                 tier_policy: str = "tiered",
                 precision: str = "auto",
                 writer: Optional[BackgroundWriter] = None,
                 device=None) -> None:
        if cost_model is None:
            cost_model = serve_cost_model()
        super().__init__(cost_model=cost_model, policy=policy, writer=writer)
        self._indexes: dict[str, DescriptorIndex] = {}
        self._segs: dict[str, StoredSegment] = {}
        self._seq = 0
        self.byte_budget = byte_budget
        #: SEQ-axis bucket granularity stored segments are padded to
        self.seq_bucket = seq_bucket
        self.device = None if device is None else torch.device(device)
        self.evictions = 0
        self.evicted_bytes = 0
        self.cross_session_hits = 0
        #: per-segment bound on fork references: beyond it, :meth:`alias`
        #: skips the segment (the fork re-prefills it instead)
        self.max_aliases = 64
        self.alias_skips = 0
        #: delta-update traffic: the segments rekey() moved
        self.rekeyed_segments = 0
        #: per-document observed traffic: doc_id -> [segments put, hits]
        self._doc_stats: dict[str, list[int]] = {}
        self.host_budget = host_budget
        self.spill_dir = Path(spill_dir) if spill_dir is not None else None
        if tier_policy not in TIER_POLICIES:
            raise ValueError(f"unknown tier policy {tier_policy!r}; "
                             f"expected one of {TIER_POLICIES}")
        self.tier_policy = tier_policy
        self.precision = resolve_precision(precision)
        self.quantized = 0
        self.quant_bytes_saved = 0
        self.demotions = {"host": 0, "disk": 0}
        self.promotions = {"host": 0, "disk": 0}
        self.demoted_bytes = 0
        self.promoted_bytes = 0
        self.prefetches = 0
        self.spill_writes = 0
        self.swept_spills = 0
        #: prefetch() skips documents whose observed reuse prior is below this
        self.prefetch_min_prior = 0.25
        #: spill files whose unlink was deferred past an in-flight
        #: background job that may still link from them
        self._orphan_spills: list[Path] = []

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
            seg_id: Optional[str] = None,
            quant: Optional[QuantMeta] = None) -> str:
        """Store a copy of ``caches`` covering ``rng``, padded to the bucket
        capacity (any input length ≥ ``rng.size`` is normalized).

        ``quant`` marks ``caches`` as an int8 payload already (a reloaded
        snapshot entry) and carries its scales; it is attached before the
        budget is enforced, so the entry can never be demoted or spilled
        without them."""
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
        if self.device is None:
            self.device = next(iter(tree_leaves(caches))).device
        if seg_id is None:
            self._seq += 1
            seg_id = f"kv:{doc_id}:{rng.lo}-{rng.hi}#{self._seq}"
        # replacing an id invalidates any snapshot file cached under it —
        # and any spill file, which holds the *old* payload
        self._invalidate_record(seg_id)
        old = self._segs.get(seg_id)
        if old is not None:
            self._drop_spill(old)
        seg = StoredSegment(seg_id, rng, caches, doc_id=doc_id,
                            valid=rng.size, created_by=created_by)
        self._segs[seg_id] = seg
        if quant is not None:
            seg.precision, seg.quant = "int8", quant
            seg.__dict__["nbytes"] = cache_nbytes(seg.caches) + quant.nbytes()
        elif self.precision == "int8":
            self._quantize_seg(seg)   # forced int8: compress at the door
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
        if seg.tier != "device":
            self._promote(seg)   # a tier hit pays promote_s, not F(n)
        return seg

    # -- admission priors from observed traffic ----------------------------
    def observed_reuses(self, doc_id: str) -> float:
        """Smoothed per-document reuse rate: hits per stored segment, with
        one pseudo-observation at the cost model's static prior."""
        puts, hits = self._doc_stats.get(doc_id, (0, 0))
        return (hits + self.cost.expected_reuses) / (puts + 1.0)

    def admission_prior(self, doc_id: str) -> float:
        """Expected future reuses for a segment of ``doc_id``."""
        return self.observed_reuses(doc_id)

    def _expected_reuses(self, entry: StoredSegment) -> float:
        return self.admission_prior(entry.doc_id)

    def alias(self, src_doc: str, dst_doc: str, *,
              upto: Optional[int] = None) -> int:
        """Publish ``src_doc``'s segments ending at or before ``upto`` under
        ``dst_doc``'s index too (no copy: one resident tree, several
        plannable documents).  Decode write-back forks a document: the
        continuation ``doc[:L] + generated`` has its own content key, but
        every base segment within ``[0, L)`` is valid for it as it is.
        Returns the number of segments aliased."""
        if src_doc == dst_doc or src_doc not in self._indexes:
            return 0
        dst = self.index(dst_doc)
        n = 0
        for sid, rng in list(self.index(src_doc).items()):
            if upto is not None and rng.hi > upto:
                continue
            seg = self._segs[sid]
            if dst_doc in seg.doc_ids() or sid in dst:
                continue
            if len(seg.aliases) >= self.max_aliases:
                self.alias_skips += 1
                continue
            seg.aliases.add(dst_doc)
            dst.add(sid, rng)
            n += 1
        return n

    def release_doc(self, doc_id: str) -> int:
        """Forget a document id: drop its index and unreference its
        segments; segments only this document referenced are dropped from
        every tier (never one pinned by an in-flight plan).  Returns the
        number of segments dropped."""
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
                    self._drop_spill(seg)
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
        self.rekeyed_segments += moved
        return moved

    def nbytes(self, doc_id: Optional[str] = None) -> int:
        """Resident bytes across *all* tiers (``tier_bytes`` splits them)."""
        return sum(s.nbytes for s in self._segs.values()
                   if doc_id is None or doc_id in s.doc_ids())

    def tier_bytes(self) -> dict[str, int]:
        """Resident bytes per tier: ``{"device", "host", "disk"}``."""
        out = {"device": 0, "host": 0, "disk": 0}
        for s in self._segs.values():
            out[s.tier] += s.nbytes
        return out

    def device_nbytes(self) -> int:
        return sum(s.nbytes for s in self._segs.values() if s.tier == "device")

    def host_nbytes(self) -> int:
        return sum(s.nbytes for s in self._segs.values() if s.tier == "host")

    def quantized_segments(self) -> int:
        """Currently-resident int8 entries (``quantized`` counts events)."""
        return sum(1 for s in self._segs.values() if s.precision == "int8")

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
        self._drop_spill(victim)
        del self._segs[victim.seg_id]
        for doc_id in victim.doc_ids():
            idx = self._indexes.get(doc_id)
            if idx is None or victim.seg_id not in idx:
                continue
            idx.remove(victim.seg_id)
            if len(idx) == 0:
                del self._indexes[doc_id]
        self.evicted_bytes += victim.nbytes

    # -- residency tiers (device -> host -> disk) --------------------------

    def _pressure_nbytes(self) -> int:
        return self.device_nbytes()

    def _evictable(self, entry: StoredSegment) -> bool:
        # the device loop handles device residents; host residents answer
        # to the host budget, disk is the floor
        return entry.tier == "device"

    def _demotion_tiers(self) -> tuple:
        if self.tier_policy != "tiered":
            return ()
        tiers = []
        if self.host_budget is not None:
            tiers.append("host")
        if self.spill_dir is not None:
            tiers.append("disk")
        return tuple(tiers)

    def _quantize_seg(self, seg: StoredSegment) -> bool:
        """Re-encode a device-resident fp32 segment as blockwise int8, in
        place (same tree structure and shapes).  Any cached snapshot record
        or spill file holds the old payload and is invalidated.  False when
        there is nothing to quantize."""
        if seg.precision != "fp32" or seg.caches is None \
                or seg.tier != "device":
            return False
        qtree, meta = quantize_tree(seg.caches, block=self.seq_bucket)
        if not meta.scales:
            return False
        old_nbytes = seg.nbytes
        seg.caches = qtree
        seg.quant = meta
        seg.precision = "int8"
        seg.__dict__["nbytes"] = cache_nbytes(qtree) + meta.nbytes()
        self.quantized += 1
        self.quant_bytes_saved += max(old_nbytes - seg.nbytes, 0)
        self._invalidate_record(seg.seg_id)
        self._drop_spill(seg)
        return True

    def _relegate(self, victim: StoredSegment) -> bool:
        tiers = self._demotion_tiers()
        if tiers and self.precision == "auto" and victim.precision == "fp32":
            # precision is the rung above host: try shrinking the victim in
            # place before paying a copy (hot documents keep fp32)
            prior = self.admission_prior(victim.doc_id)
            if self.cost.precision_action(
                    victim.valid, victim.nbytes, expected_reuses=prior,
                    pressured=False) == "int8" \
                    and self._quantize_seg(victim):
                return True
        action = "drop"
        if tiers:
            action = self.cost.demotion_action(
                victim.valid, victim.nbytes, tiers=tiers,
                expected_reuses=self.admission_prior(victim.doc_id))
        if action == "drop":
            if len(self._segs) <= 1:
                return False
            self._evict(victim)
            self.evictions += 1
            return True
        self._demote(victim, action)
        return True

    def _enforce_tiers(self) -> None:
        if self.host_budget is None:
            return
        while self.host_nbytes() > self.host_budget:
            candidates = [s for s in self._segs.values()
                          if s.tier == "host" and s.seg_id not in self._pins]
            if not candidates:
                break
            victim = self._pick_victim(candidates)
            if self.spill_dir is not None and self.tier_policy == "tiered":
                self._demote(victim, "disk")
            else:
                if len(self._segs) <= 1:
                    break
                self._evict(victim)
                self.evictions += 1

    def _to_host(self, seg: StoredSegment) -> None:
        """Device tier → host tier.  From a card the copies go into pinned
        buffers without blocking, and an event marks when they are
        readable (:meth:`_wait_host`); on the CPU the tensors stay."""
        def copy(x):
            if x.device.type == "cpu":
                return x
            dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            dst.copy_(x, non_blocking=True)
            return dst

        seg.caches = _tree_map(copy, seg.caches)
        if seg.quant is not None:
            seg.quant.scales = {k: copy(s) for k, s in seg.quant.scales.items()}
        if self.device is not None and self.device.type == "cuda":
            seg.host_event = torch.cuda.Event()
            seg.host_event.record(torch.cuda.current_stream(self.device))

    @staticmethod
    def _wait_host(seg: StoredSegment) -> None:
        """Block until a demotion's device-to-host copies have landed."""
        if seg.host_event is not None:
            seg.host_event.synchronize()
            seg.host_event = None

    def _demote(self, seg: StoredSegment, tier: str) -> None:
        if seg.tier == "device" and self.precision == "auto" \
                and seg.precision == "fp32":
            # compress on the way out: pressure overrides the hot-set pin
            if self.cost.precision_action(
                    seg.valid, seg.nbytes, pressured=True,
                    expected_reuses=self.admission_prior(seg.doc_id)) == "int8":
                self._quantize_seg(seg)
        nb = seg.nbytes
        if tier == "disk" and seg.spill is not None \
                and (seg.spill.get("sha256") or seg.pending_arrays is not None):
            # the payload is frozen and its spill bytes still exist (the
            # segment was promoted earlier): re-demotion is a metadata flip
            seg.caches = None
            seg.host_event = None
            seg.tier = "disk"
        else:
            if seg.tier == "device":
                self._to_host(seg)
                seg.tier = "host"
            if tier == "disk":
                self._spill(seg)
        self.demotions[tier] += 1
        self.demoted_bytes += nb

    def _spill_path(self, seg_id: str) -> Path:
        # sha256: spill names are stable across processes and hosts
        d = self.spill_dir
        d.mkdir(parents=True, exist_ok=True)
        return d / f"seg-{hashlib.sha256(seg_id.encode()).hexdigest()[:20]}.npz"

    def _segment_record(self, seg: StoredSegment, spec) -> dict:
        """The immutable manifest record — shared by snapshot entries and
        spill files, which is what lets the two hard-link each other."""
        rec = {
            "seg_id": seg.seg_id,
            "lo": seg.rng.lo,
            "hi": seg.rng.hi,
            "valid": seg.valid,
            "capacity": seg.capacity,
            "nbytes": seg.nbytes,
            "tree": spec,
            "precision": seg.precision,
        }
        if seg.quant is not None:
            rec["quant"] = seg.quant.manifest()
        return rec

    @staticmethod
    def _payload_arrays(leaves, quant: Optional[QuantMeta]) -> dict:
        """npz contents for one segment: ``leaf_{j}`` payload arrays
        (insertion order) plus, for int8 entries, ``qscale_{j}`` scales
        (``j`` in ``jax.tree_util`` order, see :mod:`repro_torch.core.quant`)."""
        arrays = {f"leaf_{j}": x for j, x in enumerate(leaves)}
        if quant is not None:
            for k, s in quant.scales.items():
                arrays[f"qscale_{k}"] = to_numpy(s)
        return arrays

    def _spill(self, seg: StoredSegment) -> None:
        """Move a host-resident payload into a spill file (the snapshot
        entry format) on the background writer.  Write-through: the entry
        flips to disk immediately and ``pending_arrays`` serves promotions
        and snapshots until the worker lands the file and its hash."""
        self._wait_host(seg)
        spec, leaves = flatten_tree(seg.caches)
        arrays = self._payload_arrays(leaves, seg.quant)
        record = self._segment_record(seg, spec)
        path = self._spill_path(seg.seg_id)
        spill = {"file": str(path), "record": record, "sha256": None}
        seg.spill = spill
        seg.pending_arrays = arrays
        # int8 payloads deflate well and the cold tiers are off the
        # latency path
        savez = np.savez_compressed if seg.precision == "int8" else np.savez

        def _write() -> None:
            tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
            with open(tmp, "wb") as f:
                savez(f, **arrays)
            sha = hashlib.sha256(tmp.read_bytes()).hexdigest()
            os.replace(tmp, path)
            # publish completion only after the file is in place
            spill["sha256"] = sha
            seg.pending_arrays = None

        if not self._ensure_writer().submit(_write):
            _write()  # queue full: spills must land; pay for it inline
        seg.caches = None
        seg.tier = "disk"
        self.spill_writes += 1

    def _load_spill_payload(self, seg: StoredSegment):
        """Spill contents → (payload leaves, {index: scale}) as numpy; the
        write-through pending copy while the background write is in flight,
        the landed npz afterwards."""

        def split(src, names):
            n = sum(1 for k in names if k.startswith("leaf_"))
            leaves = [src[f"leaf_{j}"] for j in range(n)]
            scales = {k[len("qscale_"):]: src[k] for k in names
                      if k.startswith("qscale_")}
            return leaves, scales

        pending = seg.pending_arrays
        if pending is not None:
            return split(pending, pending)
        with np.load(seg.spill["file"]) as z:
            return split(z, z.files)

    def _drop_spill(self, seg: StoredSegment) -> None:
        sp, seg.spill, seg.pending_arrays = seg.spill, None, None
        if sp is None:
            return
        path = Path(sp["file"])
        with self._records_lock:
            busy = self._save_pending
        if busy or (self._writer is not None and self._writer.depth() > 0):
            # an in-flight background job may still read/link this file
            self._orphan_spills.append(path)
            return
        try:
            path.unlink()
        except OSError:
            return
        self.swept_spills += 1

    def flush_saves(self) -> float:
        dt = super().flush_saves()
        for path in self._orphan_spills:
            try:
                path.unlink()
            except OSError:
                continue
            self.swept_spills += 1
        self._orphan_spills.clear()
        return dt

    def _on_device(self, x) -> torch.Tensor:
        return to_torch(x).to(self.device) if isinstance(x, np.ndarray) \
            else x.to(self.device, non_blocking=True)

    def _promote(self, seg: StoredSegment) -> None:
        """Bring a demoted segment back to the device tier: host residents
        pay one host-to-device copy, disk residents a spill-file read
        first.  The spill record is kept (re-demotion to disk is free).
        The device tier may exceed its budget until the next store
        mutation settles it, so a hit never demotes its own segment."""
        src = seg.tier
        if src == "device":
            return
        if src == "disk":
            rec = seg.spill["record"]
            leaves, scales = self._load_spill_payload(seg)
            seg.caches = unflatten_tree(rec["tree"], leaves, leaf_fn=self._on_device)
            if rec.get("precision") == "int8" and seg.quant is None:
                # a snapshot-reloaded disk entry carries its scales only
                # in the npz; rebuild the sidecar on first promotion
                qm = rec.get("quant", {})
                seg.precision = "int8"
                seg.quant = QuantMeta(
                    block=int(qm.get("block", self.seq_bucket)),
                    scales={k: self._on_device(v) for k, v in scales.items()},
                    dtypes=dict(qm.get("dtypes", {})))
            elif seg.quant is not None:
                seg.quant.scales = {k: self._on_device(v)
                                    for k, v in seg.quant.scales.items()}
        else:
            self._wait_host(seg)
            seg.caches = _tree_map(self._on_device, seg.caches)
            if seg.quant is not None:
                seg.quant.scales = {k: self._on_device(v)
                                    for k, v in seg.quant.scales.items()}
        seg.tier = "device"
        self.promotions[src] += 1
        self.promoted_bytes += seg.nbytes

    def promote(self, sid: str) -> StoredSegment:
        """Explicitly promote ``sid`` to device (no hit accounting)."""
        seg = self._segs[sid]
        self._promote(seg)
        return seg

    def prefetch(self, doc_id: str, *, upto: Optional[int] = None) -> int:
        """Promote a document's demoted segments ahead of use, unless its
        observed reuse prior is below ``prefetch_min_prior``; segments at
        or past ``upto`` stay.  Returns the number promoted."""
        if doc_id not in self._indexes:
            return 0
        if self.admission_prior(doc_id) < self.prefetch_min_prior:
            return 0
        n = 0
        for sid, rng in list(self.index(doc_id).items()):
            if upto is not None and rng.lo >= upto:
                continue
            seg = self._segs.get(sid)
            if seg is not None and seg.tier != "device":
                self._promote(seg)
                n += 1
        self.prefetches += n
        return n

    def prefetch_ids(self, ids) -> int:
        """Promote the listed segments (a plan's reuse steps, pinned by the
        caller) before the build consumes them.  Returns the number
        promoted."""
        n = 0
        for sid in ids:
            if sid is None:
                continue
            seg = self._segs.get(sid)
            if seg is not None and seg.tier != "device":
                self._promote(seg)
                n += 1
        self.prefetches += n
        return n

    # -- persistence (PinnedStore hooks) -----------------------------------
    # One entry file per segment (the cache tree flattened by flatten_tree,
    # its structure in the manifest) plus store-level metadata: the bucket
    # granularity, the id sequence and the observed per-document traffic.
    # created_by is process-local and is not persisted.

    def _serialize_entry(self, seg: StoredSegment) -> tuple[dict, dict]:
        if seg.caches is None:
            # disk tier: the payload lives in the spill file or, mid-write,
            # in the pending arrays
            record = dict(seg.spill["record"])
            leaves, scales = self._load_spill_payload(seg)
            arrays = {f"leaf_{j}": np.asarray(x) for j, x in enumerate(leaves)}
            for k, s in scales.items():
                arrays[f"qscale_{k}"] = np.asarray(s)
            return arrays, record
        self._wait_host(seg)
        spec, leaves = flatten_tree(seg.caches)
        return (self._payload_arrays(leaves, seg.quant),
                self._segment_record(seg, spec))

    def _entry_file_source(self, key: str, entry: StoredSegment):
        src = super()._entry_file_source(key, entry)
        if src is not None:
            return src
        # a disk-tier segment's spill file *is* its snapshot entry
        sp = entry.spill
        if sp is not None and sp.get("sha256") and entry.pending_arrays is None:
            rec = dict(sp["record"])
            rec["sha256"] = sp["sha256"]
            return Path(sp["file"]), rec
        return None

    def _entry_manifest(self, seg: StoredSegment) -> dict:
        # fields that change after the payload freezes
        return {"doc_id": seg.doc_id,
                "aliases": sorted(seg.aliases),
                "cross_session_hits": seg.cross_session_hits,
                "tier": seg.tier}

    def _deserialize_entry(self, rec: dict, arrays) -> str:
        rng = Range(rec["lo"], rec["hi"])
        # honor the recorded tier when this store has it configured
        tier = rec.get("tier", "device")
        if tier == "host" and self.host_budget is None:
            tier = "device"
        if tier == "disk" and (self.spill_dir is None or "nbytes" not in rec
                               or self._load_src is None):
            tier = "device"
        if tier == "device":
            n_leaf = sum(1 for k in arrays.files if k.startswith("leaf_"))
            leaves = [arrays[f"leaf_{j}"] for j in range(n_leaf)]
            caches = unflatten_tree(rec["tree"], leaves, leaf_fn=self._on_device)
            sid = self.put(rng, caches, doc_id=rec["doc_id"], seg_id=rec["seg_id"],
                           quant=self._quant_from_record(rec, arrays, self._on_device))
        else:
            sid = self._insert_demoted(rec, arrays, rng, tier)
        seg = self._segs.get(sid)
        if seg is None:
            return sid    # shed by a tighter budget on its own insertion
        seg.cross_session_hits = int(rec.get("cross_session_hits", 0))
        for alias_doc in rec.get("aliases", []):
            seg.aliases.add(alias_doc)
            self.index(alias_doc).add(sid, rng)
        return sid

    def _host_leaf(self, a: np.ndarray) -> torch.Tensor:
        t = to_torch(a)
        return t.pin_memory() if self.device.type == "cuda" else t.clone()

    def _insert_demoted(self, rec: dict, arrays, rng: Range,
                        tier: str) -> str:
        """Reload a snapshot entry into its recorded lower tier: host
        entries as CPU tensors, disk entries as metadata only (the
        snapshot's npz file is hard-linked into the spill dir)."""
        sid = rec["seg_id"]
        old = self._segs.get(sid)
        if old is not None:
            self._drop_spill(old)
        seg = StoredSegment(sid, rng, None, doc_id=rec["doc_id"],
                            valid=int(rec["valid"]), tier=tier,
                            capacity=int(rec["capacity"]))
        if tier == "host":
            n_leaf = sum(1 for k in arrays.files if k.startswith("leaf_"))
            leaves = [self._host_leaf(arrays[f"leaf_{j}"]) for j in range(n_leaf)]
            seg.caches = unflatten_tree(rec["tree"], leaves)
            seg.quant = self._quant_from_record(rec, arrays, self._host_leaf)
            if seg.quant is not None:
                seg.precision = "int8"
            seg.__dict__["nbytes"] = cache_nbytes(seg.caches) + \
                (seg.quant.nbytes() if seg.quant is not None else 0)
        else:
            seg.__dict__["nbytes"] = int(rec["nbytes"])
            path = self._spill_path(sid)
            if path.exists():
                path.unlink()
            _link_or_copy(self._load_src, path)
            record = {k: rec[k] for k in ("seg_id", "lo", "hi", "valid",
                                          "capacity", "nbytes", "tree")}
            record["precision"] = rec.get("precision", "fp32")
            if "quant" in rec:
                record["quant"] = rec["quant"]
            seg.precision = record["precision"]
            seg.spill = {"file": str(path), "record": record,
                         "sha256": rec["sha256"]}
        self._segs[sid] = seg
        self.index(rec["doc_id"]).add(sid, rng)
        self._doc_stats.setdefault(rec["doc_id"], [0, 0])[0] += 1
        self._maybe_evict()
        return sid

    def _quant_from_record(self, rec: dict, arrays, as_leaf) -> Optional[QuantMeta]:
        """The int8 sidecar of a reloaded quantized entry (its ``qscale_{j}``
        arrays through ``as_leaf``), or ``None`` for a model-precision one.
        Disk entries keep their scales in the npz: :meth:`_promote` builds
        the sidecar on first touch."""
        if rec.get("precision") != "int8":
            return None
        qm = rec.get("quant", {})
        scales = {k[len("qscale_"):]: as_leaf(arrays[k])
                  for k in arrays.files if k.startswith("qscale_")}
        return QuantMeta(block=int(qm.get("block", self.seq_bucket)),
                         scales=scales, dtypes=dict(qm.get("dtypes", {})))

    def _store_meta(self) -> dict:
        return {
            "seq_bucket": self.seq_bucket,
            "seq": self._seq,
            "doc_stats": {d: list(v) for d, v in self._doc_stats.items()},
        }

    def _apply_store_meta(self, meta: dict) -> None:
        # the manifest's bucket wins: resident shapes were padded for it
        self.seq_bucket = int(meta.get("seq_bucket", self.seq_bucket))

    def _finish_load(self, meta: dict) -> None:
        # the snapshot's observed traffic is the honest history
        ds = meta.get("doc_stats")
        if ds is not None:
            self._doc_stats = {d: [int(p), int(h)] for d, (p, h) in ds.items()}
        self._seq = max(self._seq, int(meta.get("seq", 0)))
        super()._finish_load(meta)

    @classmethod
    def load(cls, path, *, byte_budget: Optional[int] = None,
             cost_model: Optional[CostModel] = None,
             policy: Optional[str] = None,
             host_budget: Optional[int] = None,
             spill_dir: Optional[str | Path] = None,
             tier_policy: str = "tiered",
             precision: str = "auto",
             writer: Optional[BackgroundWriter] = None,
             verify: bool = True,
             device="cuda") -> "SegmentStore":
        """Rebuild a serving store from a snapshot of either package.

        The snapshot dictates ``seq_bucket``; budget, cost model, policy,
        tiers and ``device`` are fresh runtime choices.  Entries whose
        recorded tier is configured here reload into it (device entries
        onto ``device``, host entries as CPU tensors, disk entries stay on
        disk, their files linked into ``spill_dir``); without tiers every
        entry loads to the device.  Entries saved as int8 reload as int8
        whatever ``precision`` says (their fp32 payload is gone).
        """
        return super().load(path, verify=verify, byte_budget=byte_budget,
                            cost_model=cost_model, policy=policy,
                            host_budget=host_budget, spill_dir=spill_dir,
                            tier_policy=tier_policy, precision=precision,
                            writer=writer, device=device)


def segment_from_record(rec: dict, arrays, *, device="cuda") -> StoredSegment:
    """Materialize a transient device-resident segment from the npz entry
    format (a record plus its arrays), outside any store."""
    device = torch.device(device)
    on_device = lambda a: to_torch(a).to(device)  # noqa: E731
    n_leaf = sum(1 for k in arrays.files if k.startswith("leaf_"))
    leaves = [arrays[f"leaf_{j}"] for j in range(n_leaf)]
    caches = unflatten_tree(rec["tree"], leaves, leaf_fn=on_device)
    seg = StoredSegment(rec["seg_id"], Range(int(rec["lo"]), int(rec["hi"])),
                        caches, doc_id=rec.get("doc_id", DEFAULT_DOC),
                        valid=int(rec["valid"]),
                        capacity=int(rec["capacity"]))
    if rec.get("precision") == "int8":
        qm = rec.get("quant", {})
        scales = {k[len("qscale_"):]: on_device(arrays[k])
                  for k in arrays.files if k.startswith("qscale_")}
        seg.precision = "int8"
        seg.quant = QuantMeta(block=int(qm.get("block", 0) or 1),
                              scales=scales,
                              dtypes=dict(qm.get("dtypes", {})))
    return seg
