"""Consistent-hash sharded segment store with coalesced, hedged remote fetch.

The counterpart of ``repro.serve.shard_store``.  ``ShardedSegmentStore``
spreads document-keyed KV segments over N shard :class:`SegmentStore`s —
simulated in-process hosts, each with its own device/host/disk tiers and
byte budgets, all on one device.  The facade *is* shard 0 (it subclasses
``SegmentStore``, so every local code path — eviction, tiering,
quantization, snapshots — is the single-shard behaviour), and shards
1..N-1 hang off it as ``remotes``.

Placement is a deterministic sha256 ring over content keys (``doc_id``),
independent of ``PYTHONHASHSEED`` and the same as ``repro``'s: every
process, restart, host and package agrees where a document lives.  Reads
route through the planner's existing seams:

  * ``index(doc_id)`` for a remote-homed document returns an *ephemeral*
    view of the home shard's descriptors, filtered to segments worth
    shipping (``CostModel.fetch_action``) from a shard that is alive and
    not hedged away — so the planner prices remote-fetch vs local-rebuild
    vs miss in the ordinary F(n)/C(M) vocabulary, with ``segment_bytes``
    translating wire cost into equivalent local-load bytes;
  * ``prefetch``/``prefetch_batch``/``prefetch_ids`` are the coalescing
    points: all wanted segments on one shard ride **one** batched
    transfer per scheduler tick (``ShardTransport`` accounts the
    contract);
  * a fetched payload lands as a transient device segment in the fetch
    cache and ``get`` serves it to the builder exactly like a resident.

Payloads ride the snapshot entry format (manifest record + ``leaf_*``/
``qscale_*`` arrays), quantized to blockwise int8 at the sender (on the
store's device) and deflated by ``distributed.compression.pack_arrays``;
the receiver inflates them onto the store's device, and the reuse path
dequantizes them through the ``quant_kv`` kernel like any int8 resident.
Writes route to the home shard (write-through off the latency path,
priced by byte counters); the home copy stays lossless, so every fetch
re-quantizes the same source and repeated fetches are deterministic.

Hedging: ``ShardTransport`` wires ``HeartbeatMonitor``/``StragglerDetector``
into every transfer.  When a shard's *observed* estimate exceeds the
hedge deadline (or the detector flags it, or its heartbeat is stale),
the fetch races a backup local rebuild: the race is resolved against
``CostModel.recompute_s`` — if the rebuild wins, the fetch is cancelled
and the planner sees an empty remote view (it rebuilds locally through
the extend kernel); if the fetch still wins, it proceeds.

Device: the shards share one device.  ``device=None`` takes it from the
first segment put on *any* shard, and a fetched segment always lands on
it; a store with no device yet has nothing to fetch.
"""
from __future__ import annotations

import bisect
import hashlib
import json
from pathlib import Path
from typing import Optional

from repro_torch.core.cost import CostModel
from repro_torch.core.descriptors import DescriptorIndex, Range
from repro_torch.core.quant import quantize_tree
from repro_torch.core.store import BackgroundWriter, PinnedStore, flatten_tree
from repro_torch.distributed.compression import pack_arrays, unpack_arrays
from repro_torch.distributed.transport import ShardTransport
from repro_torch.serve.kv_cache import (
    DEFAULT_DOC,
    SegmentStore,
    StoredSegment,
    segment_from_record,
)

WIRE_PRECISIONS = ("int8", "fp32")


def resolve_wire_precision(value: str = "int8") -> str:
    """A cross-shard payload precision, validated (default ``"int8"``)."""
    if value not in WIRE_PRECISIONS:
        raise ValueError(f"unknown wire precision {value!r}; "
                         f"expected one of {WIRE_PRECISIONS}")
    return value


class HashRing:
    """Deterministic consistent-hash ring (sha256, virtual nodes).

    Placement depends only on the key bytes and the shard count — never
    on ``PYTHONHASHSEED`` or dict order — so every process and host
    computes the same home shard, and growing the ring moves only
    ~1/N of the keys.
    """

    def __init__(self, n_shards: int, *, vnodes: int = 64) -> None:
        self.n_shards = int(n_shards)
        pts = []
        for s in range(self.n_shards):
            for v in range(vnodes):
                pts.append((self._point(f"shard-{s}#{v}"), s))
        pts.sort()
        self._keys = [p[0] for p in pts]
        self._owners = [p[1] for p in pts]

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")

    def place(self, key: str) -> int:
        """Home shard of ``key``: the first ring point at or after its hash."""
        i = bisect.bisect_right(self._keys, self._point(key))
        return self._owners[i % len(self._owners)]


# -- wire codec --------------------------------------------------------------

def encode_segment(owner: SegmentStore, seg: StoredSegment, *,
                   precision: str = "int8") -> bytes:
    """Serialize one resident segment for the wire.

    Frame: 4-byte big-endian header length, JSON manifest record (the
    snapshot record plus ``doc_id``), then the ``pack_arrays`` payload.
    Model-precision residents quantize to blockwise int8 at the sender
    (idempotent for already-int8 residents; ``precision="fp32"`` ships
    the resident as stored, lossless).  The arrays reach numpy through
    ``flatten_tree`` (a device tensor is copied to the host, bf16 as
    ``|V2``), so the frame is ``repro``'s for the same payload.
    """
    caches, quant, prec = seg.caches, seg.quant, seg.precision
    if caches is None:
        raise ValueError(f"segment {seg.seg_id} has no resident payload; "
                         f"promote before encoding")
    if precision == "int8" and prec == "fp32":
        qtree, meta = quantize_tree(caches, block=owner.seq_bucket)
        if meta.scales:
            caches, quant, prec = qtree, meta, "int8"
    spec, leaves = flatten_tree(caches)
    rec = {
        "seg_id": seg.seg_id,
        "doc_id": seg.doc_id,
        "lo": seg.rng.lo,
        "hi": seg.rng.hi,
        "valid": seg.valid,
        "capacity": seg.capacity,
        "tree": spec,
        "precision": prec,
    }
    if quant is not None:
        rec["quant"] = quant.manifest()
    payload = pack_arrays(SegmentStore._payload_arrays(leaves, quant))
    header = json.dumps(rec).encode()
    return len(header).to_bytes(4, "big") + header + payload


def decode_segment(data: bytes, *, device) -> StoredSegment:
    """Inverse of :func:`encode_segment`: a transient segment on
    ``device`` (int8 payload + scale sidecar when quantized) owned by no
    store — the receiver parks it in its fetch cache."""
    hlen = int.from_bytes(data[:4], "big")
    rec = json.loads(data[4:4 + hlen].decode())
    arrays = unpack_arrays(data[4 + hlen:])
    return segment_from_record(rec, arrays, device=device)


class ShardedSegmentStore(SegmentStore):
    """N consistent-hash shards behind the single-store API.

    The facade is shard 0; ``byte_budget``/``host_budget``/``spill_dir``
    are **per shard** (``spill_dir`` fans out into ``shard-XX``
    subdirectories, as do snapshots).  ``fetch=False`` degrades reads to
    shard-local-only — placement still routes writes to their home, but
    remote documents plan as misses.  ``device`` is every shard's device
    (``None``: the device of the first segment put on any shard).
    """

    def __init__(self, n_shards: int, byte_budget: Optional[int] = None, *,
                 cost_model: Optional[CostModel] = None,
                 policy: Optional[str] = None,
                 seq_bucket: int = 64,
                 host_budget: Optional[int] = None,
                 spill_dir: Optional[str | Path] = None,
                 tier_policy: str = "tiered",
                 precision: str = "auto",
                 writer: Optional[BackgroundWriter] = None,
                 transport: Optional[ShardTransport] = None,
                 bw_bytes_per_s: Optional[float] = None,
                 rtt_s: Optional[float] = None,
                 hedge_deadline_s: float = 0.05,
                 fetch: bool = True,
                 wire_precision: str = "int8",
                 fetch_cache_bytes: Optional[int] = None,
                 vnodes: int = 64,
                 device=None) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        root = Path(spill_dir) if spill_dir is not None else None
        super().__init__(byte_budget, cost_model=cost_model, policy=policy,
                         seq_bucket=seq_bucket, host_budget=host_budget,
                         spill_dir=(root / "shard-00" if root else None),
                         tier_policy=tier_policy, precision=precision,
                         writer=writer, device=device)
        self.ring = HashRing(n_shards, vnodes=vnodes)
        self.remotes = [
            SegmentStore(byte_budget, cost_model=self.cost, policy=policy,
                         seq_bucket=seq_bucket, host_budget=host_budget,
                         spill_dir=(root / f"shard-{i:02d}" if root else None),
                         tier_policy=tier_policy, precision=precision,
                         writer=writer, device=device)
            for i in range(1, n_shards)
        ]
        # the transport's link calibration is the cost model's: the
        # planner's fetch_s and the simulated transfers must price the
        # same wire or the hedge race is decided on a different clock
        # than the fetches it cancels
        if bw_bytes_per_s is not None:
            self.cost.wire_bytes_per_s = float(bw_bytes_per_s)
        if rtt_s is not None:
            self.cost.wire_rtt_s = float(rtt_s)
        self.transport = transport or ShardTransport(
            n_shards, bw_bytes_per_s=self.cost.wire_bytes_per_s,
            rtt_s=self.cost.wire_rtt_s)
        self.hedge_deadline_s = hedge_deadline_s
        self.fetch_enabled = fetch
        self.wire_precision = resolve_wire_precision(wire_precision)
        #: transient fetched segments serving in-flight plans; bounded by
        #: drop-on-unpin plus this cap for plan-unused leftovers
        self._fetched: dict[str, StoredSegment] = {}
        self._fetched_bytes = 0
        if fetch_cache_bytes is None and byte_budget is not None:
            fetch_cache_bytes = 4 * byte_budget
        self.fetch_cache_bytes = fetch_cache_bytes
        #: per-document fetch decision memo: doc -> (transport tick, view)
        self._views: dict[str, tuple[int, Optional[list]]] = {}
        # fetch-path counters (shard_report flattens these)
        self.remote_fetches = 0        # segments shipped
        self.fetched_wire_bytes = 0    # encoded bytes on the wire
        self.fetched_hits = 0          # builder gets served from the cache
        self.on_demand_fetches = 0     # gets that missed the prefetch batch
        self.hedged_fetches = 0        # fetch decisions that raced a rebuild
        self.hedge_rebuild_wins = 0    # races the local rebuild won
        self.hedge_fetch_wins = 0      # races the fetch still won
        self.cancelled_fetches = 0     # segments whose fetch lost the race
        self.dead_shard_skips = 0      # docs served locally: home was dead
        self.put_forwards = 0          # writes routed to a remote home
        self.put_forward_bytes = 0     # their (estimated int8) wire bytes
        self.cross_shard_alias_skips = 0
        self.cross_shard_rekeys = 0
        self.migrated_segments = 0

    # -- placement ---------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return 1 + len(self.remotes)

    def shard_of(self, doc_id: str) -> int:
        return self.ring.place(doc_id)

    def shard_store(self, shard: int) -> SegmentStore:
        return self if shard == 0 else self.remotes[shard - 1]

    def _shards(self) -> list[SegmentStore]:
        return [self] + self.remotes

    def _locate(self, sid: str) -> Optional[tuple[int, SegmentStore]]:
        """Owning shard of a segment id (N is small; no owner map)."""
        for i, st in enumerate(self._shards()):
            if sid in st._segs:
                return i, st
        return None

    def _adopt_device(self, device) -> None:
        """Give every shard still without a device ``device`` (the first
        put on any shard decides, as a plain store's first put does)."""
        for st in self._shards():
            if st.device is None:
                st.device = device

    # -- fetch decisions ---------------------------------------------------
    def _wire_nbytes(self, seg: StoredSegment) -> int:
        """Estimated wire size: int8 shrink applies only to model-precision
        residents (already-int8 payloads ship as stored)."""
        if self.wire_precision == "int8" and seg.precision == "fp32":
            return max(int(seg.nbytes * self.cost.int8_bytes_ratio), 1)
        return seg.nbytes

    def _fetch_equiv_bytes(self, wire_nb: int, n_items: int) -> int:
        """Translate a wire fetch into equivalent local-load bytes so the
        planner's C(M) prices it: use_model(equiv) ≈ fetch_s + dequantize_s,
        with the per-transfer RTT amortized over the doc's batched items."""
        cm = self.cost
        s = cm.fetch_s(wire_nb, rtt=cm.wire_rtt_s / max(n_items, 1)) \
            + cm.dequantize_s(wire_nb)
        return max(int((s - cm.model_fixed_s) * cm.model_bytes_per_s), 1)

    def _decide_fetch(self, doc_id: str, *, refresh: bool = False):
        """Resolve this tick's fetch plan for a remote-homed document.

        Returns the fetch-worthy ``[(sid, rng, wire_nb)]`` — possibly
        empty when the home shard is dead, the hedge race chose the local
        rebuild, or nothing is worth shipping.  Memoized so the prefetch
        that fetches and the ``index()`` the planner reads agree within a
        tick; a new prefetch (``refresh=True``) re-decides with fresh
        health estimates.
        """
        tick = self.transport.ticks
        if not refresh:
            cached = self._views.get(doc_id)
            if cached is not None and tick - cached[0] <= 1:
                return cached[1]
        view = self._decide_fetch_now(doc_id)
        self._views[doc_id] = (self.transport.ticks, view)
        return view

    def _decide_fetch_now(self, doc_id: str):
        home = self.shard_of(doc_id)
        owner = self.shard_store(home)
        items = [(sid, rng, self._wire_nbytes(owner._segs[sid]))
                 for sid, rng in owner.index(doc_id).items()
                 if sid in owner._segs]
        if not items:
            return []
        tr = self.transport
        if not tr.alive(home):
            self.dead_shard_skips += 1
            return []
        total_wire = sum(nb for _, _, nb in items)
        est = tr.estimate_fetch_s(home, total_wire)
        if est > self.hedge_deadline_s or home in tr.straggler_shards():
            # hedge: race the fetch against a backup local rebuild of the
            # same tokens; the simulation resolves first-done-wins on the
            # cost model's clock and cancels the loser up front
            self.hedged_fetches += 1
            rebuild = self.cost.recompute_s(sum(r.size for _, r, _ in items))
            if rebuild <= est:
                self.hedge_rebuild_wins += 1
                self.cancelled_fetches += len(items)
                return []
            self.hedge_fetch_wins += 1
        return [(sid, rng, nb) for sid, rng, nb in items
                if self.cost.fetch_action(rng.size, nb) == "fetch"]

    # -- fetch execution ---------------------------------------------------
    def _cache_fetched(self, seg: StoredSegment) -> None:
        seg.fetched = True           # reuse-path attribution (builder stats)
        old = self._fetched.pop(seg.seg_id, None)
        if old is not None:
            self._fetched_bytes -= old.nbytes
        self._fetched[seg.seg_id] = seg
        self._fetched_bytes += seg.nbytes
        cap = self.fetch_cache_bytes
        if cap is None:
            return
        for sid in list(self._fetched):
            if self._fetched_bytes <= cap:
                break
            if sid in self._pins or sid == seg.seg_id:
                continue
            self._fetched_bytes -= self._fetched.pop(sid).nbytes

    def _fetch_batch(self, groups: dict[int, list[str]]) -> int:
        """One scheduler tick of remote fetches: for each contacted shard,
        encode its batch, ride one transfer, decode into the fetch cache."""
        groups = {sh: ids for sh, ids in groups.items() if ids}
        if not groups or not self.fetch_enabled:
            return 0
        if self.device is None:
            raise RuntimeError("sharded store has no device: nothing was put")
        tr = self.transport
        tr.begin_tick()
        n = 0
        for shard, ids in sorted(groups.items()):
            owner = self.shard_store(shard)
            blobs = []
            for sid in ids:
                if sid not in owner._segs:
                    continue
                # owner-side hit: promotes cold tiers and feeds the home
                # shard's retention/prior accounting
                seg = owner.get(sid)
                blobs.append(encode_segment(owner, seg,
                                            precision=self.wire_precision))
            if not blobs:
                continue
            nbytes = sum(len(b) for b in blobs)
            tr.transfer(shard, nbytes, items=len(blobs))
            for blob in blobs:
                self._cache_fetched(decode_segment(blob, device=self.device))
            self.remote_fetches += len(blobs)
            self.fetched_wire_bytes += nbytes
            n += len(blobs)
        return n

    # -- store API: reads --------------------------------------------------
    def index(self, doc_id: str = DEFAULT_DOC) -> DescriptorIndex:
        if self.shard_of(doc_id) == 0:
            return super().index(doc_id)
        idx = DescriptorIndex()
        if not self.fetch_enabled:
            return idx
        for sid, rng, _ in self._decide_fetch(doc_id) or []:
            idx.add(sid, rng)
        return idx

    def segment_bytes(self, doc_id: str = DEFAULT_DOC) -> dict[str, int]:
        if self.shard_of(doc_id) == 0:
            return super().segment_bytes(doc_id)
        view = self._decide_fetch(doc_id) if self.fetch_enabled else []
        view = view or []
        return {sid: self._fetch_equiv_bytes(nb, len(view))
                for sid, _, nb in view}

    def capacity(self, sid: str) -> int:
        if sid in self._segs:
            return super().capacity(sid)
        if sid in self._fetched:
            return self._fetched[sid].capacity
        loc = self._locate(sid)
        if loc is None:
            raise KeyError(sid)
        return loc[1].capacity(sid)

    def get(self, sid: str, *, requester: Optional[int] = None) -> StoredSegment:
        if sid in self._segs:
            return super().get(sid, requester=requester)
        seg = self._fetched.get(sid)
        if seg is None:
            # plan committed to a segment the prefetch batch missed (sync
            # path, or a view refresh raced it): fetch it now, alone on
            # its own tick
            loc = self._locate(sid)
            if loc is None or not self.fetch_enabled:
                raise KeyError(sid)
            self.on_demand_fetches += 1
            self._fetch_batch({loc[0]: [sid]})
            seg = self._fetched[sid]
        self.fetched_hits += 1
        seg.hits += 1
        return seg

    def observed_reuses(self, doc_id: str) -> float:
        home = self.shard_of(doc_id)
        if home == 0:
            return super().observed_reuses(doc_id)
        return self.shard_store(home).observed_reuses(doc_id)

    def admission_prior(self, doc_id: str) -> float:
        home = self.shard_of(doc_id)
        if home == 0:
            return super().admission_prior(doc_id)
        return self.shard_store(home).admission_prior(doc_id)

    def __contains__(self, sid: str) -> bool:
        return self._locate(sid) is not None or sid in self._fetched

    # -- store API: writes -------------------------------------------------
    def put(self, rng: Range, caches, *, doc_id: str = DEFAULT_DOC,
            created_by: Optional[int] = None,
            seg_id: Optional[str] = None, quant=None) -> str:
        home = self.shard_of(doc_id)
        if home == 0:
            sid = super().put(rng, caches, doc_id=doc_id,
                              created_by=created_by, seg_id=seg_id,
                              quant=quant)
            self._adopt_device(self.device)
            return sid
        # write-through to the home shard: the transfer rides the
        # non-latency-critical background path, so it is priced (put
        # counters, estimated int8 wire bytes) but not raced or ticked;
        # the payload lands as put, so every future fetch re-quantizes
        # the same source (deterministic wire bytes)
        owner = self.shard_store(home)
        sid = owner.put(rng, caches, doc_id=doc_id, created_by=created_by,
                        seg_id=seg_id, quant=quant)
        self._adopt_device(owner.device)
        seg = owner._segs.get(sid)
        self.put_forwards += 1
        if seg is not None:
            self.put_forward_bytes += self._wire_nbytes(seg)
        return sid

    def alias(self, src_doc: str, dst_doc: str, *,
              upto: Optional[int] = None) -> int:
        src_home, dst_home = self.shard_of(src_doc), self.shard_of(dst_doc)
        if src_home != dst_home:
            # a fork whose content key hashes elsewhere re-prefills (or
            # fetches) instead of sharing metadata across hosts
            self.cross_shard_alias_skips += 1
            return 0
        if src_home == 0:
            return super().alias(src_doc, dst_doc, upto=upto)
        return self.shard_store(src_home).alias(src_doc, dst_doc, upto=upto)

    def release_doc(self, doc_id: str) -> int:
        home = self.shard_of(doc_id)
        if home == 0:
            return super().release_doc(doc_id)
        return self.shard_store(home).release_doc(doc_id)

    def rekey(self, old_doc: str, new_doc: str, *, upto: int) -> int:
        src_home, dst_home = self.shard_of(old_doc), self.shard_of(new_doc)
        if src_home == dst_home:
            st = self.shard_store(src_home)
            if st is self:
                return super().rekey(old_doc, new_doc, upto=upto)
            return st.rekey(old_doc, new_doc, upto=upto)
        # an edit moved the content key to a different home: migrate the
        # surviving prefix physically (promote disk entries first — spill
        # files belong to the old host's dir)
        src = self.shard_store(src_home)
        dst = self.shard_store(dst_home)
        src_idx = (SegmentStore.index(src, old_doc) if src is self
                   else src.index(old_doc))
        dst_idx = (SegmentStore.index(dst, new_doc) if dst is self
                   else dst.index(new_doc))
        moved = 0
        for sid, rng in list(src_idx.items()):
            if rng.hi > upto:
                continue
            seg = src._segs.get(sid)
            if seg is None or sid in src._pins:
                continue
            if seg.tier == "disk":
                src._promote(seg)
            src._drop_spill(seg)
            for alias_doc in list(seg.aliases):
                alias_idx = src._indexes.get(alias_doc)
                if alias_idx is not None and sid in alias_idx:
                    alias_idx.remove(sid)
            src_idx.remove(sid)
            del src._segs[sid]
            seg.doc_id = new_doc
            seg.aliases = set()
            seg.spill = None
            seg.pending_arrays = None
            dst._segs[sid] = seg
            if sid not in dst_idx:
                dst_idx.add(sid, rng)
            moved += 1
        stats = src._doc_stats.pop(old_doc, None)
        if stats is not None:
            agg = dst._doc_stats.setdefault(new_doc, [0, 0])
            agg[0] += stats[0]
            agg[1] += stats[1]
        dst._maybe_evict()
        self.cross_shard_rekeys += 1
        self.migrated_segments += moved
        self.rekeyed_segments += moved
        return moved

    # -- pins --------------------------------------------------------------
    def pin(self, ids) -> tuple:
        # pin locally (guards the fetch cache and local residents) *and*
        # on each owning shard (guards the remote residents a plan reads)
        token = super().pin(ids)
        for sid in token:
            if sid in self._segs or sid in self._fetched:
                continue
            loc = self._locate(sid)
            if loc is not None and loc[0] != 0:
                loc[1].pin([sid])
        return token

    def unpin(self, token) -> None:
        for sid in token:
            if sid in self._segs:
                continue
            loc = self._locate(sid)
            if loc is not None and loc[0] != 0:
                loc[1].unpin([sid])
        super().unpin(token)
        # a consumed fetch is done once its plan releases it; the next
        # round re-fetches (that is the cross-shard serving cost)
        for sid in token:
            seg = self._fetched.get(sid)
            if seg is not None and sid not in self._pins:
                self._fetched_bytes -= seg.nbytes
                del self._fetched[sid]

    # -- prefetch: the coalescing points ----------------------------------
    def prefetch(self, doc_id: str, *, upto: Optional[int] = None) -> int:
        if self.shard_of(doc_id) == 0:
            return super().prefetch(doc_id, upto=upto)
        return self.prefetch_batch([(doc_id, upto)])

    def prefetch_batch(self, items) -> int:
        """Resolve many documents' remote segments in one scheduler tick:
        every contacted shard gets exactly one batched transfer.  Local
        documents fall through to the ordinary tier prefetch."""
        groups: dict[int, list[str]] = {}
        n = 0
        for doc_id, upto in items:
            home = self.shard_of(doc_id)
            if home == 0:
                n += super().prefetch(doc_id, upto=upto)
                continue
            if not self.fetch_enabled:
                continue
            view = self._decide_fetch(doc_id, refresh=True) or []
            wanted = [sid for sid, rng, _ in view
                      if (upto is None or rng.lo < upto)
                      and sid not in self._fetched]
            if wanted:
                groups.setdefault(home, []).extend(wanted)
        return n + self._fetch_batch(groups)

    def prefetch_ids(self, ids) -> int:
        local = [i for i in ids if i in self._segs]
        n = super().prefetch_ids(local) if local else 0
        groups: dict[int, list[str]] = {}
        for sid in ids:
            if sid in self._segs or sid in self._fetched or sid is None:
                continue
            loc = self._locate(sid)
            if loc is not None and loc[0] != 0:
                groups.setdefault(loc[0], []).append(sid)
        return n + self._fetch_batch(groups)

    # -- aggregate views ---------------------------------------------------
    def total_segments(self) -> int:
        return sum(len(st._segs) for st in self._shards())

    def total_nbytes(self) -> int:
        return sum(st.nbytes() for st in self._shards())

    def doc_ids(self) -> list[str]:
        ids = set()
        for st in self._shards():
            ids.update(SegmentStore.doc_ids(st))
        return sorted(ids)

    def shard_summaries(self) -> list[dict]:
        """Per-shard occupancy, one flat dict per shard (all finite on an
        idle store)."""
        out = []
        for i, st in enumerate(self._shards()):
            tiers = st.tier_bytes()
            out.append({
                "shard": i,
                "segments": len(st._segs),
                "device_bytes": tiers.get("device", 0),
                "host_bytes": tiers.get("host", 0),
                "disk_bytes": tiers.get("disk", 0),
                "evictions": st.evictions,
                "hits": sum(h for _, h in st._doc_stats.values()),
                "docs": len(st._doc_stats),
            })
        return out

    def shard_report(self) -> dict:
        """Flat fetch/occupancy counters for ``SessionManager.report()``."""
        rep = {
            "shards": self.n_shards,
            "remote_fetches": self.remote_fetches,
            "remote_fetch_wire_bytes": self.fetched_wire_bytes,
            "fetched_hits": self.fetched_hits,
            "on_demand_fetches": self.on_demand_fetches,
            "hedged_fetches": self.hedged_fetches,
            "hedge_rebuild_wins": self.hedge_rebuild_wins,
            "hedge_fetch_wins": self.hedge_fetch_wins,
            "cancelled_fetches": self.cancelled_fetches,
            "dead_shard_skips": self.dead_shard_skips,
            "put_forwards": self.put_forwards,
            "put_forward_bytes": self.put_forward_bytes,
            "cross_shard_alias_skips": self.cross_shard_alias_skips,
            "cross_shard_rekeys": self.cross_shard_rekeys,
        }
        rep.update(self.transport.report())
        for s in self.shard_summaries():
            i = s["shard"]
            for k in ("segments", "device_bytes", "host_bytes", "hits"):
                rep[f"shard{i}_{k}"] = s[k]
        return rep

    # -- persistence -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        root = Path(path)
        for i, st in enumerate(self._shards()):
            sub = root / f"shard-{i:02d}"
            if st is self:
                super().save(sub)
            else:
                st.save(sub)

    def save_async(self, path: str | Path) -> bool:
        root = Path(path)
        ok = True
        for i, st in enumerate(self._shards()):
            sub = root / f"shard-{i:02d}"
            if st is self:
                ok = super().save_async(sub) and ok
            else:
                ok = st.save_async(sub) and ok
        return ok

    def flush_saves(self) -> float:
        waited = super().flush_saves()
        for st in self.remotes:
            waited += st.flush_saves()
        return waited

    def compact_snapshot(self) -> Optional[dict]:
        stats = [st.compact_snapshot() if st is not self
                 else super().compact_snapshot() for st in self._shards()]
        if all(s is None for s in stats):
            return None
        return {
            "kept": sum(s["kept"] for s in stats if s),
            "dropped": sum(s["dropped"] for s in stats if s),
        }

    @classmethod
    def load(cls, path, *, n_shards: Optional[int] = None,
             verify: bool = True, device="cuda",
             **kw) -> "ShardedSegmentStore":
        """Rebuild a sharded store from a :meth:`save` tree of per-shard
        snapshot directories (either package's).  Shard 0 loads through
        the ordinary snapshot machinery into the facade itself (its
        ``put`` routes by home, so a consistent snapshot lands locally);
        the remotes load as plain stores and replace the facade's fresh
        ones.  Every shard loads onto ``device``."""
        root = Path(path)
        subdirs = sorted(d for d in root.glob("shard-*") if d.is_dir())
        if not subdirs:
            raise IOError(f"no shard-XX snapshot directories under {root}")
        if n_shards is None:
            n_shards = len(subdirs)
        if n_shards != len(subdirs):
            raise IOError(f"snapshot at {root} has {len(subdirs)} shards; "
                          f"asked to load {n_shards}")
        spill_root = kw.get("spill_dir")
        facade = PinnedStore.load.__func__(
            cls, subdirs[0], verify=verify, n_shards=n_shards,
            device=device, **kw)
        shard_kw = {k: kw[k] for k in
                    ("byte_budget", "policy", "host_budget", "tier_policy",
                     "precision", "writer")
                    if k in kw}
        shard_kw["cost_model"] = facade.cost
        for i, sub in enumerate(subdirs[1:], start=1):
            sd = (Path(spill_root) / f"shard-{i:02d}"
                  if spill_root is not None else None)
            facade.remotes[i - 1] = SegmentStore.load(
                sub, verify=verify, spill_dir=sd, device=device, **shard_kw)
        return facade
