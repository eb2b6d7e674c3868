"""Serving engine: descriptor-planned prefix reuse for one or many sessions.

A request for ``[0, L)`` of a document — a KV cache covering its first L
tokens — is planned with the paper's machinery: Dijkstra over segment
descriptors (directed/monoid case), stored segments vs. prefill priced by
a monotone cost model.  Gaps are prefilled in fixed-size chunks and each
chunk is materialized for future requests (paper Alg 2 with KV segments
in place of chunk models).

Two front ends drive a :class:`PrefixCacheBuilder`, which owns the model
entry points: :class:`ServeEngine` (one session over one document) and
:class:`repro_torch.serve.session.SessionManager` (N sessions over a
shared store, batched decode).  The builder has one build path: it
dispatches a build without waiting for the device and records its store
insertions on a :class:`PendingBuild`, landed by
:meth:`PrefixCacheBuilder.finalize_build` (the manager's async tickets)
or at once by :meth:`PrefixCacheBuilder.finish`, which also waits for the
device (``build_prefix``, ``prefix_with_logits``).  Reused int8 segments come
back to model precision through the ``quant_kv`` kernel
(:meth:`PrefixCacheBuilder._segment_caches`).

A cross-attention stack (whisper, llama-vision) conditions its KV on
**extras**, the context features a cold prefill at position 0 consumes
(``enc_feats`` / ``image_embeds``); every later chunk reads the context
K/V from the cache.  The front ends keep two copies: host arrays, the
bytes the document key hashes, and tensors on the device, placed once and
handed to every build.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cost import CostModel, serve_cost_model
from repro_torch.core.descriptors import Range
from repro_torch.core.optimizer import Plan, baseline_plan, shortest_plan
from repro_torch.kernels.common import bucket_len

from .kv_cache import (DEFAULT_DOC, SegmentStore, adopt_cache, cache_len,
                       chunk_segment, holds_state, insert_cache, pad_cache_to,
                       slice_cache)


@dataclass
class ServeStats:
    requests: int = 0
    tokens_reused: int = 0
    tokens_computed: int = 0
    tokens_decoded: int = 0
    planner_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    # every derived rate degrades to 0.0 (never NaN/inf) on zero traffic
    @property
    def reuse_frac(self) -> float:
        tot = self.tokens_reused + self.tokens_computed
        return self.tokens_reused / tot if tot else 0.0

    @property
    def prefill_tok_s(self) -> float:
        done = self.tokens_reused + self.tokens_computed
        return done / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        return (self.tokens_decoded / self.decode_s
                if self.decode_s > 0 else 0.0)


@dataclass
class PendingBuild:
    """Store side effects of one dispatched prefix build.

    A dispatch (:meth:`PrefixCacheBuilder.dispatch_prefix`) launches every
    gap's device work, records the chunk segments here in document order,
    and pins the plan's reuse segments under ``pin_token`` so eviction
    cannot reclaim what the queued work still reads.
    :meth:`PrefixCacheBuilder.finalize_build` inserts the recorded
    segments and releases the pins.  The recorded trees are copies whose
    values the device writes in stream order, so landing them never waits
    on the device.
    """
    doc_id: str
    requester: Optional[int]
    #: [(rng, segment cache tree)] in ascending document order
    puts: list = field(default_factory=list)
    pin_token: tuple = ()
    finalized: bool = False


def host_extras(extras: Optional[dict]) -> dict:
    """The extras as host numpy arrays (the document's identity, hashed
    by ``doc_key``): tensors on a card are copied off it here, once."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in (extras or {}).items()}


def device_extras(extras: Optional[dict], device) -> dict:
    """The extras as tensors on ``device`` (the model's batch entries)."""
    return {k: torch.as_tensor(v, device=device) for k, v in (extras or {}).items()}


def _sync(device: torch.device) -> None:
    """Wait for the device, so host clocks around it time the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PrefixCacheBuilder:
    """Plans and assembles KV prefix caches against a SegmentStore.

    Bucketed-cache invariants every entry point preserves:

      * caches returned by :meth:`build_prefix` / :meth:`prefix_with_logits`
        ride at capacity ``bucket_len(max(length, capacity), seq_bucket)``
        along the sequence axis;
      * ``start`` is a device tensor on the extend paths, so the kernels'
        launch configuration depends only on (cache bucket, chunk shape);
      * ``lowerings`` counts the distinct (cache capacity, chunk shape)
        pairs dispatched per entry point — the port's counterpart of the
        JAX package's per-shape executables, held to the same O(#buckets)
        bound.
    """

    def __init__(self, model, params, store: SegmentStore, *,
                 chunk_tokens: int = 64,
                 seq_bucket: int = 64,
                 cost_model: Optional[CostModel] = None,
                 device=None) -> None:
        self.model = model
        self.params = params
        self.store = store
        self.chunk = chunk_tokens
        self.seq_bucket = seq_bucket
        self.device = torch.device(model.device if device is None else device)
        self.cost = cost_model if cost_model is not None else serve_cost_model()
        self.lowerings = {"prefill": 0, "extend": 0, "extend_many": 0,
                          "insert": 0}
        self._shapes: dict[str, set] = {k: set() for k in self.lowerings}
        #: segments dequantized on the reuse path (int8 residents whose
        #: payload was reconstructed before it entered the cache)
        self.dequants = 0
        #: reuse steps served from a cross-shard fetch (0 off the sharded
        #: store, which alone marks segments ``fetched``)
        self.fetched_segments = 0
        #: :meth:`dispatch_prefix` calls (prefix_len ≥ 2) whose last prefix
        #: token rode the plan's ragged last gap, and those whose token ran
        #: in a 1-token extend of its own
        self.boundary_merged = 0
        self.boundary_alone = 0

    def _segment_caches(self, seg):
        """A reuse segment's caches at model precision.

        int8 residents reconstruct through the ``quant_kv`` kernel (its
        plain version on the CPU) before they are inserted: ``insert_cache``
        casts the segment to the destination dtype, so raw int8 codes would
        enter as magnitudes.  The stored copy stays int8.
        """
        if seg.fetched:
            self.fetched_segments += 1
        if seg.precision != "int8" or seg.quant is None:
            return seg.caches
        from repro_torch.core.quant import dequantize_tree

        self.dequants += 1
        return dequantize_tree(seg.caches, seg.quant)

    def _dispatch(self, key: str, shape: tuple) -> None:
        if shape not in self._shapes[key]:
            self._shapes[key].add(shape)
            self.lowerings[key] += 1

    @property
    def extend_lowerings(self) -> int:
        """Total distinct prefill/extend/insert shapes dispatched so far."""
        return sum(self.lowerings.values())

    @property
    def boundary_merged_share(self) -> float:
        """Share of :meth:`dispatch_prefix` calls (prefix_len ≥ 2) whose
        last prefix token rode the ragged last gap's extend."""
        n = self.boundary_merged + self.boundary_alone
        return self.boundary_merged / n if n else 0.0

    def _tokens(self, toks) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(toks, np.int64))
        if self.device.type == "cuda":
            # staged through pinned memory, so the copy is queued on the
            # stream instead of waited for (a dispatch never blocks)
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _scalar(self, x: int) -> torch.Tensor:
        # a fill on the device, not a host-to-device copy
        return torch.full((), x, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    def plan_prefix(self, length: int, *, doc_id: str = DEFAULT_DOC,
                    stats: Optional[ServeStats] = None) -> Plan:
        with obs.timed("serve.plan") as t:
            plan = shortest_plan(
                self.store.index(doc_id), Range(0, length), self.cost,
                self.store.segment_bytes(doc_id), directed=True,
            )
        if stats is not None:
            stats.planner_s += t.s
        return plan

    def build_prefix(self, doc: np.ndarray, length: int, *,
                     doc_id: str = DEFAULT_DOC,
                     extras: Optional[dict] = None,
                     stats: Optional[ServeStats] = None,
                     materialize: bool = True,
                     requester: Optional[int] = None,
                     capacity: Optional[int] = None):
        """Assemble the KV cache for document[:length] via the cheapest plan.

        Returns (caches, plan) with the caches' sequence axis padded to
        ``bucket_len(max(length, capacity), seq_bucket)``, the build landed
        and complete on the device (:meth:`_dispatch_build`, then
        :meth:`finish`).  ``extras`` (device tensors, :func:`device_extras`)
        join the batch of a cold prefill.
        """
        stats = stats if stats is not None else ServeStats()
        caches, plan, pending, _ = self._dispatch_build(
            doc, length, doc_id=doc_id, extras=extras or {}, stats=stats,
            materialize=materialize, requester=requester, capacity=capacity)
        self.finish(pending, stats)
        return caches, plan

    def _dispatch_build(self, doc, length: int, *, doc_id: str, extras: dict,
                        stats: ServeStats, materialize: bool,
                        requester: Optional[int], capacity: Optional[int],
                        boundary: bool = False):
        """Launch the build of document[:length] without waiting for the
        device (``prefill_s`` counts dispatch time only).

        Gaps are filled through ``prefill_extend`` /
        ``prefill_extend_many`` at the request's capacity; each chunk's
        segment is recorded on the returned :class:`PendingBuild` (none
        when ``materialize`` is False), and the plan's reuse segments stay
        pinned under its ``pin_token`` until :meth:`finalize_build`, which
        must run before any *other* store insertion.  With ``boundary``
        the plan's last gap may also take the token at ``length`` and
        return its logits (:meth:`_fill_gap`).  Returns ``(caches, plan,
        pending, logits)``, ``logits`` None unless that gap took it.
        """
        plan = self.plan_prefix(length, doc_id=doc_id, stats=stats)
        steps = sorted(plan.steps, key=lambda s: s.rng.lo)  # DAG path is ordered
        cap = bucket_len(max(length, capacity or 0), self.seq_bucket)
        # bucket-padded segments are inserted whole, so the cache needs
        # headroom for every reuse step's *capacity*, not just its valid end
        for st in steps:
            if st.model_id is not None:
                end = st.rng.lo + self.store.capacity(st.model_id)
                cap = max(cap, bucket_len(end, self.seq_bucket))
        pending = PendingBuild(doc_id=doc_id, requester=requester)
        sink = (lambda rng, seg: pending.puts.append((rng, seg))) \
            if materialize else None
        pending.pin_token = self.store.pin(plan.models_used)
        caches = logits = None
        t0 = time.perf_counter()
        try:
            with obs.span("serve.assemble"):
                self.store.prefetch_ids(plan.models_used)
            for st in steps:
                if st.model_id is not None:
                    with obs.span("serve.assemble"):
                        seg = self.store.get(st.model_id, requester=requester)
                        seg_caches = self._segment_caches(seg)
                        if caches is None:
                            # plan anchor at 0: adopt a copy of the
                            # segment, grown to the request capacity
                            # (later steps write into it in place, SSD
                            # state included; the stored copy stays
                            # intact)
                            caches = adopt_cache(seg_caches, cap)
                        else:
                            self._dispatch("insert", (cache_len(caches), seg.capacity))
                            caches = insert_cache(caches, seg_caches, st.rng.lo)
                    stats.tokens_reused += st.rng.size
                else:
                    with obs.span("serve.extend"):
                        caches, logits = self._fill_gap(
                            doc, st.rng, caches, cap, extras, stats=stats,
                            sink=sink, boundary=boundary and st is steps[-1])
        except BaseException:
            # a failed dispatch must not leak its pins
            self.abandon_build(pending)
            raise
        if caches is not None:
            with obs.span("serve.assemble"):
                caches = pad_cache_to(caches, cap)
        stats.prefill_s += time.perf_counter() - t0
        return caches, plan, pending, logits

    def finish(self, pending: PendingBuild, stats: ServeStats) -> None:
        """Complete a dispatched build: land it (:meth:`finalize_build`)
        and wait for the device, the time counted into ``prefill_s``."""
        t0 = time.perf_counter()
        self.finalize_build(pending)
        _sync(self.device)
        stats.prefill_s += time.perf_counter() - t0

    def abandon_build(self, pending: PendingBuild) -> None:
        """Release a dispatched build's pins without landing its insertions
        (the exception path of the dispatch phase: its trees may come from
        a failed computation; the next request re-prefills those chunks)."""
        if pending.finalized:
            return
        pending.finalized = True
        pending.puts = []
        self.store.unpin(pending.pin_token)

    def finalize_build(self, pending: PendingBuild) -> None:
        """Finalize phase of a dispatched build: land the recorded chunk
        insertions in dispatch order and release the plan's pins.  Never
        waits on the device; a build is finalized at most once."""
        if pending.finalized:
            return
        pending.finalized = True
        with obs.span("serve.store_put"):
            for rng, seg in pending.puts:
                self.store.put(rng, seg, doc_id=pending.doc_id,
                               created_by=pending.requester)
        pending.puts = []
        self.store.unpin(pending.pin_token)

    def _fill_gap(self, doc, rng: Range, caches, cap: int, extras, *,
                  stats, sink, boundary: bool):
        """Prefill one uncovered plan step [rng.lo, rng.hi) into ``caches``.

        Full chunks run as one ``prefill_extend_many`` call; at most one
        ragged remainder runs as one ``prefill_extend``.  Only a cold start
        at position 0 uses ``prefill``.  ``sink`` receives each chunk's
        materialized segment (None = don't materialize).

        With ``boundary`` the remainder's extend runs one token further,
        over [lo, rng.hi + 1), and its last-position logits, those of the
        token at ``rng.hi``, are returned; its segment is still [lo,
        rng.hi).  A tree with running state keeps its remainder to
        [lo, rng.hi): the stored segment carries the state at its end.
        Returns ``(caches, logits or None)``.
        """
        lo, hi = rng.lo, rng.hi
        if caches is None and lo == 0:
            first = min(self.chunk, hi)
            self._dispatch("prefill", (first,))
            _, caches = self.model.prefill(
                self.params, {"tokens": self._tokens(doc[None, :first]), **extras})
            if sink is not None:
                sink(Range(0, first), slice_cache(caches, 0, first))
            stats.tokens_computed += first
            lo = first
            if lo >= hi:
                return caches, None
        caches = pad_cache_to(caches, cap)
        end = hi + 1 if boundary and not holds_state(caches) else hi
        # writes past the capacity would corrupt the cache: check on host
        cur = cache_len(caches)
        assert cur == 0 or cur >= end, f"cache capacity {cur} < extend end {end}"
        n_full = (hi - lo) // self.chunk
        if n_full:
            n_slots = cap // self.chunk
            toks = np.zeros((1, n_slots, self.chunk), np.int64)
            toks[0, :n_full] = np.asarray(
                doc[lo:lo + n_full * self.chunk]).reshape(n_full, self.chunk)
            self._dispatch("extend_many", (cache_len(caches), n_slots, self.chunk))
            _, caches, states = self.model.prefill_extend_many(
                self.params, caches, self._tokens(toks), self._scalar(lo),
                n_full)
            if sink is not None:
                for i in range(n_full):
                    a = lo + i * self.chunk
                    sink(Range(a, a + self.chunk),
                         chunk_segment(caches, states, i, a, a + self.chunk))
            stats.tokens_computed += n_full * self.chunk
            lo += n_full * self.chunk
        if lo < hi:                              # ragged remainder chunk
            self._dispatch("extend", (cache_len(caches), end - lo))
            logits, caches = self.model.prefill_extend(
                self.params, caches, self._tokens(doc[None, lo:end]),
                self._scalar(lo))
            if sink is not None:
                sink(Range(lo, hi), slice_cache(caches, lo, hi))
            stats.tokens_computed += end - lo
            if end > hi:
                return caches, logits
        return caches, None

    def prefix_with_logits(self, doc: np.ndarray, prefix_len: int, *,
                           doc_id: str = DEFAULT_DOC,
                           extras: Optional[dict] = None,
                           stats: Optional[ServeStats] = None,
                           requester: Optional[int] = None,
                           capacity: Optional[int] = None):
        """Cache for [0, prefix_len) plus the logits of its last position,
        the build landed and complete on the device
        (:meth:`dispatch_prefix`, then :meth:`finish`).  Returns
        ``(logits, caches, plan)``."""
        stats = stats if stats is not None else ServeStats()
        logits, caches, plan, pending = self.dispatch_prefix(
            doc, prefix_len, doc_id=doc_id, extras=extras, stats=stats,
            requester=requester, capacity=capacity)
        self.finish(pending, stats)
        return logits, caches, plan

    def dispatch_prefix(self, doc: np.ndarray, prefix_len: int, *,
                        doc_id: str = DEFAULT_DOC,
                        extras: Optional[dict] = None,
                        stats: Optional[ServeStats] = None,
                        requester: Optional[int] = None,
                        capacity: Optional[int] = None):
        """Launch the build of [0, prefix_len) and the logits of its last
        position without waiting for the device; returns ``(logits,
        caches, plan, pending)``, ``pending`` for :meth:`finalize_build`
        or :meth:`finish` (see :meth:`_dispatch_build`).

        The plan covers [0, prefix_len - 1); the last prefix token's logits
        (the first sampling distribution) come out of the pass that
        completes the cache.  Where the plan ends in a ragged gap, that
        gap's extend takes the token too; otherwise (the plan ends on a
        reuse step or a whole chunk, or the tree holds running state) the
        token runs through a 1-token extend of its own.  Pass ``capacity``
        (e.g. prefix_len + n_new) so the caches are already padded to the
        decode bucket.
        """
        stats = stats if stats is not None else ServeStats()
        extras = extras or {}
        if prefix_len < 2:
            t0 = time.perf_counter()
            self._dispatch("prefill", (prefix_len,))
            with obs.span("serve.extend"):
                logits, caches = self.model.prefill(
                    self.params, {"tokens": self._tokens(doc[None, :prefix_len]), **extras})
            stats.prefill_s += time.perf_counter() - t0
            stats.tokens_computed += prefix_len
            plan = baseline_plan(Range(0, prefix_len), self.cost)
            # nothing to insert or pin
            return logits, caches, plan, PendingBuild(doc_id=doc_id,
                                                      requester=requester)
        caches, plan, pending, logits = self._dispatch_build(
            doc, prefix_len - 1, doc_id=doc_id, extras=extras, stats=stats,
            materialize=True, requester=requester,
            capacity=max(prefix_len, capacity or 0), boundary=True)
        if logits is not None:
            self.boundary_merged += 1
            return logits, caches, plan, pending
        self.boundary_alone += 1
        try:
            cur = cache_len(caches)
            assert cur == 0 or cur >= prefix_len, (
                f"cache capacity {cur} < prefix {prefix_len}")
            t0 = time.perf_counter()
            self._dispatch("extend", (cur, 1))
            with obs.span("serve.extend"):
                logits, caches = self.model.prefill_extend(
                    self.params, caches,
                    self._tokens(doc[None, prefix_len - 1:prefix_len]),
                    self._scalar(prefix_len - 1))
        except BaseException:
            # a failed boundary extend must not leak pins
            self.abandon_build(pending)
            raise
        stats.prefill_s += time.perf_counter() - t0
        stats.tokens_computed += 1
        return logits, caches, plan, pending

    def prefill_raw(self, batch):
        """From-scratch prefill (no planning, no materialization)."""
        self._dispatch("prefill", tuple(batch["tokens"].shape[1:]))
        return self.model.prefill(self.params, batch)


class ServeEngine:
    """Single-session serving over one document.

    ``store``/``doc_id`` default to a private store; pass a shared
    :class:`SegmentStore` and a stable ``doc_id`` to share segments.
    ``device`` (default: the model's) is where tokens and caches live.
    ``extras`` are a cross-attention stack's context features (numpy
    arrays or tensors), placed on the device once.
    """

    def __init__(
        self,
        model,
        params,
        doc_tokens: np.ndarray,
        *,
        extras: Optional[dict] = None,
        chunk_tokens: int = 64,
        seq_bucket: int = 64,
        cost_model: Optional[CostModel] = None,
        byte_budget: Optional[int] = None,
        store: Optional[SegmentStore] = None,
        doc_id: str = DEFAULT_DOC,
        eviction_policy: Optional[str] = None,
        device=None,
    ) -> None:
        self.model = model
        self.params = params
        self.doc = np.asarray(doc_tokens, np.int32)
        self.doc_id = doc_id
        if store is not None and byte_budget is not None:
            raise ValueError(
                "pass byte_budget only when the engine owns its store; a "
                "shared store's budget is set where the store is created")
        if store is not None and eviction_policy is not None:
            raise ValueError(
                "pass eviction_policy only when the engine owns its store; "
                "a shared store's policy is set where the store is created")
        cost_model = cost_model if cost_model is not None else serve_cost_model()
        if store is None:
            store = SegmentStore(byte_budget=byte_budget,
                                 cost_model=cost_model,
                                 policy=eviction_policy,
                                 seq_bucket=seq_bucket)
        self.store = store
        self.builder = PrefixCacheBuilder(model, params, self.store,
                                          chunk_tokens=chunk_tokens,
                                          seq_bucket=seq_bucket,
                                          cost_model=cost_model,
                                          device=device)
        self.device = self.builder.device
        self.cost = self.builder.cost
        self.stats = ServeStats()
        self.extras = host_extras(extras)
        self.context = device_extras(extras, self.device)

    @property
    def chunk(self) -> int:
        return self.builder.chunk

    # ------------------------------------------------------------------
    def plan_prefix(self, length: int) -> Plan:
        return self.builder.plan_prefix(length, doc_id=self.doc_id,
                                        stats=self.stats)

    def build_prefix(self, length: int, *, materialize: bool = True):
        return self.builder.build_prefix(
            self.doc, length, doc_id=self.doc_id, extras=self.context,
            stats=self.stats, materialize=materialize)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prefix_len: int, n_new: int, *, greedy: bool = True,
                 seed: int = 0):
        """Serve one request: cache for [0, prefix_len), then decode n_new.

        Sampling (``greedy=False``) draws from a ``torch.Generator`` seeded
        with ``seed`` on the engine's device.
        """
        self.stats.requests += 1
        logits, caches, plan = self.builder.prefix_with_logits(
            self.doc, prefix_len, doc_id=self.doc_id, extras=self.context,
            stats=self.stats, capacity=prefix_len + n_new)
        # a no-op except on the short-prefix prefill path
        caches = pad_cache_to(
            caches, bucket_len(prefix_len + n_new, self.builder.seq_bucket))
        t0 = time.perf_counter()
        out_tokens = []
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pos = torch.tensor([prefix_len], dtype=torch.int32, device=self.device)
        for i in range(n_new):
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            out_tokens.append(int(nxt[0]))
            if i < n_new - 1:  # the last token's logits are never consumed
                logits, caches = self.model.decode_step(
                    self.params, caches, nxt[:, None], pos)
                pos = pos + 1
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.tokens_decoded += len(out_tokens)
        return out_tokens, plan

    # ------------------------------------------------------------------
    def update_document(self, new_tokens: np.ndarray):
        """Swap in edited document content, keeping the reusable KV prefix.

        Diffs old vs new tokens, rekeys every stored segment strictly
        before the divergence point to the edited content's key when the
        cost model prices the edit-rebuild below from-scratch, and
        releases the rest.  Returns the :class:`~repro_torch.core.planner.EditPlan`.
        """
        from repro_torch.core.planner import plan_edit

        from .session import doc_key

        new_doc = np.asarray(new_tokens, np.int32)
        old_id = self.doc_id
        new_id = doc_key(new_doc, self.extras)
        eplan = plan_edit(self.doc, new_doc, self.store.index(old_id),
                          self.cost, self.store.segment_bytes(old_id))
        if new_id != old_id:
            if eplan.action == "edit":
                self.store.rekey(old_id, new_id, upto=eplan.divergence)
            self.store.release_doc(old_id)
        self.doc, self.doc_id = new_doc, new_id
        return eplan

    @torch.no_grad()
    def baseline_build(self, length: int):
        """No-reuse reference: prefill everything from scratch.  Returns
        (caches, seconds)."""
        batch = {"tokens": self.builder._tokens(self.doc[None, :length]),
                 **self.context}
        t0 = time.perf_counter()
        _, caches = self.builder.prefill_raw(batch)
        _sync(self.device)
        return caches, time.perf_counter() - t0
