"""Multi-session batched serving over a shared segment store.

A :class:`SessionManager` owns N active documents (tenants) over one model
and one :class:`~repro_torch.serve.kv_cache.SegmentStore`.  Each request's
prefix is planned with the directed Dijkstra against the shared,
document-keyed store: sessions over the same document hit each other's
segments, sessions over different documents stay isolated (one
descriptor index per content key), and one byte budget arbitrates storage
across all tenants.

Decode is continuously batched: every scheduler round coalesces the ready
sessions into packs of at most ``max_batch`` rows, each session's cache
padded to the pack's bucketed capacity and concatenated along the batch
axis, and runs one ``decode_step`` per pack.  Packs merge sessions of
mixed capacity (``merge_decode_packs``, the default): the decode kernel
stops every row at its own ``pos`` and its output is bit-invariant to the
padded capacity, so a row's tokens do not depend on its pack.

The port's decode writes K/V **in place**, so a pack always owns its
storage (a buffer of :class:`~repro_torch.serve.packs.PackPool`, a 1-row
pack too), a dissolved pack hands every session a row of its own, and the
store only ever holds compact copies: no in-place write can reach store
bytes.  The pool keeps dissolved packs' buffers per (batch signature,
rows, capacity), so a pack built again over the same key sits at the same
addresses and the model replays the decode step's CUDA graph over it
(``models/graphs.py``).

Decode write-back: the tokens a request emits extend its document.  When
the request drains, the KV decode wrote for them is stored under the
content key of the continuation ``doc[:prefix] + generated`` if the cost
model admits it, and the base document's prefix segments are aliased into
the continuation's index, so a follow-up request over generated context
plans from the store.

Pipelined serving: ``submit`` plans the prefix and dispatches its build
without waiting (``PrefixCacheBuilder.dispatch_prefix``), parking
the session behind a :class:`PrefillTicket`.  The scheduler batches warm
sessions while builds are in flight and joins a ticket before its
session's first decode: when its CUDA event reports completion, or when
nothing else can decode.  Store insertions of a build land in submit
order at the next flush, and the plan's reuse segments stay pinned until
then, so token streams and store contents are those of the synchronous
loop (``async_prefill=False``: ``submit`` lands each build and waits for
it).  One stream carries all device work, in enqueue order.
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cost import CostModel, serve_cost_model
from repro_torch.core.descriptors import Range
from repro_torch.core.optimizer import Plan
from repro_torch.kernels.common import bucket_len, uses_kernel
from repro_torch.models.common import tree_leaves, tree_map_with_path

from .engine import (PendingBuild, PrefixCacheBuilder, ServeStats, device_extras,
                     host_extras)
from .kv_cache import (SEQ_KEYS, SegmentStore, _leaf_key, cache_len,
                       cache_nbytes, pad_cache_to, slice_cache)
from .packs import PackPool


def doc_key(doc_tokens: np.ndarray, extras: Optional[dict] = None) -> str:
    """Content-derived document id: identical documents share segments.

    ``extras`` (encoder features / image embeddings, as numpy arrays)
    condition the KV a prefill produces, so they are part of document
    identity.  sha256, so the id is identical across processes and hosts
    (and equal to ``repro.serve.session.doc_key`` for the same inputs).
    """
    h = hashlib.sha256(np.ascontiguousarray(doc_tokens, np.int32).tobytes())
    for k in sorted(extras or {}):
        h.update(k.encode())
        h.update(np.ascontiguousarray(extras[k]).tobytes())
    return h.hexdigest()[:12]


def batch_caches(caches_list: list) -> Any:
    """Concatenate per-session caches ((L, 1, ...) leaves) along batch.

    The pack always owns its storage: ``torch.cat`` copies, one operand
    included.  Decode writes K/V into a pack in place, so sharing storage
    with any input would let a decode write land outside the pack.
    """
    return tree_map_with_path(lambda _, *xs: torch.cat(xs, dim=1),
                              caches_list[0], *caches_list[1:])


def split_caches(caches, n: int) -> list:
    """Inverse of :func:`batch_caches`: per-row views of a batched cache."""
    return [tree_map_with_path(lambda _, x: x[:, i:i + 1], caches)
            for i in range(n)]


def batch_signature(caches) -> tuple:
    """Shape key under which caches can be batched together.

    Batch (axis 1) and the SEQ leaves' sequence axis (axis 2) are
    normalized away (padding and concatenation adjust them); tree
    structure, every other dimension and the dtypes must match.
    """
    sig = []

    def f(path, x):
        key = _leaf_key(path)
        shape = list(x.shape)
        shape[1] = -1
        if key in SEQ_KEYS:
            shape[2] = -1
        sig.append((path, tuple(shape), str(x.dtype)))
        return x

    tree_map_with_path(f, caches)
    return tuple(sig)


def _pack_key(caches, rows: int, cap: int) -> tuple:
    """The pack pool's key of a pack of ``rows`` rows like ``caches`` at
    capacity ``cap``; a cache without SEQ leaves (SSD state alone) has no
    capacity, so its packs of one batch share a key whatever ``cap``."""
    return (batch_signature(caches), rows, cap if cache_len(caches) else 0)


@dataclass
class PrefillTicket:
    """One async prefix build in flight between submit and first decode.

    ``event`` is recorded on the current stream after the build's last
    enqueue; :meth:`ready` polls it without blocking and the join waits on
    it.  ``pending`` holds the build's deferred chunk insertions and the
    pins of its plan, flushed in submit order by the manager.  Without a
    card (``event`` None) the work ran synchronously and the ticket is
    ready at once.
    """
    sid: int
    seq: int                    # FIFO order (= launch index)
    plan: Plan
    pending: PendingBuild
    event: Any                  # torch.cuda.Event, or None on the CPU
    submitted_s: float
    joined: bool = False
    join_wait_s: float = 0.0

    def ready(self) -> bool:
        """Has the dispatched build completed on the device?  Never blocks."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@dataclass
class Session:
    sid: int
    doc_id: str
    doc: np.ndarray
    #: the context features as host arrays: the document's identity
    extras: dict = field(default_factory=dict)
    #: the same on the manager's device: what a cold prefill consumes
    context: dict = field(default_factory=dict)
    stats: ServeStats = field(default_factory=ServeStats)
    # in-flight request state
    caches: Any = None
    logits: Any = None          # (1, V) distribution for the next token
    pos: int = 0                # next decode position
    capacity: int = 0           # required KV capacity (prefix + n_new)
    req_prefix: int = 0         # prefix length of the in-flight request
    mat_pending: bool = False   # drained request's KV awaits write-back
    fork_owned: bool = False    # doc_id is a generated fork this session made
    remaining: int = 0
    greedy: bool = True
    gen: Optional[torch.Generator] = None  # sampling stream of the request
    next_tok: int = -1
    greedy_next: Optional[int] = None  # batched argmax from the last decode
    ticket: Optional[PrefillTicket] = None  # un-joined async prefix build
    out_tokens: list = field(default_factory=list)
    plans: list = field(default_factory=list)

    @property
    def busy(self) -> bool:
        return self.remaining > 0


@dataclass
class SchedulerStats:
    decode_calls: int = 0
    decode_rows: int = 0
    pack_rebuilds: int = 0
    pack_reuses: int = 0        # ... built in a buffer a dissolved pack left
    decode_replays: int = 0     # decode calls the model replayed from a graph
    decode_captures: int = 0    # ... that captured the graph they replayed
    decode_segments: int = 0    # decode-KV segments admitted to the store
    decode_rejects: int = 0     # ... rejected by the cost-model admission
    # pipeline (async-prefill) counters
    tickets_launched: int = 0   # async prefix builds dispatched
    tickets_joined: int = 0     # ... whose sessions entered decode
    join_wait_s: float = 0.0    # host time blocked waiting on builds at join
    overlap_steps: int = 0      # decode rounds run while ≥1 build in flight
    overlap_rows: int = 0       # decode rows produced in those rounds
    # delta-update (document edit) counters
    edits: int = 0              # update_document calls applied
    edit_reused_segments: int = 0  # segments rekeyed to the edited content
    edit_orphaned: int = 0      # segments invalidated (released) by edits
    edit_cancelled: int = 0     # in-flight requests superseded by an edit
    # ragged-decode observability
    decode_valid_tokens: int = 0   # Σ per-row live KV (pos+1) over decode calls
    decode_padded_tokens: int = 0  # Σ rows × padded pack capacity
    decode_attn_flops: float = 0.0  # attention FLOPs the decode kernel runs

    # every derived mean degrades to 0.0 (never NaN) on zero traffic
    @property
    def mean_batch(self) -> float:
        return self.decode_rows / self.decode_calls if self.decode_calls else 0.0

    @property
    def pack_reuse_share(self) -> float:
        return self.pack_reuses / self.pack_rebuilds if self.pack_rebuilds else 0.0

    @property
    def decode_graph_hit_share(self) -> float:
        """Decode calls replayed from a graph captured at an earlier call ÷
        decode calls."""
        return self.decode_replays / self.decode_calls if self.decode_calls else 0.0

    @property
    def decode_padded_frac(self) -> float:
        """Valid tokens ÷ padded pack capacity (1.0 = zero padding)."""
        return (self.decode_valid_tokens / self.decode_padded_tokens
                if self.decode_padded_tokens else 0.0)

    @property
    def overlap_batch(self) -> float:
        return (self.overlap_rows / self.overlap_steps
                if self.overlap_steps else 0.0)

    @property
    def mean_join_wait_s(self) -> float:
        return (self.join_wait_s / self.tickets_joined
                if self.tickets_joined else 0.0)


#: the sharded store's report keys at their single-shard values: a plain
#: store reports these, so consumers of ``report()`` never branch on the
#: store's type
_SINGLE_SHARD = {
    "shards": 1,
    "remote_fetches": 0,
    "remote_fetch_wire_bytes": 0,
    "fetched_hits": 0,
    "on_demand_fetches": 0,
    "hedged_fetches": 0,
    "hedge_rebuild_wins": 0,
    "hedge_fetch_wins": 0,
    "cancelled_fetches": 0,
    "dead_shard_skips": 0,
    "put_forwards": 0,
    "put_forward_bytes": 0,
    "cross_shard_alias_skips": 0,
    "cross_shard_rekeys": 0,
    "remote_transfers": 0,
    "remote_fetch_items": 0,
    "remote_fetch_bytes": 0,
    "fetch_ticks": 0,
    "coalesce_violations": 0,
    "max_transfers_per_shard_tick": 0,
    "sim_transfer_s": 0.0,
}


#: the keys ``report()`` adds after ``repro``'s: the pack pool's reuses and
#: their share of pack builds, the decode calls replayed from a CUDA graph,
#: the calls that captured one, and the replays' share of the calls, and
#: the share of prefix builds whose last token rode the ragged last gap's
#: extend (``PrefixCacheBuilder.boundary_merged_share``)
PORT_REPORT_KEYS = ("pack_reuses", "pack_reuse_share", "decode_graph_replays",
                    "decode_graph_captures", "decode_graph_hit_share",
                    "boundary_merged_share")


class SessionManager:
    """N concurrent serving sessions over one model and one shared store.

    Tokens, caches and packs live on the model's device (``cuda`` unless
    the model was made for another).
    """

    #: the decode route: ``LM.decode_step`` through the decode kernel, which
    #: stops every row at its own ``pos`` (the TPU's route in ``repro``);
    #: "dense" for a stack of MLA layers on the CPU, whose absorbed decode
    #: reads the pack's whole padded capacity (on a CUDA device the absorbed
    #: decode kernel stops every row at its own ``pos``)
    decode_mode = "kernel"

    def __init__(self, model, params, *,
                 chunk_tokens: int = 64,
                 cost_model: Optional[CostModel] = None,
                 byte_budget: Optional[int] = None,
                 decode_bucket: int = 64,
                 max_batch: int = 8,
                 eviction_policy: Optional[str] = None,
                 decode_materialize: bool = True,
                 async_prefill: bool = True,
                 merge_decode_packs: Optional[bool] = None,
                 store: Optional[SegmentStore] = None) -> None:
        self.model = model
        self.params = params
        if store is not None and byte_budget is not None:
            raise ValueError(
                "pass byte_budget only when the manager owns its store; a "
                "shared/reloaded store's budget is set where it is created")
        if store is not None and eviction_policy is not None:
            raise ValueError(
                "pass eviction_policy only when the manager owns its store; "
                "a shared/reloaded store's policy is set where it is created")
        if store is not None and cost_model is not None \
                and cost_model is not store.cost:
            raise ValueError(
                "pass cost_model only when the manager owns its store (or "
                "pass the store's own cost model); a shared/reloaded "
                "store's pricing is set where the store is created")
        # one cost model prices planner edges, decode-segment admission and
        # eviction; an adopted store brings its own
        if store is not None:
            self.cost = store.cost
        else:
            self.cost = cost_model if cost_model is not None else serve_cost_model()
            store = SegmentStore(byte_budget=byte_budget,
                                 cost_model=self.cost,
                                 policy=eviction_policy,
                                 seq_bucket=decode_bucket)
        self.store = store
        # prefill pads caches to the decode buckets, so a fresh prefix drops
        # into a decode pack without a reshape
        self.builder = PrefixCacheBuilder(model, params, self.store,
                                          chunk_tokens=chunk_tokens,
                                          seq_bucket=decode_bucket,
                                          cost_model=self.cost)
        self.device = self.builder.device
        self.decode_materialize = decode_materialize
        self.async_prefill = async_prefill
        self.decode_bucket = decode_bucket
        self.max_batch = max_batch
        # merged packs: a row's decode output is bit-invariant to its
        # pack's padded capacity, so mixed-capacity sessions share one
        # pack; False groups by bucketed capacity instead
        self.merge_decode_packs = (True if merge_decode_packs is None
                                   else merge_decode_packs)
        # attention-bearing layers, for the decode-FLOP count
        self._n_attn_layers, self._n_mla_layers = (sum(
            n * sum(1 for spec in period if spec.mixer == mixer)
            for period, n in model.segments) for mixer in ("attn", "mla"))
        # the kernels' own routing: a decode step's caches share the
        # parameters' device (its products mix them), so a parameter is
        # routed as every pack's latents will be
        self._mla_kernel = uses_kernel(tree_leaves(params)[0])
        if self._n_mla_layers and not self._n_attn_layers and not self._mla_kernel:
            self.decode_mode = "dense"
        # per-request counters live on each Session (folded into
        # _closed_stats on close); this object carries the batched decode
        # wall time.  aggregate_stats() is the combined view.
        self.stats = ServeStats()
        self.sched = SchedulerStats()
        self._closed_stats = ServeStats()
        self.sessions: dict[int, Session] = {}
        self._next_sid = 0
        # live decode packs: tuple(sids) -> batched caches (padded to a bucket)
        self._packs: dict[tuple[int, ...], Any] = {}
        # buffers of dissolved packs; bounded at the first pack (_pack_bound)
        self.packs: Optional[PackPool] = None
        # un-finalized async builds, FIFO in submit order
        self._tickets: list[PrefillTicket] = []

    # -- session lifecycle -------------------------------------------------
    def add_session(self, doc_tokens: np.ndarray, *,
                    doc_id: Optional[str] = None,
                    extras: Optional[dict] = None) -> int:
        """Open a session over ``doc_tokens``.  ``extras`` (a cross-attention
        stack's context features, numpy arrays or tensors) condition the
        session's prefills and are part of the document's identity
        (:func:`doc_key`): same tokens with other extras share no segment.
        They are copied to the host (for the key) and to the device (for
        the model) here, once."""
        doc = np.asarray(doc_tokens, np.int32)
        sid = self._next_sid
        self._next_sid += 1
        host = host_extras(extras)
        self.sessions[sid] = Session(
            sid=sid, doc_id=doc_id if doc_id is not None else doc_key(doc, host),
            doc=doc, extras=host, context=device_extras(extras, self.device))
        return sid

    def close_session(self, sid: int) -> None:
        # land every deferred build first: the closing session's own chunk
        # segments (and everyone else's) reach the store in submit order
        self._flush_tickets()
        self._flush_packs([g for g in self._packs if sid in g])
        s = self.sessions.pop(sid, None)
        if s is not None:
            s.ticket = None
            if s.mat_pending:
                # the last request's generated KV outlives the session
                self._materialize_decode(s)
            _accumulate(self._closed_stats, s.stats)

    # -- request admission (pipeline stage 1) ------------------------------
    @torch.no_grad()
    def submit(self, sid: int, prefix_len: int, n_new: int, *,
               greedy: bool = True, seed: int = 0) -> Plan:
        """Admit one request: plan the prefix and launch its build.

        Async mode (default) dispatches the build and returns with the
        plan; the session rides a :class:`PrefillTicket` until the
        scheduler joins it before its first decode.  Sync mode waits here
        until the build has completed.  Sampling (``greedy=False``) draws
        from a ``torch.Generator`` seeded with ``seed`` on the manager's
        device, as ``ServeEngine.generate`` does.
        """
        with obs.span("serve.submit"):
            return self._submit(sid, prefix_len, n_new, greedy=greedy, seed=seed)

    def _submit(self, sid: int, prefix_len: int, n_new: int, *,
                greedy: bool, seed: int) -> Plan:
        s = self.sessions[sid]
        if s.busy:
            raise RuntimeError(f"session {sid} still has {s.remaining} tokens pending")
        # outstanding builds land before this one plans: their segments are
        # what the synchronous loop's plan would see, and their puts precede
        self._flush_tickets()
        # a drained session's last pack can survive under the same group
        # tuple; drop any pack holding this session so it is never reused
        self._flush_packs([g for g in self._packs if sid in g])
        if s.mat_pending:
            # last chance to write the previous request's generated KV back
            # before the session caches are replaced
            self._materialize_decode(s)
        with obs.span("serve.assemble"):
            self.store.prefetch(s.doc_id, upto=prefix_len)
        logits, caches, plan, pending = self.builder.dispatch_prefix(
            s.doc, prefix_len, doc_id=s.doc_id, extras=s.context, stats=s.stats,
            requester=sid, capacity=prefix_len + n_new)
        if self.async_prefill:
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            self.sched.tickets_launched += 1
            s.ticket = PrefillTicket(
                sid=sid, seq=self.sched.tickets_launched, plan=plan,
                pending=pending, event=event, submitted_s=time.perf_counter())
            self._tickets.append(s.ticket)
        else:
            # the monolithic loop: every decoding session stalls until this
            # build has landed and completed on the device
            self.builder.finish(pending, s.stats)
        s.caches = caches
        s.logits = logits
        s.greedy_next = None
        s.pos = prefix_len
        s.capacity = prefix_len + n_new
        s.req_prefix = prefix_len
        s.remaining = n_new
        s.greedy = greedy
        s.gen = torch.Generator(device=self.device).manual_seed(seed)
        s.out_tokens = []
        s.plans.append(plan)
        s.stats.requests += 1
        return plan

    def submit_many(self, reqs, *, greedy: bool = True) -> list[Plan]:
        """Admit one scheduler tick's worth of requests together.

        ``reqs`` is ``[(sid, prefix_len, n_new, seed), ...]``.  Against a
        sharded store this is the cross-document coalescing point: every
        document's remote segments are resolved in **one** transport tick
        up front (at most one batched transfer per contacted shard), so
        the per-request prefetch inside :meth:`submit` finds its payloads
        already in the fetch cache.  Against a plain store it is the
        submit loop.
        """
        batch = getattr(self.store, "prefetch_batch", None)
        if batch is not None:
            batch([(self.sessions[sid].doc_id, prefix_len)
                   for sid, prefix_len, _, _ in reqs])
        return [self.submit(sid, prefix_len, n_new, greedy=greedy, seed=seed)
                for sid, prefix_len, n_new, seed in reqs]

    # -- delta updates (document edits) ------------------------------------
    def update_document(self, sid: int, new_tokens: np.ndarray):
        """Replace a session's document mid-session, reusing its KV prefix.

        Diffs old vs new tokens (:func:`~repro_torch.core.planner.plan_edit`
        prices reuse-prefix + rebuild-suffix against a from-scratch build);
        the store rekeys every segment strictly before the divergence point
        to the edited content's key and releases the rest from every tier.
        An in-flight build is joined first (its segments must land before
        the rekey), and an in-flight request is cancelled: the edit
        supersedes it.  Returns the :class:`~repro_torch.core.planner.EditPlan`.
        """
        from repro_torch.core.planner import plan_edit

        s = self.sessions[sid]
        if s.ticket is not None:
            self._flush_tickets()
            self._join_ticket(s)
        self._flush_packs([g for g in self._packs if sid in g])
        if s.busy:
            # the remaining tokens would continue the old text
            s.remaining = 0
            s.mat_pending = False
            self.sched.edit_cancelled += 1
        elif s.mat_pending:
            # write back first: it can advance the session onto its
            # continuation, the document the edit must diff against
            self._materialize_decode(s)
        new_doc = np.asarray(new_tokens, np.int32)
        old_id = s.doc_id
        new_id = doc_key(new_doc, s.extras)
        eplan = plan_edit(s.doc, new_doc, self.store.index(old_id),
                          self.cost, self.store.segment_bytes(old_id))
        if new_id != old_id:
            if eplan.action == "edit":
                self.store.rekey(old_id, new_id, upto=eplan.divergence)
            if all(o.doc_id != old_id for o in self.sessions.values()
                   if o.sid != sid):
                # nobody else serves the old content: drop its orphans
                self.store.release_doc(old_id)
        s.doc, s.doc_id = new_doc, new_id
        s.caches = None
        s.logits = None
        s.greedy_next = None
        s.pos = 0
        s.fork_owned = False    # edited content arrived from outside
        self.sched.edits += 1
        self.sched.edit_reused_segments += len(eplan.reuse)
        self.sched.edit_orphaned += len(eplan.orphans)
        return eplan

    # -- scheduler (pipeline stages 2+3) -----------------------------------
    def _flush_tickets(self) -> None:
        """Finalize outstanding builds' store insertions, FIFO.  Never waits
        on the device."""
        while self._tickets:
            self.builder.finalize_build(self._tickets.pop(0).pending)

    def _join_ticket(self, s: Session) -> None:
        """Join a ticketed session into the decode stage: wait for its build
        (a no-op when the poll already saw it done) and charge the wait to
        the build, not to the decode lanes."""
        t = s.ticket
        with obs.timed("serve.join") as clock:
            t.wait()
        wait = clock.s
        t.join_wait_s = wait
        t.joined = True
        s.ticket = None
        s.stats.prefill_s += wait
        self.sched.tickets_joined += 1
        self.sched.join_wait_s += wait

    @torch.no_grad()
    def step(self) -> int:
        """One scheduling round: sample a token for every decodable session,
        then run the still-running ones through batched decode calls.
        Returns the number of tokens produced (0 = idle).

        Sessions whose build is still in flight are skipped unless nothing
        else can decode, in which case the oldest ticket is joined.
        """
        with obs.span("serve.step"):
            return self._step()

    def _step(self) -> int:
        self._flush_tickets()
        busy = [s for s in self.sessions.values() if s.busy]
        if not busy:
            return 0
        ready = [s for s in busy if s.ticket is None]
        waiting = sorted((s for s in busy if s.ticket is not None),
                         key=lambda s: s.ticket.seq)
        for s in waiting:
            if s.ticket.ready() or not ready:
                self._join_ticket(s)
                ready.append(s)
        in_flight = sum(1 for s in busy if s.ticket is not None)
        with obs.span("serve.sample"):
            for s in ready:
                self._sample(s)
        decode_set = [s for s in ready if s.remaining > 0]
        t0 = time.perf_counter()
        for group in self._plan_groups(decode_set):
            self._decode_group(group)
        dt = time.perf_counter() - t0
        self.stats.decode_s += dt
        for s in decode_set:
            s.stats.decode_s += dt / len(decode_set)
        if in_flight and decode_set:
            self.sched.overlap_steps += 1
            self.sched.overlap_rows += len(decode_set)
        return len(ready)

    def run(self) -> dict[int, list[int]]:
        """Drain every pending request; returns {sid: generated tokens}."""
        while self.step():
            pass
        self._release_idle()
        return {sid: list(s.out_tokens) for sid, s in self.sessions.items()}

    def _release_idle(self) -> None:
        """Free the decode-time device memory of drained sessions, after
        writing each drained request's generated KV back to the store."""
        idle_groups = [g for g in self._packs
                       if all(sid not in self.sessions
                              or not self.sessions[sid].busy for sid in g)]
        if self.decode_materialize:
            # the pack rows hold the decode-written KV the write-back slices
            self._flush_packs(idle_groups)
        else:
            for g in idle_groups:
                self._dissolve(g)
        for s in self.sessions.values():
            if not s.busy:
                if s.mat_pending:
                    self._materialize_decode(s)
                s.caches = None
                s.logits = None
                s.greedy_next = None

    def _materialize_decode(self, s: Session) -> None:
        """Write a drained request's decode-generated KV back into the store.

        Decode wrote KV for positions ``[req_prefix, pos)`` (every emitted
        token but the last) into the session cache: a valid segment of the
        continuation ``doc[:req_prefix] + out_tokens``, stored under that
        continuation's content key when the cost model admits it.  The
        base document's prefix segments are aliased into the fork's index;
        when the request covered the whole document, the session advances
        onto the continuation.
        """
        s.mat_pending = False
        if not self.decode_materialize or s.caches is None or not s.out_tokens:
            return
        with obs.span("serve.writeback"):
            self._write_back(s)

    def _write_back(self, s: Session) -> None:
        start, end = s.req_prefix, s.pos
        ext_doc = np.concatenate(
            [s.doc[:start], np.asarray(s.out_tokens, np.int32)])
        ext_id = doc_key(ext_doc, s.extras)
        self.store.alias(s.doc_id, ext_id, upto=start)
        if start == len(s.doc):
            old_id = s.doc_id
            s.doc, s.doc_id = ext_doc, ext_id
            if s.fork_owned and all(
                    o.doc_id != old_id for o in self.sessions.values()
                    if o.sid != s.sid):
                # retire the private fork this session advanced off, so a
                # long generation chain does not grow alias sets and dead
                # indexes without bound
                self.store.release_doc(old_id)
            s.fork_owned = True
        n_gen = end - start
        if n_gen <= 0:
            return  # 1-token request: nothing was decoded into the cache
        # admission prices the bucket-padded bytes that would be resident
        seg = pad_cache_to(slice_cache(s.caches, start, end),
                           self.store.bucket_capacity(n_gen))
        if not self.cost.admit(n_gen, cache_nbytes(seg),
                               expected_reuses=self.store.admission_prior(ext_id)):
            self.sched.decode_rejects += 1
            return
        self.store.put(Range(start, end), seg, doc_id=ext_id,
                       created_by=s.sid)
        self.sched.decode_segments += 1

    # -- internals ---------------------------------------------------------
    def _sample(self, s: Session) -> None:
        if s.greedy and s.greedy_next is not None:
            tok = s.greedy_next  # batched argmax from the last decode call
        elif s.greedy:
            tok = int(torch.argmax(s.logits, dim=-1)[0])
        else:
            probs = torch.softmax(s.logits.float(), dim=-1)
            tok = int(torch.multinomial(probs, 1, generator=s.gen)[0, 0])
        s.greedy_next = None
        s.next_tok = tok
        s.out_tokens.append(tok)
        s.remaining -= 1
        s.stats.tokens_decoded += 1
        if s.remaining == 0:
            s.mat_pending = True  # written back once the pack is flushed

    def _plan_groups(self, decode_set: list) -> list[tuple[int, ...]]:
        """Partition ready sessions into batchable groups of ≤ max_batch.

        Sessions batch when their cache trees share a signature.  Merged
        packs order rows by bucketed capacity, largest first (sid breaks
        ties, so an unchanged membership keeps its tuple); capacity-split
        grouping adds the bucketed capacity to the key.  Grouping never
        changes tokens.
        """
        by_sig: dict[tuple, list] = {}
        if self.merge_decode_packs:
            order = lambda s: (-self._row_cap(s), s.sid)  # noqa: E731
        else:
            order = lambda s: s.sid  # noqa: E731
        for s in sorted(decode_set, key=order):
            sig = batch_signature(s.caches)
            key = (sig,) if self.merge_decode_packs else (sig, self._row_cap(s))
            by_sig.setdefault(key, []).append(s)
        groups: list[tuple[int, ...]] = []
        for members in by_sig.values():
            for i in range(0, len(members), self.max_batch):
                groups.append(tuple(s.sid for s in members[i:i + self.max_batch]))
        # groups partition the decode set: an unchanged tuple keeps its
        # pack; stale packs are split back into their sessions
        new_set = set(groups)
        stale = [g for g in self._packs if g not in new_set]
        if stale:
            self._flush_packs(stale)
        for g in groups:
            if g not in self._packs:
                self._build_pack(g)
        return groups

    def _row_cap(self, s: Session) -> int:
        """A session's bucketed KV capacity — its tier in a merged pack."""
        return bucket_len(max(s.capacity, cache_len(s.caches)),
                          self.decode_bucket)

    def _pack_bound(self) -> int:
        """The pack pool's bytes: half of what the device has free (the
        allocator's unused cache included; the host's available memory on
        the CPU) once the store holds its whole budget."""
        if self.device.type == "cuda":
            free = (torch.cuda.mem_get_info(self.device)[0]
                    + torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device))
        else:
            free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        budget = self.store.byte_budget
        room = 0 if budget is None else max(0, budget - self.store.nbytes())
        return max(0, free - room) // 2

    def _build_pack(self, group: tuple[int, ...]) -> None:
        sess = [self.sessions[sid] for sid in group]
        target = max(max(s.capacity, cache_len(s.caches)) for s in sess)
        cap = bucket_len(target, self.decode_bucket)
        with obs.span("serve.pack"):
            if self.packs is None:
                self.packs = PackPool(self._pack_bound())
            rows = [s.caches for s in sess]
            self._packs[group], reused = self.packs.take(
                _pack_key(rows[0], len(rows), cap), rows, cap)
        self.sched.pack_rebuilds += 1
        self.sched.pack_reuses += reused

    def _dissolve(self, group: tuple[int, ...]) -> None:
        """Drop a pack; its buffer goes back to the pool."""
        pack = self._packs.pop(group)
        self.packs.give(_pack_key(pack, len(group), cache_len(pack)), pack)

    def _flush_packs(self, groups: Optional[list] = None) -> None:
        """Hand batched caches back to their sessions (pre-regroup), each
        row a copy of its own: the pack's buffer goes back to the pool."""
        targets = list(self._packs) if groups is None else list(groups)
        if not targets:
            return
        with obs.span("serve.pack"):
            for group in targets:
                pack = self._packs[group]
                for i, sid in enumerate(group):
                    if sid in self.sessions:
                        self.sessions[sid].caches = tree_map_with_path(
                            lambda _, x, i=i: x[:, i:i + 1].clone(), pack)
                self._dissolve(group)

    def _decode_group(self, group: tuple[int, ...]) -> None:
        """One ``decode_step`` over a pack.  No ``row_caps``: the decode
        kernel stops each row at its own ``pos`` whatever the pack's
        capacity (``repro``'s kernel route; its blocked CPU route is what
        takes per-row capacities)."""
        sess = [self.sessions[sid] for sid in group]
        caches = self._packs[group]
        toks = torch.tensor([[s.next_tok] for s in sess], dtype=torch.int64,
                            device=self.device)
        pos = torch.tensor([s.pos for s in sess], dtype=torch.int32,
                           device=self.device)
        pack_cap = cache_len(caches)
        graphs = getattr(self.model, "decode_graphs", None)
        seen = (graphs.replays, graphs.captures) if graphs is not None else None
        with obs.span("serve.decode"):
            logits, caches = self.model.decode_step(self.params, caches, toks, pos)
        self._packs[group] = caches
        if seen is not None:
            self.sched.decode_replays += graphs.replays > seen[0]
            self.sched.decode_captures += graphs.captures > seen[1]
        # greedy rows need B ints on the host, not the (B, V) logits;
        # sampling rows keep their logits row on the device
        with obs.span("serve.readback"):
            greedy_toks = torch.argmax(logits, dim=-1).tolist()
        for i, s in enumerate(sess):
            s.logits = logits[i:i + 1]
            s.greedy_next = greedy_toks[i]
            s.pos += 1
        self.sched.decode_calls += 1
        self.sched.decode_rows += len(group)
        # live KV per row (post-increment pos: the tokens attended this
        # step) against the padded capacity every row rides at
        live = [s.pos for s in sess]
        self.sched.decode_valid_tokens += sum(live)
        self.sched.decode_padded_tokens += pack_cap * len(sess)
        self.sched.decode_attn_flops += self._decode_attn_flops(live, pack_cap)

    def _decode_attn_flops(self, live: list[int], cap: int) -> float:
        """Attention FLOPs one decode call runs: per attended KV position a
        query head does q·k and p·v (4·hd FLOPs), and the decode kernel
        reads each row's positions in whole splits of ``kernel.SPLIT``, up
        to the pack's capacity.  An MLA layer's absorbed decode scores the
        latent and the rope key and sums the latent (2·(2·kv_lora + rope)
        FLOPs a head) at each position it reads: on a CUDA device the
        absorbed decode kernel reads each row's positions in whole splits of
        its own ``SPLIT``, on the CPU the plain version every position of
        the padded capacity."""
        from repro_torch.kernels.decode_attention.kernel import SPLIT
        from repro_torch.kernels.mla_decode.ops import positions_read

        cfg = self.model.cfg
        per_tok = 4.0 * cfg.n_heads * cfg.head_dim * self._n_attn_layers
        tokens = sum(min(-(-t // SPLIT) * SPLIT, cap) for t in live)
        flops = per_tok * tokens
        if self._n_mla_layers:
            m = cfg.mla
            flops += (2.0 * cfg.n_heads * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
                      * self._n_mla_layers * positions_read(live, cap, kernel=self._mla_kernel))
        return flops

    # -- reporting ---------------------------------------------------------
    def aggregate_stats(self) -> ServeStats:
        """Sum of per-session stats (live and closed) plus decode time."""
        agg = ServeStats()
        _accumulate(agg, self._closed_stats)
        for s in self.sessions.values():
            _accumulate(agg, s.stats)
        agg.decode_s = self.stats.decode_s
        return agg

    def report(self) -> dict:
        """Flat serving report: every value is a finite number (an idle
        server reports zeros), with ``repro``'s keys."""
        agg = self.aggregate_stats()
        sc = self.sched
        st = self.store
        tiers = st.tier_bytes()
        return {
            "requests": agg.requests,
            "tokens_decoded": agg.tokens_decoded,
            "tokens_reused": agg.tokens_reused,
            "tokens_computed": agg.tokens_computed,
            "reuse_frac": agg.reuse_frac,
            "prefill_tok_s": agg.prefill_tok_s,
            "decode_tok_s": agg.decode_tok_s,
            "decode_calls": sc.decode_calls,
            "mean_batch": sc.mean_batch,
            "pack_rebuilds": sc.pack_rebuilds,
            "decode_padded_frac": sc.decode_padded_frac,
            "decode_valid_tokens": sc.decode_valid_tokens,
            "decode_padded_tokens": sc.decode_padded_tokens,
            "decode_attn_flops": sc.decode_attn_flops,
            "decode_segments": sc.decode_segments,
            "decode_rejects": sc.decode_rejects,
            "tickets_launched": sc.tickets_launched,
            "tickets_joined": sc.tickets_joined,
            "mean_join_wait_s": sc.mean_join_wait_s,
            "overlap_steps": sc.overlap_steps,
            "overlap_batch": sc.overlap_batch,
            "edits": sc.edits,
            "edit_reused_segments": sc.edit_reused_segments,
            "edit_orphaned": sc.edit_orphaned,
            "edit_cancelled": sc.edit_cancelled,
            "rekeyed_segments": st.rekeyed_segments,
            "device_bytes": tiers["device"],
            "host_bytes": tiers["host"],
            "disk_bytes": tiers["disk"],
            "promotions": st.promotions["host"] + st.promotions["disk"],
            "promotions_host": st.promotions["host"],
            "promotions_disk": st.promotions["disk"],
            "demotions": st.demotions["host"] + st.demotions["disk"],
            "demotions_host": st.demotions["host"],
            "demotions_disk": st.demotions["disk"],
            "prefetches": st.prefetches,
            "spill_writes": st.spill_writes,
            "bg_save_queue": st.writer.depth() if st.writer is not None else 0,
            "bg_saves": st.bg_saves,
            "bg_save_drops": st.bg_save_drops,
            "save_stall_s": st.save_stall_s,
            "quantized_segments": st.quantized_segments(),
            "quantized": st.quantized,
            "quant_bytes_saved": st.quant_bytes_saved,
            "dequants": self.builder.dequants,
            "fetched_segments": self.builder.fetched_segments,
            **(st.shard_report() if hasattr(st, "shard_report")
               else _SINGLE_SHARD),
            # the port's own, after repro's keys (PORT_REPORT_KEYS)
            "pack_reuses": sc.pack_reuses,
            "pack_reuse_share": sc.pack_reuse_share,
            "decode_graph_replays": sc.decode_replays,
            "decode_graph_captures": sc.decode_captures,
            "decode_graph_hit_share": sc.decode_graph_hit_share,
            "boundary_merged_share": self.builder.boundary_merged_share,
        }


def _accumulate(into: ServeStats, src: ServeStats) -> None:
    into.requests += src.requests
    into.tokens_reused += src.tokens_reused
    into.tokens_computed += src.tokens_computed
    into.tokens_decoded += src.tokens_decoded
    into.planner_s += src.planner_s
    into.prefill_s += src.prefill_s
