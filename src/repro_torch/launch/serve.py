"""Serving driver of the PyTorch port: descriptor-planned prefix reuse,
one session over one document, or ``--sessions N`` batched sessions over
a shared segment store.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
      --reduced --doc-len 2048 --requests 8 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
      --reduced --sessions 4 --shared-docs 2 --requests 2 --new-tokens 5 \
      --chunk-tokens 64 --byte-budget 300000 --edit-every 1

run on the CUDA device; ``--device cpu`` runs the same path on the CPU
(the kernels' plain versions).  The flags are those of
``python -m repro.launch.serve`` and the printed lines keep its wording.
A cross-attention stack (``whisper-large-v3``, ``llama-3.2-vision-11b``)
serves over ``repro``'s stub context, zero encoder frames or image
patches.

Residency: ``--store-dir`` reloads a snapshot at start (when one exists),
re-snapshots every ``--snapshot-every`` requests on the background writer
(``--sync-saves`` to block instead) and always takes a final snapshot,
compacted with ``--compact-final``; ``--host-budget`` / ``--spill-dir``
open host and disk tiers below ``--byte-budget``; ``--segment-precision
int8`` stores every segment as blockwise int8, dequantized on reuse by
the ``quant_kv`` kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
      --reduced --device cpu --doc-len 512 --requests 3 --byte-budget 200000 \
      --host-budget 200000 --spill-dir /tmp/kvspill --segment-precision int8 \
      --store-dir /tmp/kvstore

Sharded serving: ``--shards N`` spreads the store over N consistent-hash
shards (simulated in-process hosts on one device, each with its own tiers
at the per-shard budgets).  Documents homed on a remote shard are fetched
over a simulated wire (``--shard-bw`` / ``--shard-rtt``), one transfer per
shard per scheduler tick, int8-quantized and deflated; fetches past
``--hedge-deadline`` race a local rebuild (first done wins):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
      --reduced --device cpu --doc-len 256 --sessions 4 --shared-docs 0 \
      --requests 2 --new-tokens 4 --shards 2 --shard-rtt 1e-6
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch import resolve_device


def _tier_kwargs(args) -> dict:
    """Residency-tier and precision settings from the command line (empty:
    a device-only store at the resolved precision)."""
    kw = {}
    if args.host_budget > 0:
        kw["host_budget"] = args.host_budget
    if args.spill_dir:
        kw["spill_dir"] = args.spill_dir
    if args.tier_policy:
        kw["tier_policy"] = args.tier_policy
    if args.segment_precision:
        kw["precision"] = args.segment_precision
    return kw


def _load_store(args, budget, tiers, device):
    """The segment store of ``--store-dir``'s snapshot (either package's),
    or ``None`` when there is none yet.  Documents are content-keyed, so a
    snapshot of other documents yields no hits; a snapshot is valid only
    for the (arch, seed) it was taken under."""
    if not args.store_dir:
        return None
    if args.shards > 1:
        from repro_torch.serve.shard_store import ShardedSegmentStore

        if not any(Path(args.store_dir).glob("shard-*")):
            return None   # no snapshot yet: this run populates it
        store = ShardedSegmentStore.load(
            args.store_dir, n_shards=args.shards, byte_budget=budget,
            policy=args.eviction_policy,
            bw_bytes_per_s=args.shard_bw, rtt_s=args.shard_rtt,
            hedge_deadline_s=args.hedge_deadline, device=device, **tiers)
        print(f"warm start: reloaded {store.total_segments()} segments "
              f"({store.total_nbytes()/1e6:.1f} MB, "
              f"{len(store.doc_ids())} documents, {store.n_shards} shards) "
              f"from {args.store_dir}")
        return store
    from repro_torch.serve.kv_cache import SegmentStore

    try:
        store = SegmentStore.load(args.store_dir, byte_budget=budget,
                                  policy=args.eviction_policy, device=device,
                                  **tiers)
    except FileNotFoundError:
        return None       # no snapshot yet: this run populates it
    print(f"warm start: reloaded {len(store)} segments "
          f"({store.nbytes()/1e6:.1f} MB, {len(store.doc_ids())} documents) "
          f"from {args.store_dir}")
    return store


def _make_store(args, budget, seq_bucket, device):
    """Load or create the store when the residency flags ask for one;
    ``None`` lets the engine build its own device-only store."""
    from repro_torch.core.cost import serve_cost_model
    from repro_torch.serve.kv_cache import SegmentStore

    tiers = _tier_kwargs(args)
    store = _load_store(args, budget, tiers, device)
    if store is not None:
        return store
    if args.shards > 1:
        # shard count, wire calibration and hedging are store-creation
        # parameters: a sharded store is always made here
        from repro_torch.serve.shard_store import ShardedSegmentStore

        return ShardedSegmentStore(
            args.shards, byte_budget=budget, cost_model=serve_cost_model(),
            policy=args.eviction_policy, seq_bucket=seq_bucket,
            bw_bytes_per_s=args.shard_bw, rtt_s=args.shard_rtt,
            hedge_deadline_s=args.hedge_deadline, device=device, **tiers)
    if not tiers:
        return None
    return SegmentStore(byte_budget=budget, cost_model=serve_cost_model(),
                        policy=args.eviction_policy, seq_bucket=seq_bucket,
                        device=device, **tiers)


def _snapshot(store, args, *, final: bool = False) -> None:
    if not args.store_dir:
        return
    if not final:
        # periodic snapshots ride the background writer (coalesced when one
        # is in flight) unless --sync-saves
        if args.background_saves:
            store.save_async(args.store_dir)
        else:
            store.save(args.store_dir)
        return
    # the final snapshot is synchronous (save() drains queued writes first)
    store.save(args.store_dir)
    if args.compact_final:
        res = store.compact_snapshot()
        if res is not None:
            print(f"compacted snapshot: kept {res['kept']}, "
                  f"dropped {res['dropped']}")
    print(f"snapshot: {len(store)} segments ({store.nbytes()/1e6:.1f} MB) "
          f"-> {args.store_dir}")


def _print_tier_report(store, args) -> None:
    tiers = store.tier_bytes()
    print(f"  tiers ({store.tier_policy} policy): "
          f"device {tiers['device']/1e6:.1f} MB, "
          f"host {tiers['host']/1e6:.1f} MB, "
          f"disk {tiers['disk']/1e6:.1f} MB")
    print(f"  tier traffic: promotions {sum(store.promotions.values())} "
          f"(host {store.promotions['host']}, disk {store.promotions['disk']}), "
          f"demotions {sum(store.demotions.values())} "
          f"(host {store.demotions['host']}, disk {store.demotions['disk']}), "
          f"prefetches {store.prefetches}, spill writes {store.spill_writes}")
    print(f"  precision ({store.precision} policy): "
          f"{store.quantized_segments()} int8 segments resident, "
          f"{store.quantized} quantized, "
          f"{store.quant_bytes_saved/1e6:.1f} MB saved")
    if args.store_dir:
        w = store.writer
        print(f"  background saves: {store.bg_saves} completed, "
              f"{store.bg_save_drops} coalesced, "
              f"queue {w.depth() if w is not None else 0}, "
              f"stall {store.save_stall_s*1e3:.1f} ms, "
              f"errors {len(store.save_errors)}")


def _print_shard_report(st) -> None:
    """Per-shard occupancy and fetch-traffic lines (sharded stores only)."""
    if not hasattr(st, "shard_summaries"):
        return
    rep = st.shard_report()
    print(f"  fetch traffic ({rep['shards']} shards): "
          f"{rep['remote_fetches']} segments fetched "
          f"({rep['remote_fetch_wire_bytes']/1e6:.1f} MB wire) over "
          f"{rep['remote_transfers']} transfers, "
          f"{rep['fetched_hits']} fetched hits, "
          f"{rep['on_demand_fetches']} on-demand, "
          f"{rep['coalesce_violations']} coalesce violations")
    print(f"  hedging: {rep['hedged_fetches']} hedged "
          f"({rep['hedge_rebuild_wins']} rebuild wins, "
          f"{rep['hedge_fetch_wins']} fetch wins, "
          f"{rep['cancelled_fetches']} fetches cancelled), "
          f"{rep['dead_shard_skips']} dead-shard skips, "
          f"{rep['put_forwards']} put-forwards "
          f"({rep['put_forward_bytes']/1e6:.1f} MB)")
    for s in st.shard_summaries():
        print(f"  shard {s['shard']}: {s['segments']} segments, "
              f"device {s['device_bytes']/1e6:.1f} MB, "
              f"host {s['host_bytes']/1e6:.1f} MB, "
              f"disk {s['disk_bytes']/1e6:.1f} MB, "
              f"{s['hits']} hits, {s['evictions']} evictions, "
              f"{s['docs']} docs")


def _extras(cfg) -> dict:
    """The stub frontends' context features, ``repro``'s: zeros in fp32,
    (1, 1500, d) encoder frames or (1, 1601, d) image patches."""
    extras = {}
    if cfg.encoder_layers:
        extras["enc_feats"] = np.zeros((1, cfg.encoder_context, cfg.d_model), np.float32)
    if cfg.vision_context:
        extras["image_embeds"] = np.zeros((1, cfg.vision_context, cfg.d_model), np.float32)
    return extras


def run_single(args, cfg, model, params, rng, device) -> None:
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.session import doc_key

    doc = rng.integers(0, cfg.vocab_size, args.doc_len).astype(np.int32)
    budget = args.byte_budget if args.byte_budget > 0 else None
    store = _make_store(args, budget, 64, device)   # ServeEngine's seq_bucket
    store_kw = (dict(store=store) if store is not None
                else dict(byte_budget=budget,
                          eviction_policy=args.eviction_policy))
    extras = _extras(cfg)
    eng = ServeEngine(model, params, doc, extras=extras, chunk_tokens=args.chunk_tokens,
                      doc_id=doc_key(doc, extras), device=device, **store_kw)
    for i in range(args.requests):
        L = int(rng.integers(args.doc_len // 4, args.doc_len))
        toks, plan = eng.generate(L, args.new_tokens, greedy=False, seed=i)
        print(f"req {i}: prefix {L:6d}  reused-models {len(plan.models_used):3d}  "
              f"tokens {toks[:8]}…")
        if args.snapshot_every and (i + 1) % args.snapshot_every == 0:
            _snapshot(eng.store, args)
    _snapshot(eng.store, args, final=True)
    s = eng.stats
    print(f"\n{s.requests} requests: reuse {s.reuse_frac:.1%} "
          f"({s.tokens_reused} reused / {s.tokens_computed} computed), "
          f"planner {s.planner_s*1e3:.1f} ms total, prefill {s.prefill_s:.2f}s, "
          f"decode {s.decode_s:.2f}s, store {len(eng.store)} segments "
          f"({eng.store.nbytes()/1e6:.1f} MB)")
    _print_tier_report(eng.store, args)
    _print_shard_report(eng.store)


def run_multi(args, cfg, model, params, rng, device) -> None:
    from repro_torch.serve.session import SessionManager

    n_shared = min(max(args.shared_docs, 0), args.sessions)
    shared_doc = rng.integers(0, cfg.vocab_size, args.doc_len).astype(np.int32)
    unique_docs = [rng.integers(0, cfg.vocab_size, args.doc_len).astype(np.int32)
                   for _ in range(args.sessions - n_shared)]
    budget = args.byte_budget if args.byte_budget > 0 else None
    store = _make_store(args, budget, args.chunk_tokens, device)  # = decode_bucket
    store_kw = (dict(store=store) if store is not None
                else dict(byte_budget=budget,
                          eviction_policy=args.eviction_policy))
    mgr = SessionManager(model, params, chunk_tokens=args.chunk_tokens,
                         decode_bucket=args.chunk_tokens,
                         max_batch=args.max_batch,
                         decode_materialize=not args.no_decode_materialize,
                         async_prefill=args.async_prefill,
                         **store_kw)
    extras = _extras(cfg)
    # the first `n_shared` sessions all serve one document; the rest get unique docs
    sids = []
    for i in range(args.sessions):
        doc = shared_doc if i < n_shared else unique_docs[i - n_shared]
        sids.append(mgr.add_session(doc, extras=extras))

    import time

    edit_reused = edit_rebuilt = 0
    t0 = time.perf_counter()
    for r in range(args.requests):
        # one submit per request, as repro.launch.serve does: against a
        # sharded store each remote document's prefetch is its own tick
        for i, sid in enumerate(sids):
            dl = len(mgr.sessions[sid].doc)
            L = int(rng.integers(max(dl // 4, 1), max(dl, 2)))
            plan = mgr.submit(sid, L, args.new_tokens, greedy=False,
                              seed=r * 1000 + i)
            assert plan.validate_telescoping()
        mgr.run()
        if args.edit_every and (r + 1) % args.edit_every == 0:
            # edit traffic: each session's document mutates mid-stream and
            # the store keeps every segment before the divergence point
            from repro_torch.data.edits import EDIT_KINDS, random_edit

            kinds = (EDIT_KINDS if args.edit_kind == "random"
                     else (args.edit_kind,))
            for sid in sids:
                doc = mgr.sessions[sid].doc
                new_doc, _, _, _ = random_edit(
                    rng, doc, cfg.vocab_size, kinds=kinds,
                    max_span=args.edit_span, min_offset=len(doc) // 4)
                eplan = mgr.update_document(sid, new_doc)
                edit_reused += eplan.reused_tokens
                edit_rebuilt += eplan.rebuild_tokens
        if args.snapshot_every and (r + 1) % args.snapshot_every == 0:
            _snapshot(mgr.store, args)
    wall = time.perf_counter() - t0
    _snapshot(mgr.store, args, final=True)

    agg = mgr.aggregate_stats()
    st = mgr.store
    print(f"{args.sessions} sessions × {args.requests} requests "
          f"({n_shared} on a shared doc):")
    print(f"  aggregate: {agg.tokens_decoded} tokens decoded, "
          f"{agg.tokens_decoded / wall:.1f} tok/s wall, reuse {agg.reuse_frac:.1%} "
          f"({agg.tokens_reused} reused / {agg.tokens_computed} computed)")
    print(f"  store: {len(st)} segments, {st.nbytes()/1e6:.1f} MB, "
          f"{st.evictions} evictions ({st.policy} policy), "
          f"{st.cross_session_hits} cross-session hits")
    print(f"  scheduler: {mgr.sched.decode_calls} batched decode calls, "
          f"mean batch {mgr.sched.mean_batch:.2f}, "
          f"{mgr.sched.pack_rebuilds} pack rebuilds")
    print(f"  decode materialization: {mgr.sched.decode_segments} segments "
          f"admitted, {mgr.sched.decode_rejects} rejected")
    rep = mgr.report()   # finite even on an idle run
    packing = "merged ragged" if mgr.merge_decode_packs else "capacity-split"
    print(f"  decode packs ({packing}, {mgr.decode_mode} attention): "
          f"padded occupancy {rep['decode_padded_frac']:.1%} "
          f"({rep['decode_valid_tokens']} valid / "
          f"{rep['decode_padded_tokens']} padded KV tokens), "
          f"attn ~{rep['decode_attn_flops']/1e9:.3f} GFLOP")
    mode = "async" if mgr.async_prefill else "sync"
    print(f"  pipeline ({mode} prefill): {rep['tickets_launched']} builds "
          f"launched, {rep['tickets_joined']} joined "
          f"(mean join wait {rep['mean_join_wait_s']*1e3:.1f} ms), "
          f"{rep['overlap_steps']} decode rounds overlapped builds "
          f"(mean batch {rep['overlap_batch']:.2f})")
    if args.edit_every:
        sc = mgr.sched
        tot = edit_reused + edit_rebuilt
        print(f"  edits: {sc.edits} applied, "
              f"{sc.edit_reused_segments} segments rekeyed, "
              f"{sc.edit_orphaned} orphaned, "
              f"{sc.edit_cancelled} requests cancelled, "
              f"reused {edit_reused}/{tot} planned tokens "
              f"({edit_reused / tot if tot else 0.0:.1%})")
    _print_tier_report(st, args)
    _print_shard_report(st)
    if args.store_dir and st.last_save:
        print(f"  snapshot: {st.last_save['written']} entries written, "
              f"{st.last_save['reused']} reused from the previous snapshot")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--doc-len", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--chunk-tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sessions", type=int, default=1,
                    help=">1 switches to the multi-session batched engine")
    ap.add_argument("--shared-docs", type=int, default=2,
                    help="multi-session only: sessions serving one document")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="multi-session only: decode batch limit")
    ap.add_argument("--byte-budget", type=int, default=0,
                    help="segment-store budget in bytes (0 = unbounded)")
    ap.add_argument("--eviction-policy", choices=["cost", "lru"], default=None,
                    help="victim selection under --byte-budget: cost-model "
                         "benefit-per-byte (default) or global LRU")
    ap.add_argument("--no-decode-materialize", action="store_true",
                    help="multi-session only: no decode write-back")
    ap.add_argument("--async-prefill", dest="async_prefill",
                    action="store_true", default=True,
                    help="multi-session only: pipelined prefix builds")
    ap.add_argument("--sync-prefill", dest="async_prefill",
                    action="store_false",
                    help="multi-session only: blocking prefix builds")
    ap.add_argument("--edit-every", type=int, default=0,
                    help="multi-session only: after every N request rounds, "
                         "edit each session's document and serve the edited "
                         "text through the delta-update path (0 = no edits)")
    ap.add_argument("--edit-kind", choices=["insert", "delete", "replace",
                                            "random"], default="random",
                    help="which edit --edit-every applies")
    ap.add_argument("--edit-span", type=int, default=16,
                    help="most tokens one edit inserts, deletes or replaces")
    ap.add_argument("--store-dir", default="")
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--host-budget", type=int, default=0)
    ap.add_argument("--spill-dir", default="")
    ap.add_argument("--tier-policy", choices=["tiered", "evict"], default=None)
    ap.add_argument("--segment-precision", choices=["auto", "fp32", "int8"],
                    default=None)
    ap.add_argument("--shards", type=int, default=1,
                    help=">1 spreads the store over N consistent-hash shards "
                         "(simulated hosts); the budgets and --spill-dir "
                         "apply per shard")
    ap.add_argument("--shard-bw", type=float, default=2e9,
                    help="simulated cross-shard wire bandwidth, bytes/s")
    ap.add_argument("--shard-rtt", type=float, default=1e-3,
                    help="simulated cross-shard round trip, s")
    ap.add_argument("--hedge-deadline", type=float, default=0.05,
                    help="estimated fetch seconds past which a fetch races "
                         "a local rebuild")
    ap.add_argument("--background-saves", dest="background_saves",
                    action="store_true", default=True)
    ap.add_argument("--sync-saves", dest="background_saves",
                    action="store_false")
    ap.add_argument("--compact-final", action="store_true")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "repro_torch.launch.serve")

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import LM

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = LM(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed)
    if args.sessions > 1:
        run_multi(args, cfg, model, params, rng, device)
    else:
        run_single(args, cfg, model, params, rng, device)


if __name__ == "__main__":
    sys.exit(main())
