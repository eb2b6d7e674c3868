"""Materialized-model store, and the pin-aware eviction, residency hooks and
persistence it shares with the serving store.

A framework-free counterpart of ``repro.core.store``: ``PinnedStore``
(pins, cost-weighted eviction, the tier-aware pressure loop, npz-plus-
manifest snapshots), ``BackgroundWriter``, ``compact_snapshot_dir`` and
``ModelStore`` / ``StoredModel``.  The snapshot format is the JAX
package's, byte for byte in its layout (manifest version 3, one
``entry_*.npz`` per entry, sha256 per file), so a snapshot written by
either package loads in the other.

Persistence discipline: everything is written to a temporary sibling
directory and renamed into place, so ``path`` always holds a complete
snapshot; saves are incremental (entries already in the previous snapshot
are hard-linked); ``load`` verifies checksums, sweeps entry files the
manifest does not list and heals an interrupted swap.

Tensors cross into numpy only here (:func:`to_numpy` / :func:`to_torch`):
bf16 has no numpy type, so a bf16 leaf is written as 2-byte void (``|V2``,
the bytes of its ``int16`` view) — what an npz holding a JAX bf16 array
reloads as — and read back as bf16.  A snapshot's entries are serialized on the
calling thread (see :meth:`PinnedStore.save_async`), so the background
writer hashes and writes numpy arrays.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from .cost import CostModel
from .descriptors import DescriptorIndex, Range
from .suffstats import STATS_FAMILIES, Combinable

#: eviction policies understood by :class:`PinnedStore`
EVICTION_POLICIES = ("cost", "lru")

#: residency ladder, fastest first
RESIDENCY_TIERS = ("device", "host", "disk")

#: tier policies understood by the serving store ("tiered" demotes down the
#: ladder when the cost model prefers it; "evict" is binary drop)
TIER_POLICIES = ("tiered", "evict")

#: manifest filename shared by every persistent store
MANIFEST_NAME = "MANIFEST.json"

#: manifest schema version (version 3 added per-entry payload precision:
#: int8 entries carry a "precision"/"quant" record and qscale_* arrays, and
#: their npz files are deflate-compressed)
MANIFEST_VERSION = 3

#: manifest versions :meth:`PinnedStore.load` accepts; version 2 records
#: lack "precision" and load as fp32
COMPAT_MANIFEST_VERSIONS = (2, 3)

_BF16_ON_DISK = np.dtype("V2")


def to_numpy(x) -> np.ndarray:
    """A leaf as a numpy array for npz storage (a device tensor is copied
    to the host; bf16 becomes ``|V2`` holding the same bytes)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_ON_DISK)
    return x.numpy()


def to_torch(a: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`to_numpy`: ``|V2`` reads back as bf16."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def flatten_tree(tree):
    """Flatten a nested dict/list/tuple-of-arrays cache tree for npz storage.

    Returns ``(spec, leaves)``: ``spec`` is a JSON-serializable description
    of the container structure (leaf slots reference positions in
    ``leaves``, numbered in insertion order); ``leaves`` are numpy arrays.
    """
    leaves: list[np.ndarray] = []

    def go(node):
        if isinstance(node, dict):
            return {"t": "dict", "items": [[k, go(v)] for k, v in node.items()]}
        if isinstance(node, (list, tuple)):
            kind = "tuple" if isinstance(node, tuple) else "list"
            return {"t": kind, "items": [go(v) for v in node]}
        if node is None:
            return {"t": "none"}
        leaves.append(to_numpy(node))
        return {"t": "leaf", "i": len(leaves) - 1}

    return go(tree), leaves


def unflatten_tree(spec, leaves, *, leaf_fn=None):
    """Inverse of :func:`flatten_tree`; ``leaf_fn`` maps each loaded array
    (e.g. onto the device at load time)."""

    def go(node):
        t = node["t"]
        if t == "dict":
            return {k: go(v) for k, v in node["items"]}
        if t in ("list", "tuple"):
            out = [go(v) for v in node["items"]]
            return tuple(out) if t == "tuple" else out
        if t == "none":
            return None
        leaf = leaves[node["i"]]
        return leaf_fn(leaf) if leaf_fn is not None else leaf

    return go(spec)


def _link_or_copy(src: Path | str, dst: Path | str) -> None:
    """Hard-link ``src`` to ``dst``, falling back to a metadata-preserving
    copy on filesystems that refuse links."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


class BackgroundWriter:
    """Single-worker, bounded-queue executor for store I/O.

    One worker means writes are totally ordered (a spill enqueued before a
    snapshot lands first, so the snapshot can hard-link it); the bounded
    queue gives backpressure — :meth:`submit` returns ``False`` when full
    and the caller drops the job (snapshots coalesce) or runs it inline
    (spills must land).  The worker is a daemon thread.
    """

    def __init__(self, maxsize: int = 8) -> None:
        self._q: queue.Queue = queue.Queue(maxsize)
        self._thread: Optional[threading.Thread] = None
        self.jobs_done = 0
        self.jobs_failed = 0

    def submit(self, fn) -> bool:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="store-writer", daemon=True)
            self._thread.start()
        try:
            self._q.put_nowait(fn)
        except queue.Full:
            return False
        return True

    def depth(self) -> int:
        """Jobs queued or running (0 when idle)."""
        return int(self._q.unfinished_tasks)

    def drain(self) -> None:
        """Block until every submitted job has finished."""
        self._q.join()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                fn()
            except Exception:     # counted; a save job records its own error
                self.jobs_failed += 1
            else:
                self.jobs_done += 1
            finally:
                self._q.task_done()


@dataclass
class _SaveItem:
    """One entry of a snapshot, frozen on the calling thread.

    ``source`` is a ``(path, record)`` pair when the entry's npz bytes
    already exist on disk and can be hard-linked; otherwise ``payload``
    holds the entry's ``(arrays, record)`` as numpy arrays, serialized on
    the calling thread.
    """

    key: str
    entry: Any
    source: Optional[tuple[Path, dict]]
    payload: Optional[tuple[dict, dict]]
    manifest: dict
    retention: dict


class PinnedStore:
    """Pin-aware, cost-model-weighted eviction, residency hooks and
    persistence for byte-budgeted stores.

    Entries are materialized *during* plan execution, so a put-triggered
    eviction must never reclaim an entry a still-running plan references.
    Pins are reentrant counts.  Subclasses provide ``byte_budget``,
    ``nbytes()`` and ``evictions`` plus the ``_entries()`` /
    ``_evict(victim)`` hooks, and the entry (de)serialization hooks.

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
                 decay_half_life_s: float = 300.0,
                 writer: Optional[BackgroundWriter] = None) -> None:
        self._pins: dict[str, int] = {}
        self.cost = cost_model if cost_model is not None else CostModel()
        policy = "cost" if policy is None else policy
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"expected one of {EVICTION_POLICIES}")
        self.policy = policy
        self.decay_half_life_s = decay_half_life_s
        # incremental-snapshot state: entry key -> manifest record of the
        # entry's immutable part as last written/loaded (file, checksum)
        self._entry_records: dict[str, dict] = {}
        self._snapshot_dir: Optional[Path] = None
        #: {"written": n, "reused": m} for the most recent save()
        self.last_save: dict[str, int] = {}
        # _records_dirty guards the race an off-thread save opens: a put()
        # that replaces an entry after the save captured must not have its
        # stale record re-installed when the write lands
        self._writer = writer
        self._records_lock = threading.Lock()
        self._records_dirty: set[str] = set()
        self._save_pending = False
        self._load_src: Optional[Path] = None
        self.bg_saves = 0
        self.bg_save_drops = 0
        self.save_errors: list[BaseException] = []
        #: seconds the calling thread spent blocked waiting on the writer
        self.save_stall_s = 0.0
        #: entry files ignored+removed by load()
        self.swept_stranded = 0

    @property
    def writer(self) -> Optional[BackgroundWriter]:
        return self._writer

    def _ensure_writer(self) -> BackgroundWriter:
        if self._writer is None:
            self._writer = BackgroundWriter()
        return self._writer

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

    # -- residency hooks ----------------------------------------------------
    # The base defaults reproduce plain evict-under-budget; the serving
    # store counts only device bytes, limits victims to the device tier and
    # may demote instead of evicting.

    def _pressure_nbytes(self) -> int:
        """Bytes counted against ``byte_budget``."""
        return self.nbytes()

    def _evictable(self, entry) -> bool:
        """Whether ``entry`` may be selected by the pressure loop (pins are
        checked separately)."""
        return True

    def _relegate(self, victim) -> bool:
        """Relieve byte pressure by one entry; ``False`` stops the loop."""
        if len(self._entries()) <= 1:
            return False
        self._evict(victim)
        self.evictions += 1
        return True

    def _enforce_tiers(self) -> None:
        """Enforce lower-tier capacity limits after the device loop."""

    def _maybe_evict(self) -> None:
        if self.byte_budget is not None:
            while self._pressure_nbytes() > self.byte_budget:
                candidates = [e for k, e in self._entries().items()
                              if k not in self._pins and self._evictable(e)]
                if not candidates:
                    break  # everything under pressure is pinned
                if not self._relegate(self._pick_victim(candidates)):
                    break
        self._enforce_tiers()

    # -- persistence (shared npz + manifest machinery) ----------------------

    def _serialize_entry(self, entry) -> tuple[dict, dict]:
        """``entry -> (arrays, record)``: numpy npz payload + the manifest
        record of the entry's frozen state (cached by incremental saves)."""
        raise NotImplementedError

    def _entry_manifest(self, entry) -> dict:
        """Manifest-only fields that may mutate after the entry's arrays are
        frozen; merged into the (possibly cached) record at every save."""
        return {}

    def _deserialize_entry(self, record: dict, arrays) -> str:
        """Re-insert one manifest record; returns the entry's store key."""
        raise NotImplementedError

    def _store_meta(self) -> dict:
        """Store-level state carried in the manifest."""
        return {}

    def _apply_store_meta(self, meta: dict) -> None:
        """Adopt store-level manifest state *before* entries deserialize."""

    def _finish_load(self, meta: dict) -> None:
        """Post-load fixups; the base re-enforces the byte budget."""
        self._maybe_evict()

    def _invalidate_record(self, key: str) -> None:
        """Drop the cached snapshot record for ``key`` (its payload was
        replaced) and mark it dirty for an in-flight background save."""
        with self._records_lock:
            self._entry_records.pop(key, None)
            self._records_dirty.add(key)

    def _entry_file_source(self, key: str, entry) -> Optional[tuple[Path, dict]]:
        """``(path, record)`` for an entry whose exact npz bytes already
        exist on disk, or ``None`` if it must be serialized."""
        with self._records_lock:
            cached = self._entry_records.get(key)
        if cached is None or self._snapshot_dir is None:
            return None
        return self._snapshot_dir / cached["file"], dict(cached)

    def _capture_save(self) -> tuple[list[_SaveItem], dict]:
        """Freeze everything a snapshot needs, on the calling thread.

        Entries whose bytes are already on disk are captured by reference;
        every other entry is serialized here to numpy arrays — for a
        device-resident segment that is a device-to-host copy which waits
        for the device — so the writer thread only hashes and writes them.
        (Should a file it was to link have vanished, it serializes that
        entry from the captured copy instead.)
        """
        items = []
        for key, entry in self._entries().items():
            source = self._entry_file_source(key, entry)
            items.append(_SaveItem(
                key=key, entry=copy.copy(entry), source=source,
                payload=None if source is not None else self._serialize_entry(entry),
                manifest=self._entry_manifest(entry),
                retention={"hits": entry.hits, "created_s": entry.created_s,
                           "last_used_s": entry.last_used_s}))
        return items, self._store_meta()

    def _write_snapshot(self, root: Path, items: list[_SaveItem],
                        store_meta: dict) -> None:
        """Serialize captured items to ``root`` (temp dir + rename)."""
        root.parent.mkdir(parents=True, exist_ok=True)
        tmp = root.parent / f".{root.name}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        written = reused = 0
        new_records: dict[str, dict] = {}
        try:
            manifest: dict[str, Any] = {
                "version": MANIFEST_VERSION,
                "kind": type(self).__name__,
                "store": store_meta,
                "entries": [],
            }
            for i, item in enumerate(items):
                fname = f"entry_{i:06d}.npz"
                fpath = tmp / fname
                record = None
                if item.source is not None:
                    src, cached = item.source
                    try:
                        _link_or_copy(src, fpath)
                        record = cached
                        reused += 1
                    except OSError:
                        record = None  # source vanished: serialize fresh
                if record is None:
                    arrays, record = item.payload if item.payload is not None \
                        else self._serialize_entry(item.entry)
                    record = dict(record)
                    # int8 payloads deflate well; fp32 keeps the raw write
                    if record.get("precision") == "int8":
                        np.savez_compressed(fpath, **arrays)
                    else:
                        np.savez(fpath, **arrays)
                    record["sha256"] = hashlib.sha256(
                        fpath.read_bytes()).hexdigest()
                    written += 1
                record["file"] = fname
                new_records[item.key] = dict(record)
                record.update(item.manifest)
                record["retention"] = item.retention
                manifest["entries"].append(record)
            (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if root.exists():
            old = root.parent / f".{root.name}.old-{os.getpid()}"
            if old.exists():
                shutil.rmtree(old)
            os.rename(root, old)
            os.rename(tmp, root)
        else:
            os.rename(tmp, root)
        # the snapshot at `root` is complete: every `.old`/`.tmp` sibling
        # (this save's and any stranded by crashed saves) is stale
        for pattern in (f".{root.name}.old-*", f".{root.name}.tmp-*"):
            for stale in root.parent.glob(pattern):
                shutil.rmtree(stale, ignore_errors=True)
        with self._records_lock:
            for k in self._records_dirty:
                new_records.pop(k, None)
            self._entry_records = new_records
        self._snapshot_dir = root
        self.last_save = {"written": written, "reused": reused}

    def save(self, path: str | Path) -> None:
        """Snapshot the store to ``path`` atomically and incrementally.

        Entry files and ``MANIFEST.json`` are written to a temporary
        sibling directory and renamed into place, so ``path`` holds either
        the previous complete snapshot or the new one.  Entries present in
        the previous snapshot are hard-linked (payloads are frozen at put
        time); only entries stored since are serialized.  Retention
        metadata rides in the manifest; pins are not persisted.  Queued
        background saves are drained first.
        """
        self.flush_saves()
        with self._records_lock:
            self._records_dirty.clear()
        items, meta = self._capture_save()
        self._write_snapshot(Path(path), items, meta)

    def save_async(self, path: str | Path) -> bool:
        """Queue a snapshot of the store's *current* state on the
        background writer and return.

        The content is captured on the calling thread, and so is the
        serialization of every entry not already on disk (device-resident
        entries pay their device-to-host copy here, before this returns);
        the worker then hashes and writes files with the same atomic
        protocol as :meth:`save`.  At most one save is in flight: requests
        made while one is pending coalesce into nothing (``bg_save_drops``).
        Worker failures land in ``save_errors``.  Returns ``True`` if
        queued.
        """
        root = Path(path)
        with self._records_lock:
            if self._save_pending:
                self.bg_save_drops += 1
                return False
            self._save_pending = True
            self._records_dirty.clear()
        items, meta = self._capture_save()

        def _job() -> None:
            try:
                self._write_snapshot(root, items, meta)
                self.bg_saves += 1
            except Exception as exc:
                self.save_errors.append(exc)
            finally:
                with self._records_lock:
                    self._save_pending = False

        if not self._ensure_writer().submit(_job):
            with self._records_lock:
                self._save_pending = False
            self.bg_save_drops += 1
            return False
        return True

    def flush_saves(self) -> float:
        """Block until every queued background write has landed; returns
        the seconds stalled (also accumulated in ``save_stall_s``)."""
        if self._writer is None:
            return 0.0
        t0 = time.perf_counter()
        self._writer.drain()
        dt = time.perf_counter() - t0
        self.save_stall_s += dt
        return dt

    def compact_snapshot(self) -> Optional[dict]:
        """Rewrite this store's snapshot directory in place with private
        copies of the manifest's entries (see :func:`compact_snapshot_dir`)
        and remap the incremental-save cache.  ``None`` if the store has
        never been snapshotted."""
        if self._snapshot_dir is None:
            return None
        self.flush_saves()
        root = self._snapshot_dir
        stats = compact_snapshot_dir(root)
        manifest = json.loads((root / MANIFEST_NAME).read_text())
        with self._records_lock:
            keep: dict[str, dict] = {}
            for rec in manifest["entries"]:
                key = rec.get("seg_id") or rec.get("model_id")
                if key in self._entry_records and key not in self._records_dirty:
                    keep[key] = {k: v for k, v in rec.items()
                                 if k != "retention"}
            self._entry_records = keep
        return stats

    @staticmethod
    def _recover_interrupted_swap(root: Path) -> None:
        """A crash between the save swap's two renames leaves ``root``
        missing and the previous snapshot under ``.{name}.old-{pid}``:
        restore it."""
        if (root / MANIFEST_NAME).exists() or root.exists() \
                or not root.parent.exists():
            return
        for old in sorted(root.parent.glob(f".{root.name}.old-*")):
            if (old / MANIFEST_NAME).exists():
                os.rename(old, root)
                return

    @classmethod
    def load(cls, path: str | Path, *, verify: bool = True, **ctor_kwargs):
        """Rebuild a store from a :meth:`save` snapshot (either package's).

        ``ctor_kwargs`` go to the subclass constructor.  With ``verify``
        every entry file's sha256 is checked.  Retention metadata is
        restored per entry; entry files the manifest does not list are
        swept (``swept_stranded``).
        """
        root = Path(path)
        cls._recover_interrupted_swap(root)
        manifest = json.loads((root / MANIFEST_NAME).read_text())
        version = manifest.get("version")
        if version not in COMPAT_MANIFEST_VERSIONS:
            raise IOError(
                f"unsupported store manifest version {version!r} at {root} "
                f"(expected one of {COMPAT_MANIFEST_VERSIONS}); re-save the "
                f"store with the current code")
        store = cls(**ctor_kwargs)
        known = {rec["file"] for rec in manifest["entries"]}
        for stray in sorted(root.glob("entry_*.npz")):
            if stray.name not in known:
                stray.unlink()
                store.swept_stranded += 1
        meta = manifest.get("store", {})
        store._apply_store_meta(meta)
        for rec in manifest["entries"]:
            fpath = root / rec["file"]
            if verify:
                digest = hashlib.sha256(fpath.read_bytes()).hexdigest()
                if digest != rec["sha256"]:
                    raise IOError(f"checksum mismatch for {rec['file']}")
            store._load_src = fpath  # for hooks that park entries lazily
            with np.load(fpath) as arrays:
                key = store._deserialize_entry(rec, arrays)
            # a tighter budget may evict entries while they load
            entry = store._entries().get(key)
            if entry is None:
                continue
            ret = rec.get("retention", {})
            entry.hits = int(ret.get("hits", entry.hits))
            entry.created_s = float(ret.get("created_s", entry.created_s))
            entry.last_used_s = float(ret.get("last_used_s",
                                              entry.last_used_s))
            # seed the incremental-snapshot cache: load-then-save writes
            # only the manifest
            store._entry_records[key] = {
                k: v for k, v in rec.items() if k != "retention"}
        store._finish_load(meta)
        store._load_src = None
        store._snapshot_dir = root
        return store


def compact_snapshot_dir(path: str | Path) -> dict:
    """Atomically rewrite a snapshot directory to its minimal form: exactly
    the entry files the manifest references, renumbered, each a private
    copy (``st_nlink == 1``); unlisted files and stale ``.old-*``/``.tmp-*``
    siblings are dropped.  Returns ``{"kept": n, "dropped": m}``."""
    root = Path(path)
    PinnedStore._recover_interrupted_swap(root)
    manifest = json.loads((root / MANIFEST_NAME).read_text())
    tmp = root.parent / f".{root.name}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    kept = 0
    known: set[str] = set()
    try:
        for i, rec in enumerate(manifest["entries"]):
            src = root / rec["file"]
            known.add(rec["file"])
            fname = f"entry_{i:06d}.npz"
            shutil.copy2(src, tmp / fname)  # a copy, never a link
            rec["file"] = fname
            kept += 1
        (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    dropped = sum(1 for f in root.glob("entry_*.npz") if f.name not in known)
    old = root.parent / f".{root.name}.old-{os.getpid()}"
    if old.exists():
        shutil.rmtree(old)
    os.rename(root, old)
    os.rename(tmp, root)
    for pattern in (f".{root.name}.old-*", f".{root.name}.tmp-*"):
        for stale in root.parent.glob(pattern):
            shutil.rmtree(stale, ignore_errors=True)
    return {"kept": kept, "dropped": dropped}


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
        # replacing an id invalidates any snapshot file cached under it
        self._invalidate_record(model_id)
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

    # -- persistence (PinnedStore hooks) -------------------------------------
    # Leaves are the stats dataclass's fields in declaration order, which is
    # the JAX package's pytree leaf order for the same class.

    def _serialize_entry(self, sm: StoredModel) -> tuple[dict, dict]:
        leaves = [getattr(sm.stats, f.name) for f in dataclasses.fields(sm.stats)]
        arrays = {f"leaf_{j}": np.asarray(x) for j, x in enumerate(leaves)}
        record = {
            "model_id": sm.model_id,
            "family": sm.family,
            "lo": sm.rng.lo,
            "hi": sm.rng.hi,
            "n_leaves": len(leaves),
        }
        return arrays, record

    def _entry_manifest(self, sm: StoredModel) -> dict:
        # meta may be amended after the put; keep it out of the cached
        # immutable record
        return {"meta": sm.meta}

    def _deserialize_entry(self, rec: dict, arrays) -> str:
        leaves = [arrays[f"leaf_{j}"] for j in range(rec["n_leaves"])]
        proto = STATS_FAMILIES[rec["family"]]
        names = [f.name for f in dataclasses.fields(proto)]
        stats = proto(**dict(zip(names, leaves)))
        return self.put(rec["family"], Range(rec["lo"], rec["hi"]), stats,
                        meta=rec.get("meta", {}), model_id=rec["model_id"])

    @classmethod
    def load(cls, path: str | Path, byte_budget: Optional[int] = None,
             verify: bool = True) -> "ModelStore":
        return super().load(path, verify=verify, byte_budget=byte_budget)
