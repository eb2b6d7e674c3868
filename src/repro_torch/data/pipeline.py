"""Sharded, prefetching, checkpointable input pipeline with hedged reads
(a numpy copy of ``repro.data.pipeline``: the same batches for the same
``(seed, shard, step)``).

Design points that matter at fleet scale:

  * **Addressable batches**: every (shard, step) maps to a deterministic
    batch, so pipeline state is just an integer — checkpoint/restore and
    elastic re-sharding are trivial and exact.
  * **Prefetch thread** keeps a bounded queue ahead of the consumer.
  * **Hedged (backup) fetches**: if a shard's fetch exceeds a deadline the
    pipeline reissues it (straggler mitigation à la MapReduce backup tasks);
    first responder wins, both results are identical by construction.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class PipelineState:
    step: int = 0


class ShardedPipeline:
    """Assembles global batches from per-shard fetches.

    ``fetch(shard, step) -> dict[str, np.ndarray]`` must be deterministic.
    """

    def __init__(
        self,
        fetch: Callable[[int, int], dict],
        n_shards: int,
        *,
        prefetch: int = 2,
        hedge_deadline_s: Optional[float] = None,
        max_workers: int = 8,
    ) -> None:
        self.fetch = fetch
        self.n_shards = n_shards
        self.state = PipelineState()
        self.hedge_deadline_s = hedge_deadline_s
        self.hedges_issued = 0
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None

    # -- core fetch with hedging ------------------------------------------
    def _fetch_shard(self, shard: int, step: int) -> dict:
        if self.hedge_deadline_s is None:
            return self.fetch(shard, step)
        primary = self._pool.submit(self.fetch, shard, step)
        done, _ = wait([primary], timeout=self.hedge_deadline_s,
                       return_when=FIRST_COMPLETED)
        if done:
            return primary.result()
        self.hedges_issued += 1
        backup = self._pool.submit(self.fetch, shard, step)
        done, _ = wait([primary, backup], return_when=FIRST_COMPLETED)
        return next(iter(done)).result()

    def _assemble(self, step: int) -> dict:
        futs = [self._pool.submit(self._fetch_shard, s, step) for s in range(self.n_shards)]
        parts = [f.result() for f in futs]
        return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}

    # -- iteration -----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._producer is None:
            self._start_producer()
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        self.state.step += 1
        return item

    def _start_producer(self) -> None:
        def run():
            step = self.state.step
            while not self._stop.is_set():
                try:
                    batch = self._assemble(step)
                except Exception as e:
                    self._q.put(e)
                    return
                self._q.put(batch)
                step += 1

        self._producer = threading.Thread(target=run, daemon=True)
        self._producer.start()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- checkpoint / elasticity ------------------------------------------
    def snapshot(self) -> dict:
        return {"step": self.state.step, "n_shards": self.n_shards}

    @classmethod
    def resume(cls, snap: dict, fetch, *, n_shards: Optional[int] = None, **kw):
        """Re-shard on resume: a different shard count replays the *same*
        global batches as long as ``fetch`` derives data from (shard, step)
        addresses within a fixed global layout."""
        p = cls(fetch, n_shards if n_shards is not None else snap["n_shards"], **kw)
        p.state.step = snap["step"]
        return p


def lm_pipeline(vocab: int, batch: int, seq: int, *, n_shards: int = 4,
                seed: int = 0, **kw) -> ShardedPipeline:
    """Pipeline over the synthetic token stream (global layout is fixed by
    total batch; shard count only changes who fetches what)."""
    from .tokens import TokenStream

    stream = TokenStream(vocab, seed=seed)
    assert batch % n_shards == 0
    per = batch // n_shards

    def fetch(shard: int, step: int) -> dict:
        return stream.batch(shard, step, per, seq)

    return ShardedPipeline(fetch, n_shards, **kw)
