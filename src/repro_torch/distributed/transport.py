"""Simulated inter-shard transport for the sharded segment store.

Models N shard hosts joined by a bandwidth/RTT-calibrated link, the same
way ``multipod.py`` simulates pods in-process: transfers are accounted
(bytes, simulated seconds, per-tick coalescing) rather than actually
crossing a network, so the serving benchmarks measure the *economics* of
cross-shard fetch — what the cost model prices and what the scheduler
batches — deterministically on one machine.

Health is real, not simulated: ``HeartbeatMonitor`` and
``StragglerDetector`` from :mod:`repro_torch.distributed.fault` are
wired into every transfer.  Each
completed transfer beats the shard's heartbeat and feeds the straggler
EWMA, and ``estimate_fetch_s`` prefers the *observed* per-byte rate over
the nominal link calibration — an injected straggler (``slowdown``) is
invisible to the first fetch, observed by it, and hedged against from
the next tick on.  The facade's hedging rule races that estimate against
a local rebuild priced by ``CostModel.fetch_s``/``recompute_s``.

Coalescing contract: the store calls :meth:`begin_tick` once per
scheduler tick and then at most one :meth:`transfer` per contacted shard
(a batch of segments rides one transfer).  ``coalesce_violations``
counts ticks that broke the contract — the sharded serving runs assert
it stays zero.

A copy of ``repro.distributed.transport`` (plain Python).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.fault import HeartbeatMonitor, StragglerDetector

# EWMA weight for the observed per-byte transfer rate; deliberately
# heavier than StragglerDetector's default so one slow transfer already
# shifts the next tick's estimate.
_RATE_ALPHA = 0.5


class ShardTransport:
    """Byte-accounted, health-tracked link between simulated shard hosts.

    ``slowdown[i]`` is the fault-injection hook: a multiplier on shard
    ``i``'s transfer duration that the *estimator has no direct view
    of* — it only ever learns it through observed transfers, exactly
    like a real straggler.  ``fail(i)`` stops a shard's heartbeats;
    once the simulated clock passes ``heartbeat timeout`` the shard
    reads as dead and the store stops planning fetches against it.
    """

    def __init__(self, n_shards: int, *, bw_bytes_per_s: float = 2e9,
                 rtt_s: float = 1e-3, heartbeat_timeout_s: float = 30.0,
                 monitor: Optional[HeartbeatMonitor] = None,
                 detector: Optional[StragglerDetector] = None) -> None:
        self.n_shards = int(n_shards)
        self.bw = [float(bw_bytes_per_s)] * self.n_shards
        self.rtt_s = float(rtt_s)
        self.slowdown = [1.0] * self.n_shards
        self.monitor = monitor or HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        self.detector = detector or StragglerDetector()
        self.clock = 0.0                  # simulated seconds
        self._failed: set[int] = set()
        self._rate: dict[int, float] = {}  # observed seconds-per-byte EWMA
        # traffic counters
        self.transfers = 0
        self.items_sent = 0
        self.bytes_sent = 0
        self.sim_transfer_s = 0.0
        self.ticks = 0
        self.coalesce_violations = 0
        self.max_transfers_per_shard_tick = 0
        self._tick_counts: dict[int, int] = {}
        for i in range(self.n_shards):
            self.monitor.beat(self._host(i), t=self.clock)

    @staticmethod
    def _host(i: int) -> str:
        return f"shard-{i}"

    # -- clock / fault injection ------------------------------------------
    def advance(self, dt: float) -> None:
        """Advance the simulated clock (idle time between ticks)."""
        self.clock += float(dt)

    def fail(self, shard: int) -> None:
        """Stop ``shard``'s heartbeats; it reads dead once the clock
        passes the monitor timeout (pair with :meth:`advance`)."""
        self._failed.add(shard)

    def heal(self, shard: int) -> None:
        self._failed.discard(shard)
        self.monitor.beat(self._host(shard), t=self.clock)

    # -- health ------------------------------------------------------------
    def alive(self, shard: int) -> bool:
        return self._host(shard) not in self.monitor.dead(now=self.clock)

    def straggler_shards(self) -> set[int]:
        flagged = set(self.detector.stragglers())
        return {i for i in range(self.n_shards) if self._host(i) in flagged}

    def estimate_fetch_s(self, shard: int, nbytes: int) -> float:
        """Expected seconds to fetch ``nbytes`` from ``shard`` — RTT plus
        the observed per-byte rate (nominal link rate until the first
        transfer teaches us better)."""
        spb = self._rate.get(shard, 1.0 / self.bw[shard])
        return self.rtt_s + nbytes * spb

    # -- coalescing ticks --------------------------------------------------
    def begin_tick(self) -> None:
        """Open a scheduler tick: heartbeat healthy shards, close out the
        previous tick's coalescing accounting."""
        self._close_tick()
        self.ticks += 1
        for i in range(self.n_shards):
            if i not in self._failed:
                self.monitor.beat(self._host(i), t=self.clock)

    def _close_tick(self) -> None:
        if self._tick_counts:
            worst = max(self._tick_counts.values())
            self.max_transfers_per_shard_tick = max(
                self.max_transfers_per_shard_tick, worst)
            if worst > 1:     # >1 transfer to one shard in one tick
                self.coalesce_violations += 1
        self._tick_counts = {}

    # -- transfers ---------------------------------------------------------
    def transfer(self, shard: int, nbytes: int, *, items: int = 1) -> float:
        """Account one batched transfer from ``shard``; returns simulated
        seconds.  Advances the clock, beats the shard's heartbeat, and
        feeds the straggler detector and the observed-rate EWMA."""
        if shard in self._failed:
            raise RuntimeError(f"shard {shard} is down")
        dur = (self.rtt_s + nbytes / self.bw[shard]) * self.slowdown[shard]
        self.clock += dur
        host = self._host(shard)
        self.monitor.beat(host, t=self.clock)
        self.detector.observe(host, dur)
        obs = max(dur - self.rtt_s, 0.0) / max(nbytes, 1)
        prev = self._rate.get(shard)
        self._rate[shard] = obs if prev is None else (
            (1 - _RATE_ALPHA) * prev + _RATE_ALPHA * obs)
        self.transfers += 1
        self.items_sent += items
        self.bytes_sent += nbytes
        self.sim_transfer_s += dur
        self._tick_counts[shard] = self._tick_counts.get(shard, 0) + 1
        return dur

    def report(self) -> dict:
        """Flat counters (all finite on an idle transport)."""
        self._close_tick()
        return {
            "remote_transfers": self.transfers,
            "remote_fetch_items": self.items_sent,
            "remote_fetch_bytes": self.bytes_sent,
            "fetch_ticks": self.ticks,
            "coalesce_violations": self.coalesce_violations,
            "max_transfers_per_shard_tick": self.max_transfers_per_shard_tick,
            "sim_transfer_s": round(self.sim_transfer_s, 6),
        }
