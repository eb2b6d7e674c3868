"""Fault tolerance & elasticity: heartbeats, stragglers, re-mesh planning.

At 1000+ nodes the questions are *when do we notice*, *what do we do with
the step in flight*, and *what mesh do we run on afterwards*.  This module
answers all three in plain, testable logic; the launcher wires it to the
train loop, and the checkpoint layer (mesh-agnostic restore) makes the
re-mesh executable.

A copy of ``repro.distributed.fault`` (plain Python); on the serving path
:mod:`repro_torch.distributed.transport` wires it into every transfer.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class HeartbeatMonitor:
    """Tracks per-host liveness from heartbeat timestamps."""

    timeout_s: float = 30.0
    _last: dict[str, float] = field(default_factory=dict)

    def beat(self, host: str, t: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if t is None else t

    def dead(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t <= self.timeout_s)


@dataclass
class StragglerDetector:
    """EWMA step-time tracker; flags hosts slower than ``factor``× the fleet.

    The mitigation at the data layer is hedged fetches (pipeline issues a
    backup read when a shard exceeds the deadline); at the step layer it is
    exclusion from the next re-mesh if persistently slow.
    """

    alpha: float = 0.2
    factor: float = 2.0
    min_samples: int = 3
    _ewma: dict[str, float] = field(default_factory=dict)
    _count: dict[str, int] = field(default_factory=dict)

    def observe(self, host: str, step_seconds: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (
            step_seconds if prev is None else (1 - self.alpha) * prev + self.alpha * step_seconds
        )
        self._count[host] = self._count.get(host, 0) + 1

    def fleet_median(self) -> float:
        """Lower median of per-host EWMAs.

        The *lower* middle element matters for even fleet sizes: the
        upper median (``vals[len // 2]``) lets a single slow host drag
        the threshold past itself — with two hosts the slow one *is*
        the upper median, so ``v > factor * med`` could never fire and
        a 2-shard deployment was blind to its own straggler.
        """
        vals = sorted(self._ewma.values())
        if not vals:
            return 0.0
        return vals[(len(vals) - 1) // 2]

    def stragglers(self) -> list[str]:
        med = self.fleet_median()
        if med <= 0:
            return []
        return sorted(
            h
            for h, v in self._ewma.items()
            if self._count.get(h, 0) >= self.min_samples and v > self.factor * med
        )


def plan_elastic_mesh(n_hosts: int, chips_per_host: int = 4,
                      model_parallel: int = 16) -> tuple[int, ...]:
    """Largest (data, model) mesh from surviving hosts.

    Keeps `model` fixed (TP degree is an arch property; changing it would
    invalidate the sharded compile) and shrinks `data` to the largest
    power-of-two that fits — checkpoint restore re-shards parameters, the
    data pipeline re-splits its shards, and training resumes.
    """
    chips = n_hosts * chips_per_host
    data = chips // model_parallel
    if data < 1:
        raise ValueError(f"{chips} chips cannot host model_parallel={model_parallel}")
    data_pow2 = 2 ** int(math.floor(math.log2(data)))
    return (data_pow2, model_parallel)


@dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0

    def run(self, fn: Callable, *args, on_retry: Optional[Callable] = None, **kw):
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kw)
            except Exception as e:  # pragma: no cover - timing-dependent
                if attempt == self.max_retries:
                    raise
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(delay)
                delay *= self.backoff_mult
