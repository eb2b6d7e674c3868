"""Cost model for plan optimization (§5) and store lifecycle decisions.

The paper requires only *monotonicity*: fetching more points never costs
less.  We use a calibrated affine model:

  ``F(n)``  — fetch+scan n base points:  ``io_fixed + n·bytes_row/io_bw + n·flops_row/flop_rate``
  ``C(M)``  — load a materialized model: ``model_fixed + model_bytes/model_bw``
  ``c_merge`` — combine two stat objects (pytree add): near-free.

On the 2015 prototype these were disk-seek dominated; on an accelerator the
same structure holds with HBM/DMA rates.  ``calibrate()`` measures the
constants on the running host so planner decisions track reality.

One vocabulary for every consumer.  The analytical planner prices base
scans with ``F(n)`` where n is a row count; the serving layer prices
prefill with the *same* ``F(n)`` where n is a token count (see
:func:`serve_cost_model`, which folds per-token prefill seconds into the
F(n) slope).  Because both paths speak F/C, the same instance also drives
the two store lifecycle decisions this module exposes:

  * ``admit(n, nbytes)`` — is a freshly materialized entry worth its
    bytes?  (decode-time segment admission)
  * ``reuse_benefit_s(n, nbytes)`` — seconds a future request saves by
    loading the entry instead of rebuilding it; per byte, this is the
    eviction policy's retention score (see ``core.store``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class CostModel:
    # F(n) components
    io_fixed_s: float = 2e-4          # per-request latency (seek / RPC)
    io_bytes_per_s: float = 2e9       # base-data scan bandwidth
    bytes_per_row: float = 88.0       # 10 features + target @ float64
    flops_per_row: float = 220.0      # suff-stats update per row (d²+d MACs)
    flops_per_s: float = 5e10
    # C(M) components
    model_fixed_s: float = 5e-5       # store lookup
    model_bytes_per_s: float = 4e9
    # merges
    merge_s: float = 1e-5
    # lifecycle knobs (admission / eviction, not plan costing)
    expected_reuses: float = 1.0      # prior on future hits of a new entry
    admit_min_benefit_s: float = 0.0  # required net win before storing
    # tier transfer rates (device HBM <-> host RAM <-> local disk) for the
    # residency hierarchy: conservative PCIe/NVMe-class defaults.
    # ``calibrate()`` deliberately leaves these alone — they price data
    # *movement*, not the base-data scan it fits.
    h2d_bytes_per_s: float = 8e9      # host -> device promote bandwidth
    d2h_bytes_per_s: float = 8e9      # device -> host demote bandwidth
    disk_bytes_per_s: float = 5e8     # spill-file read/write bandwidth
    disk_fixed_s: float = 5e-4        # per-spill-file open/seek latency
    # segment precision (int8 residency): quantize/dequantize are one
    # streaming pass over the payload each, priced as bandwidth like the
    # tier transfers above.  ``int8_bytes_ratio`` is the resident-size
    # ratio of a quantized segment (int8 payload + fp32 per-block scales
    # + lossless state leaves ≈ 0.27 of fp32); ``fp32_pin_reuses`` is the
    # hotness bar above which a segment's stream fidelity outweighs its
    # bytes and it stays pinned at full precision.
    quant_bytes_per_s: float = 2e10   # fused (de)quant kernel bandwidth
    dequant_bytes_per_s: float = 2e10
    int8_bytes_ratio: float = 0.27
    fp32_pin_reuses: float = 4.0
    # cross-shard wire (sharded serving): a remote segment fetch is one
    # round trip plus a bandwidth term over the compressed wire payload.
    wire_bytes_per_s: float = 2e9     # inter-shard link bandwidth
    wire_rtt_s: float = 1e-3          # per-transfer round-trip latency

    def fetch_points(self, n: int) -> float:
        if n <= 0:
            return 0.0
        return (
            self.io_fixed_s
            + n * self.bytes_per_row / self.io_bytes_per_s
            + n * self.flops_per_row / self.flops_per_s
        )

    def fetch_points_vec(self, n):
        """Vectorized F(n) for the O(V²) planner inner loop."""
        import numpy as np

        n = np.asarray(n, np.float64)
        slope = self.bytes_per_row / self.io_bytes_per_s + self.flops_per_row / self.flops_per_s
        return np.where(n <= 0, 0.0, self.io_fixed_s + n * slope)

    def use_model(self, model_bytes: int) -> float:
        return self.model_fixed_s + model_bytes / self.model_bytes_per_s

    def merge(self, k_parts: int) -> float:
        return max(k_parts - 1, 0) * self.merge_s

    # aliases matching the paper's notation
    def F(self, n: int) -> float:  # noqa: N802
        return self.fetch_points(n)

    def C(self, model_bytes: int) -> float:  # noqa: N802
        return self.use_model(model_bytes)

    # -- store lifecycle ---------------------------------------------------
    def recompute_s(self, n: int) -> float:
        """Seconds to rebuild an entry covering ``n`` points from base data.

        For the analytical store this is a base scan; for the serving
        store it is a prefill over ``n`` tokens — both are F(n) under
        their respective calibrations.
        """
        return self.fetch_points(n)

    def reuse_benefit_s(self, n: int, nbytes: int) -> float:
        """Seconds one future hit saves by loading the entry (C) instead
        of rebuilding it (F).  Negative when the entry is cheaper to
        recompute than to load — such entries should never be stored.

        ``n`` is the entry's *valid* extent (tokens / rows a rebuild would
        actually recompute); ``nbytes`` is what the entry *occupies* in
        the store.  For bucket-padded KV segments the two deliberately
        disagree — rebuild benefit scales with valid tokens while load
        cost and byte-budget pressure scale with the padded capacity — so
        callers must pass resident (padded) bytes here, which is exactly
        what ``StoredSegment.nbytes`` reports.
        """
        return self.fetch_points(n) - self.use_model(nbytes)

    def admit(self, n: int, nbytes: int, *,
              expected_reuses: Optional[float] = None) -> bool:
        """Admission control for newly materialized entries.

        Admit iff the *expected* benefit over the entry's lifetime —
        ``expected_reuses`` future hits, each saving ``reuse_benefit_s``
        — clears ``admit_min_benefit_s``.  With the defaults (one
        expected reuse, zero margin) this rejects exactly the entries
        whose load cost exceeds their rebuild cost, e.g. one-token
        decode slivers whose fixed store-lookup cost dominates.

        ``expected_reuses`` overrides the static prior per call — the
        serving ``SegmentStore`` passes the *observed* per-document reuse
        rate so admission learns which tenants actually come back (see
        ``SegmentStore.admission_prior``).  ``nbytes`` must be the bytes
        the entry will actually occupy (padded-to-bucket capacity for KV
        segments), so admission prices real residency, not the valid
        slice.
        """
        exp = self.expected_reuses if expected_reuses is None else expected_reuses
        return exp * self.reuse_benefit_s(n, nbytes) > self.admit_min_benefit_s

    # -- residency tiers ---------------------------------------------------
    def promote_s(self, nbytes: int, tier: str) -> float:
        """Seconds to bring an entry resident on ``tier`` back to device.

        ``host`` pays one h2d copy; ``disk`` additionally pays a spill-file
        open plus the file read before the copy can start.
        """
        if tier == "device":
            return 0.0
        t = nbytes / self.h2d_bytes_per_s
        if tier == "disk":
            t += self.disk_fixed_s + nbytes / self.disk_bytes_per_s
        return t

    def demote_s(self, nbytes: int, tier: str, *, source: str = "device") -> float:
        """Seconds to move an entry down to ``tier`` from ``source``.

        ``drop`` is free *now* — its cost is the future recompute, which
        :meth:`demotion_action` accounts separately.
        """
        if tier == "drop" or tier == source:
            return 0.0
        t = 0.0
        if source == "device":
            t += nbytes / self.d2h_bytes_per_s
        if tier == "disk":
            t += self.disk_fixed_s + nbytes / self.disk_bytes_per_s
        return t

    def demotion_cost_s(self, n: int, nbytes: int, tier: str, *,
                        expected_reuses: Optional[float] = None,
                        source: str = "device") -> float:
        """Expected total seconds of relieving pressure via ``tier``: pay
        the demotion now plus, per expected future hit, the promotion back
        — or, for ``"drop"``, the full rebuild ``F(n)`` per hit.  This is
        the same expected-future-seconds currency ``admit`` and the
        eviction retention score already trade in.
        """
        exp = self.expected_reuses if expected_reuses is None else expected_reuses
        if tier == "drop":
            return exp * self.recompute_s(n)
        return self.demote_s(nbytes, tier, source=source) + exp * self.promote_s(nbytes, tier)

    def demotion_action(self, n: int, nbytes: int, *,
                        tiers: tuple = ("host", "disk"),
                        expected_reuses: Optional[float] = None,
                        source: str = "device") -> str:
        """Cheapest way to relieve byte pressure for one entry: one of the
        available lower ``tiers``, or ``"drop"``.  Replaces binary evict:
        entries whose rebuild is cheaper than a round-trip (tiny valid
        extents, or ``expected_reuses`` ≈ 0 one-off documents) still get
        dropped; everything else keeps its bytes on the cheapest shelf.
        Ties prefer the higher (faster) tier.
        """
        best, best_cost = "drop", self.demotion_cost_s(
            n, nbytes, "drop", expected_reuses=expected_reuses, source=source)
        for tier in tiers:
            c = self.demotion_cost_s(n, nbytes, tier,
                                     expected_reuses=expected_reuses, source=source)
            if c < best_cost:
                best, best_cost = tier, c
        return best

    # -- delta updates (edits / add+delete data) ---------------------------
    def edit_rebuild_s(self, n_total: int, n_reused: int, reuse_nbytes: int,
                       *, k_segments: int = 1) -> float:
        """Seconds to rebuild an *edited* entry by reusing its unchanged
        prefix: load the ``k_segments`` stored segments that survive the
        edit (``C`` over their resident bytes), rescan only the
        ``n_total − n_reused`` suffix points past the divergence
        (``F``), and merge.  The paper's incremental-maintenance move in
        the same F/C vocabulary the planner, admission, and eviction
        already trade in — ``plan_edit`` compares this against a
        from-scratch ``F(n_total)`` to decide whether the edit path is
        worth taking at all.
        """
        if n_reused <= 0:
            return self.fetch_points(n_total)
        load = (k_segments * self.model_fixed_s
                + reuse_nbytes / self.model_bytes_per_s)
        suffix = max(n_total - n_reused, 0)
        parts = k_segments + (1 if suffix else 0)
        return load + self.fetch_points(suffix) + self.merge(parts)

    def edit_action(self, n_total: int, n_reused: int, reuse_nbytes: int,
                    *, k_segments: int = 1) -> str:
        """``"edit"`` when the reuse-prefix + rebuild-suffix path is
        cheaper than rebuilding from scratch, else ``"scratch"``."""
        edit = self.edit_rebuild_s(n_total, n_reused, reuse_nbytes,
                                   k_segments=k_segments)
        return "edit" if n_reused > 0 and edit < self.fetch_points(n_total) \
            else "scratch"

    def delta_update_s(self, delta_points: list, *,
                       k_merges: Optional[int] = None) -> float:
        """Seconds to maintain a materialized stats object through a set
        of add/delete ranges: one base scan per delta range plus the
        combines/uncombines folding them in (§3.2/§3.3)."""
        ks = len(delta_points) if k_merges is None else k_merges
        return sum(self.fetch_points(n) for n in delta_points) + self.merge(ks + 1)

    def update_action(self, delta_points: list, refit_points: list, *,
                      supports_delete: bool = True,
                      deleting: bool = False) -> str:
        """Arbitrate delta-maintenance vs refit for an analytics update:
        ``"delta"`` applies the add/delete ranges to the existing stats,
        ``"refit"`` rescans the new coverage from base data.  Monoid-only
        families (no inverse) must refit whenever a delete is involved.
        """
        if deleting and not supports_delete:
            return "refit"
        delta = self.delta_update_s(delta_points)
        refit = (sum(self.fetch_points(n) for n in refit_points)
                 + self.merge(len(refit_points)))
        return "delta" if delta < refit else "refit"

    # -- segment precision -------------------------------------------------
    def quantize_s(self, nbytes: int) -> float:
        """Seconds to quantize an ``nbytes`` fp32 payload to int8 — one
        streaming pass (read fp32, write int8 + scales)."""
        return nbytes / self.quant_bytes_per_s

    def dequantize_s(self, nbytes: int) -> float:
        """Seconds one future hit pays to reconstruct model precision
        from the int8 payload on the reuse path (the fused kernel's
        single pass over the *original* fp32 extent)."""
        return nbytes / self.dequant_bytes_per_s

    def precision_action(self, n: int, nbytes: int, *,
                         expected_reuses: Optional[float] = None,
                         pressured: bool = True) -> str:
        """Arbitrate one segment's storage precision: ``"fp32"`` or
        ``"int8"`` — the precision analogue of :meth:`demotion_action`.

        Quantizing trades a one-time quantize pass plus a per-hit dequant
        pass against the retention the freed bytes buy: at a fixed
        budget, the ~``1 - int8_bytes_ratio`` of the segment's bytes
        released keep comparable segments resident that would otherwise
        rebuild at ``F(n)`` per expected hit (benefit-per-byte is the
        eviction currency, so freed bytes convert to avoided rebuilds at
        the same rate).  Hot segments — ``expected_reuses`` at or above
        ``fp32_pin_reuses`` — stay fp32 while the store is *not*
        pressured, keeping the high-traffic set bit-exact; under
        pressure (the demotion path) even hot segments are priced, since
        the alternative on the table is losing the bytes entirely.
        """
        exp = self.expected_reuses if expected_reuses is None else expected_reuses
        if exp >= self.fp32_pin_reuses and not pressured:
            return "fp32"
        roundtrip = self.quantize_s(nbytes) + exp * self.dequantize_s(nbytes)
        saved = exp * self.recompute_s(n) * (1.0 - self.int8_bytes_ratio)
        return "int8" if roundtrip < saved else "fp32"

    # -- cross-shard fetch -------------------------------------------------
    def fetch_s(self, nbytes: int, *, bw: Optional[float] = None,
                rtt: Optional[float] = None) -> float:
        """Seconds to ship an ``nbytes`` wire payload from a remote shard:
        one round trip plus the bandwidth term.  The distributed C(M) —
        same shape as :meth:`use_model`, with the link replacing the
        local load path.  ``bw``/``rtt`` override the calibrated link
        (a transport that has *observed* a straggling shard passes its
        degraded estimate here).

        >>> cm = CostModel()
        >>> round(cm.fetch_s(2_000_000), 4)   # 1ms RTT + 1ms at 2 GB/s
        0.002
        """
        bw = self.wire_bytes_per_s if bw is None else bw
        rtt = self.wire_rtt_s if rtt is None else rtt
        return rtt + nbytes / bw

    def fetch_action(self, n: int, nbytes: int, *,
                     bw: Optional[float] = None,
                     rtt: Optional[float] = None) -> str:
        """Arbitrate a remote segment: ``"fetch"`` the ``nbytes`` wire
        payload, or ``"rebuild"`` its ``n`` tokens locally at ``F(n)``.
        The fetch side pays the transfer plus the dequantize pass the
        int8 wire payload needs before reuse — remote-fetch, local-
        rebuild, and miss are then priced in one F/C vocabulary.
        """
        fetch = self.fetch_s(nbytes, bw=bw, rtt=rtt) + self.dequantize_s(nbytes)
        return "fetch" if fetch < self.recompute_s(n) else "rebuild"


def serve_cost_model(*, prefill_s_per_token: float = 1e-4,
                     load_s_per_byte: float = 1e-9,
                     fixed_s: float = 1e-4) -> CostModel:
    """The serving calibration of :class:`CostModel` (one shared vocabulary).

    Maps the paper's F/C onto LM serving: "points" are document tokens, so
    ``F(n)`` prices prefilling n tokens (per-token seconds folded into the
    two slope terms, split evenly) and ``C(M)`` prices fetching a stored KV
    segment of M bytes.  The same instance then also drives segment
    admission and cost-weighted eviction, so the planner, the admission
    check, and the victim selector can never disagree about what a segment
    is worth.
    """
    cm = CostModel()
    cm.io_fixed_s = fixed_s
    # fold per-token prefill cost into the F(n) slope
    cm.bytes_per_row = 1.0
    cm.io_bytes_per_s = 2.0 / prefill_s_per_token
    cm.flops_per_row = 1.0
    cm.flops_per_s = 2.0 / prefill_s_per_token
    cm.model_fixed_s = fixed_s
    cm.model_bytes_per_s = 1.0 / load_s_per_byte
    return cm


@dataclass
class CostObservation:
    n_points: int
    seconds: float


def calibrate(fetch_fn, sizes=(1_000, 10_000, 100_000), repeats: int = 3) -> CostModel:
    """Fit ``io_fixed_s`` and effective bytes/s from timed range fetches.

    ``fetch_fn(n) -> None`` must fetch+scan ``n`` points.  Least squares on
    ``t = a + b·n``; flops term folded into the slope (they are jointly
    scanned in one pass, which is exactly how the executor behaves).
    """
    import numpy as np

    obs: list[CostObservation] = []
    for n in sizes:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fetch_fn(n)
            best = min(best, time.perf_counter() - t0)
        obs.append(CostObservation(n, best))
    ns = np.array([o.n_points for o in obs], np.float64)
    ts = np.array([o.seconds for o in obs], np.float64)
    A = np.stack([np.ones_like(ns), ns], axis=1)
    coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
    a, b = float(max(coef[0], 1e-7)), float(max(coef[1], 1e-12))
    cm = CostModel()
    cm.io_fixed_s = a
    # collapse both per-row terms into the measured slope
    cm.io_bytes_per_s = cm.bytes_per_row / (b * 0.5)
    cm.flops_per_s = cm.flops_per_row / (b * 0.5)
    return cm
