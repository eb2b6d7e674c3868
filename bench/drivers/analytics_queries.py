"""One analyst in a closed loop over ``IncrementalAnalyticsEngine``.

Set-up makes the configuration's two tables from the seed (regression rows
for linear regression; two-class rows for Gaussian Naive Bayes and logistic
regression), puts them on the card through ``ArrayBackend``, and warms each
family's store with models of N(mean, std) rows at uniform positions until
the family's coverage reaches the traffic's ``coverage``.  Those ranges come
from the traffic's ``store_seed``, so every seed plans over the same store,
filled in a seed-drawn order.  The store is then frozen
(``materialize="never"``), as the paper's Fig 2 measures.

The analyst sends the next query as soon as the last one's model is on the
host.  A query's family cycles through the families in a seed-drawn order
per round; its size is the N(mean, std) quantile of a Weyl sequence and its
position a uniform one, so every seed offers the same sizes in another
order.
"""
from __future__ import annotations

import contextlib
import gc
import math
import random
import statistics
import time

import numpy as np
import torch

from bench import core
from bench import trace as tr
from bench.data import synthetic
from bench.reference import analytics as ref

ALPHA = {"size": (math.sqrt(5.0) - 1.0) / 2.0, "pos": math.sqrt(2.0) - 1.0}


def family_params(config: dict, family: str) -> dict:
    if family == "logreg":
        return {"chunk_size": config["logreg_chunk"], "lam": config["logreg_lam"],
                "lr": config["logreg_lr"]}
    if family == "linreg":
        return {"lam": config["linreg_lam"]}
    return {}


class Queries:
    def __init__(self, config: dict, seed: int) -> None:
        self.c = config
        self.rng = np.random.default_rng([seed, 2])
        self.u = self.rng.random(2)
        self.j = 0
        self.order: list[str] = []
        self.norm = statistics.NormalDist(config["query_mean"], config["query_std"])

    def next(self) -> tuple[str, int, int]:
        n = self.c["n_points"]
        if not self.order:
            self.order = list(self.rng.permutation(self.c["families"]))
        fam = self.order.pop(0)
        us = (self.u[0] + self.j * ALPHA["size"]) % 1.0
        up = (self.u[1] + self.j * ALPHA["pos"]) % 1.0
        self.j += 1
        size = int(min(max(self.norm.inv_cdf(min(max(us, 1e-6), 1 - 1e-6)), 1000), n - 1))
        lo = int(up * (n - size))
        return fam, lo, lo + size


def tables(config: dict, seed: int, device="cpu") -> dict:
    """{family: (X, y)} float32 rows drawn on ``device`` from the seed, as
    host arrays: the same arrays go to the card (the program) and to the
    reference."""
    gen = torch.Generator(device=device).manual_seed((seed * 2 + 1) % 2**63)
    n, d = config["n_points"], config["dim"]
    reg = synthetic.regression(gen, n, d)
    cls = synthetic.classification(gen, n, d, classes=config["n_classes"])
    return {"linreg": reg, "gaussian_nb": cls, "logreg": cls}


def warm_ranges(config: dict, coverage: float, rng: np.random.Generator) -> list:
    """Models of N(mean, std) rows at uniform positions until their union
    covers ``coverage`` of the table (``warm_to_coverage``'s arithmetic)."""
    from repro_torch.core.descriptors import Range

    n = config["n_points"]
    out, merged = [], []
    while sum(b - a for a, b in merged) < coverage * n:
        size = int(min(max(rng.normal(config["model_size_mean"], config["model_size_std"]),
                           1000), n - 1))
        lo = int(rng.integers(0, n - size))
        out.append(Range(lo, lo + size))
        merged = []
        for a, b in sorted((r.lo, r.hi) for r in out):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
    return out


def stalls(stamps: list, w0: float, seconds: float, cpu_s: float, gc0: list) -> dict:
    """How evenly the window ran, for standard error: queries completed in
    its slowest, median and fastest whole second, the longest gap between
    two answers, the gaps over 5 ms, the process's CPU seconds and the
    collector's passes by generation."""
    ends = np.asarray(stamps) - w0
    per_s = np.bincount(ends.astype(int), minlength=1)[:max(int(seconds), 1)]
    gaps = np.diff(ends, prepend=0.0)
    return {"per_s_min_med_max": [int(per_s.min()), float(np.median(per_s)), int(per_s.max())],
            "gap_max_ms": float(gaps.max() * 1e3), "gaps_over_5ms": int((gaps > 5e-3).sum()),
            "cpu_s": cpu_s,
            "gc": [g["collections"] - a for a, g in zip(gc0, gc.get_stats())]}


def run(*, config: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, judge=None) -> dict:
    """Set up, measure for ``seconds``, check a sample of the answers
    (``judge``, by default :func:`check`); returns the run's record."""
    from repro_torch.core.descriptors import Range
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.data.tabular import ArrayBackend

    device = torch.device(device)
    data = tables(config, seed, device)
    backends = {}
    for fam, (X, y) in data.items():
        key = id(X)
        if key not in backends:
            backends[key] = ArrayBackend(X, y, n_classes=config["n_classes"]
                                         if y.dtype == np.int32 else None, device=device)
    engines = {}
    # the store: the same set of ranges for every seed (drawn from the
    # traffic's ``store_seed``), put in a seed-drawn order
    order = np.random.default_rng([seed, 3])
    store_rng = np.random.default_rng([traffic["store_seed"], 3])
    for fam in config["families"]:
        eng = IncrementalAnalyticsEngine(backends[id(data[fam][0])], materialize="never")
        ranges = warm_ranges(config, traffic["coverage"], store_rng)
        eng.warm(fam, [ranges[i] for i in order.permutation(len(ranges))],
                 **family_params(config, fam))
        engines[fam] = eng
    queries = Queries(config, seed)
    # the window keeps a few numbers a query, and whole answers only for the
    # check's sample: ``check_per_family`` a family, drawn from the seed as
    # the window runs (reservoir sampling), so the harness's own heap stays
    # flat through the window
    keep = traffic["check_per_family"]
    pick = random.Random(seed)
    picked: dict[str, list] = {f: [] for f in config["families"]}
    seen = dict.fromkeys(config["families"], 0)
    stamps: list[float] = []
    query_ms: list[float] = []
    planner_ms: list[float] = []
    rows: list[int] = []
    tally = {"reused": 0}
    state = {"window": False, "span": False}

    def one() -> None:
        fam, lo, hi = queries.next()
        t0 = time.perf_counter()
        with tr.span("bench.query") if state["span"] else contextlib.nullcontext():
            res = engines[fam].query(fam, Range(lo, hi), **family_params(config, fam))
        t1 = time.perf_counter()
        if not state["window"]:
            return
        stamps.append(t1)
        query_ms.append((t1 - t0) * 1e3)
        planner_ms.append(res.plan.optimizer_seconds * 1e3)
        rows.append(res.plan.base_points)
        tally["reused"] += bool(res.used_reuse and res.plan.models_used)
        k = seen[fam]
        seen[fam] = k + 1
        j = k if k < keep else pick.randrange(k + 1)
        if j < keep:
            q = (fam, lo, hi, t0, t1, res)
            if j < len(picked[fam]):
                picked[fam][j] = q
            else:
                picked[fam].append(q)

    # one process, one thread of intra-op work on the host
    torch.set_num_threads(1)
    t_warm = time.perf_counter() + traffic["warmup_s"]
    while time.perf_counter() < t_warm:
        one()
    core.sync(device)
    # set-up's objects leave the collector's generations: a full collection
    # in the window walks only what the window made
    gc.collect()
    gc.freeze()
    cpu0 = time.process_time()
    gc0 = [g["collections"] for g in gc.get_stats()]
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    state["window"] = True
    summary, launches, counts = {}, {}, {}
    if trace:
        t_mid = w0 + seconds - traffic["trace_s"]
        while time.perf_counter() < t_mid:
            one()
        with tr.launch_log() as llog, tr.DeviceTrace(device) as dt:
            state["span"] = True
            t_end = time.perf_counter() + traffic["trace_s"]
            while time.perf_counter() < t_end:
                one()
            state["span"] = False
        summary, launches, counts = dt.summary, llog.resolved(), dt.launches
    else:
        while time.perf_counter() < w0 + seconds:
            one()
    w1 = stamps[-1]
    cpu_s = time.process_time() - cpu0
    gc.unfreeze()
    window = [q for fam in config["families"] for q in picked[fam]]
    rec = {
        "setup_s": setup_s, "window_s": w1 - w0, "summary": summary, "launches": launches,
        "kernel_launches": counts,
        "samples": {"query_ms": query_ms, "planner_ms": planner_ms, "rows_scanned": rows},
        "counts": {"queries": len(stamps), "reused": tally["reused"],
                   # a query that fails raises out of the run
                   "attempted": len(stamps), "failed": 0},
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
        "diag": stalls(stamps, w0, seconds, cpu_s, gc0),
    }
    # the program's state goes before the reference runs
    del engines, backends
    core.free(device)
    t_check = time.perf_counter()
    rec["check"] = (judge or check)(config, data, window, traffic, limits, seed)
    rec["check_s"] = time.perf_counter() - t_check
    return rec




# ---------------------------------------------------------------------------
# correct: each sampled answer against the float64 reference
# ---------------------------------------------------------------------------

def answer_error(config: dict, data: dict, q, *, dtype=ref.F64) -> tuple[float, bool]:
    """(normwise error of the query's model against the reference computed
    in ``dtype``, whether its plan's signed ranges cover the query exactly)."""
    fam, lo, hi, _, _, res = q
    X, y = data[fam]
    steps = [(s.sign, s.rng.lo, s.rng.hi) for s in res.plan.steps]
    exact = ref.covers_exactly(steps, lo, hi)
    if fam == "linreg":
        w = ref.linreg(X[lo:hi], y[lo:hi], lam=config["linreg_lam"], dtype=dtype)
        return ref.normwise(res.model.weights, w), exact
    if fam == "gaussian_nb":
        want = ref.gaussian_nb(X[lo:hi], y[lo:hi], classes=config["n_classes"], dtype=dtype)
        return max(ref.normwise(res.model.mu, want["mu"]),
                   ref.normwise(res.model.var, want["var"])), exact
    # logistic regression: the mixture over the plan's own ranges (all
    # added: the family has no delete), each chunked from its start
    if not exact or any(sign < 0 for sign, _, _ in steps):
        return math.inf, False
    a0 = min(a for _, a, _ in steps)
    b0 = max(b for _, _, b in steps)
    w = ref.logreg_mixture(X[a0:b0], y[a0:b0], a0, [(a, b) for _, a, b in steps],
                           chunk=config["logreg_chunk"], lam=config["logreg_lam"],
                           lr=config["logreg_lr"], dtype=dtype)
    return ref.normwise(res.model.weights, w), exact


def sample(window: list, per_family: int, seed: int) -> list:
    rng = np.random.default_rng([seed, 4])
    out = []
    for fam in sorted({q[0] for q in window}):
        idx = [i for i, q in enumerate(window) if q[0] == fam]
        out += [window[i] for i in sorted(rng.permutation(idx)[:per_family])]
    return out


def check(config, data, window, traffic, limits, seed) -> dict:
    picked = sample(window, traffic["check_per_family"], seed)
    errs: dict[str, float] = {}
    inexact = 0
    for q in picked:
        err, exact = answer_error(config, data, q)
        errs[q[0]] = max(errs.get(q[0], 0.0), err)
        inexact += not exact
    numbers = {f"{fam}_err": {"value": v, "limit": limits[f"{fam}_err"]}
               for fam, v in sorted(errs.items())}
    numbers["plans_not_exact"] = {"value": inexact, "limit": limits["plans_not_exact"]}
    ok = (set(errs) == set(config["families"])
          and all(v["value"] <= v["limit"] for v in numbers.values()))
    return {"correct": bool(ok), "numbers": numbers, "sampled_queries": len(picked)}
