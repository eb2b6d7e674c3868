"""Closed-loop sessions over ``SessionManager``: document QA and chat.

Each of ``clients`` users sends one request, waits for the whole reply and
sends the next at once (no think time).  A request is a prompt, the first
``prefix`` tokens of a document, and ``n_new`` greedy tokens.  With
``documents`` > 0 every request reads one of a catalogue of documents built
into the segment store during set-up, picked by Zipf(``zipf_s``); with
``documents`` = 0 each request brings a document of its own that nobody
shares, so the store never hits.

The sizes of a client's requests are Weyl sequences (the fractional parts of
u₀ + j·α, α irrational) over the traffic's ranges; the clients' u₀ lie
1/clients apart from an offset drawn from the seed.  Any run of consecutive
requests covers each range evenly, so every seed offers the same mix of
work in another order.  Token ids are drawn from
the seed.

The program sees only the generated requests: ``add_session``, ``submit``,
``step`` and ``close_session``.  A request's tokens reach the user when the
``step`` that produced them returns; its time to first token runs from when
it was due (its client's previous reply completed) to that return.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from bench import core
from bench import trace as tr
from bench import work

#: α of the Weyl sequences: prompt length, reply length, document
ALPHA = {"prefix": (math.sqrt(5.0) - 1.0) / 2.0, "new": math.sqrt(2.0) - 1.0,
         "doc": 0.7548776662466927}


# ---------------------------------------------------------------------------
# the model: the configuration's sizes and the benchmark's own weights
# ---------------------------------------------------------------------------

def arch(config: dict) -> dict:
    """The published sizes under short names (Hugging Face keys in the file)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    return {"layers": config["num_hidden_layers"], "d": d, "h": h,
            "kv": config["num_key_value_heads"], "hd": config.get("head_dim", d // h),
            "ff": config["intermediate_size"], "vocab": config["vocab_size"],
            "eps": config["rms_norm_eps"], "theta": config["rope_theta"]}


def arch_config(config: dict):
    """The port's ``ArchConfig`` for the configuration file."""
    from repro_torch.configs.base import ArchConfig

    if config["hidden_act"] != "silu" or config.get("tie_word_embeddings", False):
        raise ValueError("the dense_lm driver runs untied SwiGLU (silu) decoders")
    a = arch(config)
    return ArchConfig(name=config["name"], family="dense", n_layers=a["layers"],
                      d_model=a["d"], n_heads=a["h"], n_kv_heads=a["kv"], head_dim=a["hd"],
                      d_ff=a["ff"], vocab_size=a["vocab"], activation="swiglu",
                      rope_theta=a["theta"], norm_eps=a["eps"],
                      param_dtype="bfloat16", compute_dtype="bfloat16")


def draw_weights(config: dict, seed: int, device) -> dict:
    """Random weights from the seed, drawn on ``device`` in bf16, one call
    per stacked leaf, in the port's parameter layout: matrices N(0, 0.02²),
    the output projections scaled by layers^-½, norms one."""
    a = arch(config)
    L, d, h, kv, hd, ff, V = (a[k] for k in ("layers", "d", "h", "kv", "hd", "ff", "vocab"))
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    std = float(config["assumed"]["init_std"])
    out = std * L ** -0.5

    def normal(shape, s):
        return torch.empty(shape, dtype=torch.bfloat16, device=device).normal_(0.0, s, generator=g)

    def ones(shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    layer = {
        "ln1": ones((L, d)),
        "mixer": {"wq": normal((L, d, h, hd), std), "wk": normal((L, d, kv, hd), std),
                  "wv": normal((L, d, kv, hd), std), "wo": normal((L, h, hd, d), out)},
        "ln2": ones((L, d)),
        "mlp": {"w_up": normal((L, d, ff), std), "w_gate": normal((L, d, ff), std),
                "w_down": normal((L, ff, d), out)},
    }
    return {"embed": normal((V, d), std), "final_norm": ones((d,)),
            "lm_head": normal((d, V), std), "segments": [{"p0": layer}]}


# ---------------------------------------------------------------------------
# the traffic
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    client: int
    doc: int                 # catalogue index, or -1 for a document of its own
    tokens: np.ndarray       # the document the request reads
    prefix: int
    n_new: int
    due: float = 0.0
    prompt: Optional[np.ndarray] = None
    times: list = dataclasses.field(default_factory=list)
    out: list = dataclasses.field(default_factory=list)


def weyl(u0: float, alpha: float, j: int) -> float:
    return (u0 + j * alpha) % 1.0


def in_range(u: float, lo: int, hi: int) -> int:
    """The integer of [lo, hi] at quantile u."""
    return lo + min(int(u * (hi - lo + 1)), hi - lo)


def zipf_pick(u: float, n: int, s: float) -> int:
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    return int(np.searchsorted(np.cumsum(w) / w.sum(), u, side="right").clip(0, n - 1))


class Load:
    """Every client's requests, drawn from the seed."""

    def __init__(self, traffic: dict, vocab: int, seed: int) -> None:
        self.t = traffic
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        n_docs = traffic["documents"]
        self.docs = [self.rng.integers(0, vocab, traffic["doc_tokens"], dtype=np.int32)
                     for _ in range(n_docs)]
        # the clients' sequences start 1/clients apart from a seed-drawn
        # offset, so at every step their values spread evenly over a range
        n = traffic["clients"]
        self.u0 = (self.rng.random(3)[None, :] + np.arange(n)[:, None] / n) % 1.0
        self.count = [0] * traffic["clients"]

    def next(self, c: int) -> Request:
        t, j = self.t, self.count[c]
        self.count[c] += 1
        u = self.u0[c]
        prefix = in_range(weyl(u[0], ALPHA["prefix"], j), *t["prefix"])
        n_new = in_range(weyl(u[1], ALPHA["new"], j), *t["new_tokens"])
        if self.docs:
            doc = zipf_pick(weyl(u[2], ALPHA["doc"], j), len(self.docs), t["zipf_s"])
            tokens = self.docs[doc]
        else:
            doc = -1
            tokens = self.rng.integers(0, self.vocab, prefix, dtype=np.int32)
        return Request(client=c, doc=doc, tokens=tokens, prefix=prefix, n_new=n_new)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

class Loop:
    """The clients over one ``SessionManager``."""

    def __init__(self, mgr, load: Load, clients: int) -> None:
        self.mgr = mgr
        self.load = load
        self.sid: list = [None] * clients
        self.doc: list = [None] * clients
        self.req: list = [None] * clients
        self.free_at: list = [None] * clients
        self.finished: list[Request] = []
        self.steps: list[tuple[float, float]] = []
        self.span = None

    def _span(self, name):
        return tr.span(name) if self.span else contextlib.nullcontext()

    def submit(self, c: int) -> None:
        mgr = self.mgr
        r = self.load.next(c)
        if self.sid[c] is None or r.doc < 0 or self.doc[c] != r.doc:
            if self.sid[c] is not None:
                mgr.close_session(self.sid[c])
            self.sid[c] = mgr.add_session(r.tokens)
            self.doc[c] = r.doc
        s = mgr.sessions[self.sid[c]]
        r.prompt = s.doc[:r.prefix].copy()
        r.due = self.free_at[c] if self.free_at[c] is not None else time.perf_counter()
        mgr.submit(self.sid[c], r.prefix, r.n_new, greedy=True)
        self.req[c] = r

    def tick(self) -> None:
        """Submit for every idle client, run one scheduler step, hand each
        client its new tokens."""
        with self._span("bench.submit"):
            for c, r in enumerate(self.req):
                if r is None:
                    self.submit(c)
        t0 = time.perf_counter()
        with self._span("bench.step"):
            self.mgr.step()
        t = time.perf_counter()
        self.steps.append((t0, t))
        for c, r in enumerate(self.req):
            s = self.mgr.sessions[self.sid[c]]
            for tok in s.out_tokens[len(r.out):]:
                r.out.append(tok)
                r.times.append(t)
            if len(r.out) == r.n_new:
                self.finished.append(r)
                self.req[c] = None
                self.free_at[c] = t

    def run_until(self, t_end: float) -> None:
        while time.perf_counter() < t_end:
            self.tick()


class ModelCalls:
    """The model's entry points as the scheduler calls them, wrapped on the
    instance for a traced window: (kind, rows, tokens, start or pos as a
    device tensor kept by reference)."""

    def __init__(self, model) -> None:
        self.model = model
        self.calls: list = []

    def __enter__(self):
        m, cls = self.model, type(self.model)

        def prefill(params, batch):
            b, n = batch["tokens"].shape
            self.calls.append(("prefill", b, n, None))
            return cls.prefill(m, params, batch)

        def prefill_extend(params, caches, tokens, start):
            b, n = tokens.shape
            self.calls.append(("extend", b, n, torch.as_tensor(start)))
            return cls.prefill_extend(m, params, caches, tokens, start)

        def decode_step(params, caches, tokens, pos):
            self.calls.append(("decode", tokens.shape[0], 1, pos))
            return cls.decode_step(m, params, caches, tokens, pos)

        m.prefill, m.prefill_extend, m.decode_step = prefill, prefill_extend, decode_step
        return self

    def __exit__(self, *exc):
        for name in ("prefill", "prefill_extend", "decode_step"):
            self.model.__dict__.pop(name, None)
        return False

    def flops(self, a: dict) -> float:
        """Model FLOPs of every call (read after a synchronise)."""
        dims = {k: a[k] for k in ("layers", "d", "h", "kv", "hd", "ff", "vocab")}
        total = 0.0
        for kind, b, n, where in self.calls:
            if kind == "prefill":
                total += b * work.lm_span_flops(**dims, start=0, n=n)
            elif kind == "extend":
                start = int(where.reshape(-1)[0])
                total += b * work.lm_span_flops(**dims, start=start, n=n)
            else:
                for p in where.reshape(-1).tolist():
                    total += work.lm_span_flops(**dims, start=int(p), n=1)
        return total


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def build(config: dict, seed: int, device):
    from repro_torch.models.lm import LM

    model = LM(arch_config(config), device=device)
    return model, draw_weights(config, seed, device)


def manager(model, params, config: dict):
    from repro_torch.serve.session import SessionManager

    sv = config["serving"]
    return SessionManager(model, params, chunk_tokens=sv["chunk_tokens"],
                          byte_budget=sv["byte_budget"], decode_bucket=sv["decode_bucket"],
                          max_batch=sv["max_batch"], async_prefill=True,
                          merge_decode_packs=True)


def run(*, config: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, judge=None) -> dict:
    """Set up, measure for ``seconds``, check the served tokens (``judge``,
    by default :func:`check`).  Returns the run's record: ``setup_s``,
    ``window_s``, samples, counts, the traced window's summary and the
    comparison."""
    device = torch.device(device)
    a = arch(config)
    model, params = build(config, seed, device)
    mgr = manager(model, params, config)
    load = Load(traffic, a["vocab"], seed)
    # set-up the traffic needs: each catalogue document into the store
    for doc in load.docs:
        sid = mgr.add_session(doc)
        mgr.submit(sid, len(doc), 1)
        mgr.run()
        mgr.close_session(sid)
    loop = Loop(mgr, load, traffic["clients"])
    # warm-up: the cell's own shapes, until every client is decoding
    t_warm = time.perf_counter() + traffic["warmup_s"]
    while time.perf_counter() < t_warm or any(r is None or not r.out for r in loop.req):
        loop.tick()
    core.sync(device)
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    n_fin0 = len(loop.finished)
    steps0 = len(loop.steps)
    sched0 = dataclasses.replace(mgr.sched)
    agg0 = mgr.aggregate_stats()
    ev0 = mgr.store.evictions
    summary, launches, kernel_launches, model_flops = {}, {}, {}, None
    t_end = w0 + seconds
    if trace:
        loop.run_until(t_end - traffic["trace_s"])
        with tr.launch_log() as llog, ModelCalls(model) as calls, tr.DeviceTrace(device) as dt:
            loop.span = True
            loop.run_until(time.perf_counter() + traffic["trace_s"])
            loop.span = False
        summary, kernel_launches = dt.summary, dt.launches
        launches = llog.resolved()
        model_flops = calls.flops(a)
    else:
        loop.run_until(t_end)
    core.sync(device)
    w1 = loop.steps[-1][1]
    sched, agg = mgr.sched, mgr.aggregate_stats()
    rec = window_record(loop, w0, w1, n_fin0, steps0)
    rec.update(setup_s=setup_s, summary=summary, launches=launches,
               kernel_launches=kernel_launches, model_flops=model_flops, arch=a)
    rec["counts"].update(
        decode_rows=sched.decode_rows - sched0.decode_rows,
        decode_calls=sched.decode_calls - sched0.decode_calls,
        tokens_reused=agg.tokens_reused - agg0.tokens_reused,
        tokens_computed=agg.tokens_computed - agg0.tokens_computed,
        requests=agg.requests - agg0.requests,
        planner_s=agg.planner_s - agg0.planner_s,
        evictions=mgr.store.evictions - ev0, store_bytes=mgr.store.nbytes())
    # every request submitted in the window was attempted; a request that
    # fails raises out of the run, so none is counted failed here
    rec["counts"].update(attempted=rec["counts"]["requests"], failed=0)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    finished = loop.finished[n_fin0:]
    # the program's state goes before the reference runs
    del loop, mgr
    core.free(device)
    t_check = time.perf_counter()
    rec["check"] = (judge or check)(config, params, finished, traffic, limits, seed, device)
    rec["check_s"] = time.perf_counter() - t_check
    return rec


def window_record(loop: Loop, w0: float, w1: float, n_fin0: int, steps0: int) -> dict:
    """Samples and counts of the window [w0, w1] over every request."""
    reqs = loop.finished[n_fin0:] + [r for r in loop.req if r is not None]
    # requests that finished before w0 delivered nothing inside it
    ttft, itl, tokens = [], [], 0
    for r in reqs:
        if r.times and w0 < r.times[0] <= w1:
            ttft.append((r.times[0] - r.due) * 1e3)
        for i, t in enumerate(r.times):
            if w0 < t <= w1:
                tokens += 1
                if i and r.times[i - 1] > w0:
                    itl.append((t - r.times[i - 1]) * 1e3)
    steps = [(b - a) * 1e3 for a, b in loop.steps[steps0:]]
    return {"window_s": w1 - w0,
            "samples": {"ttft_ms": ttft, "itl_ms": itl, "step_ms": steps},
            "counts": {"output_tokens": tokens, "requests_finished": len(loop.finished) - n_fin0}}




# ---------------------------------------------------------------------------
# correct: the served tokens against the plain fp32 reference
# ---------------------------------------------------------------------------

def sample(finished: list[Request], k: int, seed: int) -> list[Request]:
    """``k`` finished requests drawn from the seed, the longest (prompt and
    reply) and the one with the longest reply among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: finished[i].prefix + finished[i].n_new)
    most = max(range(len(finished)), key=lambda i: finished[i].n_new)
    rest = [i for i in range(len(finished)) if i not in (longest, most)]
    rng = np.random.default_rng([seed, 1])
    pick = list(rng.permutation(rest)[:max(k - 2, 0)])
    return [finished[i] for i in sorted({longest, most, *pick})]


def check(config, params, finished, traffic, limits, seed, device) -> dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, over a sample of the window's finished requests."""
    from bench.reference import dense_lm

    picked = sample(finished, traffic["check_requests"], seed)
    if not picked:
        return {"correct": False, "numbers": {}, "why": "no request finished in the window"}
    seqs = [(r.prompt, r.out) for r in picked]
    gaps = dense_lm.served_gaps(params, arch(config), seqs, device=device)
    widest = max(max(g) for g in gaps)
    served = sum(len(r.out) for r in picked)
    lim = limits["logit_gap"]
    return {"correct": bool(widest <= lim),
            "numbers": {"logit_gap": {"value": widest, "limit": lim}},
            "sampled_requests": len(picked), "served_tokens": served}
