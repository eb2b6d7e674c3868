"""Decode packs built in reused buffers, and the counters of how often the
pool and the decode step's CUDA graphs engage, on the CPU.

``SessionManager`` builds every pack in a buffer of its
``serve/packs.py::PackPool``: a dissolved pack hands each session a row of
its own and leaves its buffer to the next pack of its key (batch
signature, rows, capacity).  Held here: the rows share no storage with the
buffer; eight sessions regrouped 8 → 7 → 8 and on, with the B 8 pack built
again in the buffer it left, stream exactly what packs concatenated afresh
(``batch_caches`` of padded rows, the rows views of the pack) stream; the
pool keeps within its byte bound, dropping the least recently used key
first; ``report()``'s shares are the counters' quotients.  The graphs'
recorded kernel reports (``models/graphs.py``) reach a kernel hook again
as the eager step's, nested as they were, with the caller's operands in
place of the graph's static inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.common import WORK, bucket_len  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.models import graphs  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.kv_cache import cache_len, pad_cache_to  # noqa: E402
from repro_torch.serve.packs import PackPool  # noqa: E402
from repro_torch.serve.session import (SessionManager, batch_caches,  # noqa: E402
                                       batch_signature, split_caches)

#: (prefix, new tokens) per request of each of eight sessions: session 0's
#: requests are short, so the pack loses its row and takes it back again
#: and again; the others' capacities keep the pack's at one bucket
REQUESTS = [[(40, 3), (52, 2), (61, 3), (45, 2), (58, 3), (44, 2), (50, 3), (62, 2),
             (47, 3), (55, 2), (60, 3), (42, 2)]] + [
    [(64 + 9 * i, 30), (50 + 5 * i, 14)] for i in range(1, 8)]


def regroup_script(mgr, docs, requests=REQUESTS) -> tuple[list, list]:
    """Each session's requests in turn, a session's next one submitted as
    soon as it drains; returns (every request's tokens, the batch of every
    decode call)."""
    sids = [mgr.add_session(d) for d in docs]
    todo = [list(r) for r in requests]
    out, batches = [], []
    orig = mgr.model.decode_step

    def decode_step(params, caches, tokens, pos):
        batches.append(tokens.shape[0])
        return orig(params, caches, tokens, pos)

    mgr.model.decode_step = decode_step
    try:
        live = {}
        while True:
            for i, sid in enumerate(sids):
                s = mgr.sessions[sid]
                if not s.busy and todo[i]:
                    if i in live:
                        out.append((i, live.pop(i), list(s.out_tokens)))
                    mgr.submit(sid, *todo[i].pop(0))
                    live[i] = len(out)
            if not mgr.step():
                break
        for i, sid in enumerate(sids):
            if i in live:
                out.append((i, live.pop(i), list(mgr.sessions[sid].out_tokens)))
    finally:
        del mgr.model.decode_step
    return sorted(out), batches


class Concatenated(SessionManager):
    """Packs as they were before the pool: ``batch_caches`` of rows padded
    to the pack's capacity, handed back as views of the pack."""

    def _build_pack(self, group):
        sess = [self.sessions[sid] for sid in group]
        target = max(max(s.capacity, cache_len(s.caches)) for s in sess)
        cap = bucket_len(target, self.decode_bucket)
        self._packs[group] = batch_caches([pad_cache_to(s.caches, cap) for s in sess])
        self.sched.pack_rebuilds += 1

    def _flush_packs(self, groups=None):
        for group in list(self._packs) if groups is None else list(groups):
            for sid, row in zip(group, split_caches(self._packs[group], len(group))):
                if sid in self.sessions:
                    self.sessions[sid].caches = row
            del self._packs[group]

    def _dissolve(self, group):
        del self._packs[group]


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("deepseek-67b"))
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, cfg.vocab_size, 160).astype(np.int32) for _ in range(8)]
    return model, params, docs


def _mgr(setup, cls=SessionManager):
    model, params, _ = setup
    return cls(model, params, chunk_tokens=32, decode_bucket=32, max_batch=8,
               async_prefill=False)


def _storage(x):
    return x.untyped_storage().data_ptr()


def test_flushed_rows_own_their_storage(setup):
    mgr = _mgr(setup)
    docs = setup[2]
    sids = [mgr.add_session(d) for d in docs[:3]]
    for sid, n in zip(sids, (40, 70, 100)):
        mgr.submit(sid, n, 4)
    mgr.step()
    mgr.step()
    (group, pack), = mgr._packs.items()
    buf = {_storage(x) for x in tree_leaves(pack)}
    mgr._flush_packs()
    assert mgr._packs == {} and list(mgr.packs._free)
    for i, sid in enumerate(group):
        row = mgr.sessions[sid].caches
        assert cache_len(row) == cache_len(pack)
        for x, p in zip(tree_leaves(row), tree_leaves(pack)):
            assert _storage(x) not in buf
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
            assert torch.equal(x, p[:, i:i + 1])
    # the next pack of that key is built in the same buffer
    mgr.step()
    (_, again), = mgr._packs.items()
    assert {_storage(x) for x in tree_leaves(again)} == buf
    assert mgr.sched.pack_reuses == 1


def test_reused_buffer_streams_as_concatenated_packs(setup):
    pooled = _mgr(setup)
    got, batches = regroup_script(pooled, setup[2])
    want, want_batches = regroup_script(_mgr(setup, Concatenated), setup[2])
    assert got == want
    assert batches == want_batches
    # the B 8 pack lost session 0's row and took it back, more than once
    assert len(batches) >= 40 and sum(b == 8 for b in batches) >= 15
    assert sum(batches[i:i + 3] == [8, 7, 8] for i in range(len(batches) - 2)) >= 5
    sc = pooled.sched
    assert sc.pack_reuses >= 3 and sc.pack_rebuilds > sc.pack_reuses
    assert pooled.packs.nbytes <= pooled.packs.bound


def _cache(t: int, fill: float = 1.0) -> dict:
    return {"segments": [{"p0": {"k": torch.full((2, 1, t, 2, 4), fill),
                                 "v": torch.full((2, 1, t, 2, 4), -fill)}}]}


def _key(rows, cap):
    return (batch_signature(rows[0]), len(rows), cap)


def test_pool_keeps_its_bound_and_drops_least_recent_keys():
    one = 2 * (2 * 1 * 32 * 2 * 4) * 4   # a 1-row pack at capacity 32: k and v, fp32
    pool = PackPool(bound=4 * one)
    rows = [_cache(20)]
    a, b, c = (_key(rows, cap) for cap in (32, 64, 96))
    pack_a, reused_a = pool.take(a, rows, 32)
    pack_b, reused_b = pool.take(b, rows, 64)
    assert not reused_a and not reused_b and pool.nbytes == 3 * one
    pool.give(a, pack_a)
    pool.give(b, pack_b)
    assert list(pool._free) == [a, b] and pool.nbytes == 3 * one
    pack_a, reused = pool.take(a, rows, 32)
    assert reused and pack_a["segments"][0]["p0"]["k"].shape[2] == 32
    pool.give(a, pack_a)
    assert list(pool._free) == [b, a]
    # a new buffer that needs the room drops free ones, the least recently
    # used key first: b, though it was made after a
    pack_c, reused = pool.take(c, rows, 96)
    assert not reused and list(pool._free) == [a] and pool.nbytes == 4 * one
    pool.give(c, pack_c)
    assert list(pool._free) == [a, c] and pool.nbytes == pool.bound
    # packs alive at once past the bound: every free buffer goes first
    two = [_cache(20, 2.0), _cache(30, 3.0)]
    pack, reused = pool.take(_key(two, 96), two, 96)
    assert not reused and list(pool._free) == [] and pool.nbytes == 6 * one
    # the rows sit at the front of their pack rows, the rest as it was
    k = pack["segments"][0]["p0"]["k"]
    assert torch.equal(k[:, 0, :20], torch.full((2, 20, 2, 4), 2.0))
    assert torch.equal(k[:, 1, :30], torch.full((2, 30, 2, 4), 3.0))
    assert not k[:, 0, 20:].any() and not k[:, 1, 30:].any()
    # and once it is back the pool keeps to its bound again
    pool.give(_key(two, 96), pack)
    assert list(pool._free) == [] and pool.nbytes == 0


class _Graphs:
    """Stand-in for ``LM.decode_graphs``: replays every call but the first
    two, and captures on the second."""

    def __init__(self) -> None:
        self.replays = self.captures = self.calls = 0

    def tick(self) -> None:
        self.calls += 1
        if self.calls == 2:
            self.captures += 1
        elif self.calls > 2:
            self.replays += 1


def test_report_shares_are_the_counters_quotients(setup):
    model, params, docs = setup
    mgr = _mgr(setup)
    model.decode_graphs, real = _Graphs(), model.decode_graphs
    orig = model.decode_step

    def decode_step(*args):
        model.decode_graphs.tick()
        return orig(*args)

    model.decode_step = decode_step
    try:
        sids = [mgr.add_session(d) for d in docs[:3]]
        for sid, (n, k) in zip(sids, ((40, 3), (70, 6), (100, 5))):
            mgr.submit(sid, n, k)
        mgr.run()
    finally:
        del model.decode_step
        model.decode_graphs = real
    sc, rep = mgr.sched, mgr.report()
    assert sc.decode_calls == 5 and sc.decode_captures == 1 and sc.decode_replays == 3
    assert rep["decode_graph_replays"] == 3 and rep["decode_graph_captures"] == 1
    assert rep["decode_graph_hit_share"] == 3 / 5
    # B 3, B 2, the same two rows in sid order once both hold the B 3 pack's
    # capacity (the buffer the first B 2 left), B 1
    assert (sc.pack_rebuilds, sc.pack_reuses) == (4, 1)
    assert rep["pack_reuses"] == 1 and rep["pack_reuse_share"] == 1 / 4
    # a 1-row pack at the capacity of the one that dissolved last (128)
    assert list(mgr.packs._free)[-1][1:] == (1, 128)
    mgr.submit(sids[0], 110, 3)
    mgr.run()
    assert (sc.pack_rebuilds, sc.pack_reuses) == (5, 2)
    assert mgr.report()["pack_reuse_share"] == 2 / 5
    # the CPU runs every step eagerly
    assert model.decode_graphs.replays == model.decode_graphs.captures == 0


class _Log:
    """A kernel hook that records each outermost report, as the harness's
    ``LaunchLog`` does."""

    def __init__(self) -> None:
        self.seen = []
        self._depth = 0

    def kernel(self, name, work, fn, *args, **kwargs):
        if not self._depth:
            self.seen.append((name, work, args, kwargs))
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1


class _Nested:
    """A hook for a wrapper that reports inside another's report."""

    def kernel(self, name, work, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def test_recorded_reports_reach_the_hook_as_the_eager_step_does():
    q = torch.randn(2, 1, 4, 16)
    k = torch.randn(2, 64, 2, 16)
    v = torch.randn(2, 64, 2, 16)
    static = torch.tensor([5, 40], dtype=torch.int32)
    caller = torch.tensor([6, 41], dtype=torch.int32)

    def step(pos):
        out = decode_ops.decode_attention(q, k, v, pos=pos)
        # a report inside another report, as a wrapper that calls a wrapper
        WORK.counter.kernel("outer", None, lambda x: decode_ops.decode_attention(
            q, k, v, pos=x), pos + 0)
        return out

    rec = graphs._Recorder()
    WORK.counter = rec
    try:
        step(static)
    finally:
        WORK.counter = None
    kept = graphs._kept(rec.calls, {id(static): static})
    assert [c[0] for c in kept] == ["decode_attention", "outer"]
    assert [c[0] for c in kept[1][4]] == ["decode_attention"]
    (_, work, args, kwargs, _), outer = kept[0], kept[1]
    assert work is decode_ops.decode_work
    assert all(a.device.type == "meta" and a.shape == b.shape for a, b in zip(args, (q, k, v)))
    assert kwargs["pos"] is static
    assert outer[2][0].device.type == "cpu"      # a small integer operand keeps its own
    eager, replay = _Log(), _Log()
    WORK.counter = eager
    try:
        step(caller)
    finally:
        WORK.counter = None
    graphs._report(replay, kept, {id(static): caller})
    assert [s[0] for s in replay.seen] == [s[0] for s in eager.seen] == [
        "decode_attention", "outer"]
    assert replay.seen[0][3]["pos"] is caller
    assert [tuple(a.shape) for a in replay.seen[0][2]] == [
        tuple(a.shape) for a in eager.seen[0][2]]
    # the nested report is passed on inside the outer one
    inner = graphs._Recorder()
    graphs._report(inner, kept, {id(static): caller})
    assert [c[0] for c in inner.calls] == ["decode_attention", "outer"]
    assert [c[0] for c in inner.calls[1][4]] == ["decode_attention"]
    assert inner.calls[1][4][0][3]["pos"] is kept[1][4][0][3]["pos"]
    graphs._report(_Nested(), kept, {})
