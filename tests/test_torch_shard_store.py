"""The port's sharded segment store: ``repro_torch.serve.shard_store``.

The contracts of ``tests/test_shard_store.py`` held inside the port (ring
placement, fetch pricing, the wire codec, routing, coalescing, hedging and
failure, persistence, reporting), then against ``repro`` on the same seeds:
the ring places 2000 keys as ``repro``'s does; a segment encoded by either
package decodes in the other, int8 codes and scales bitwise ``repro``'s and
the fp32 wire lossless; a twin replay of one script (put, index,
``prefetch_batch``, get, pin, unpin, alias, a cross-shard ``rekey``,
release, a straggler, a failed shard) leaves both packages' stores with
equal indexes, segment ids and ``shard_report()``; a sharded snapshot
saved by one package loads in the other.  Last, device resolution: a
store made with ``device=None`` whose first put is remote-homed decodes
its fetches onto the put's device.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.cost import serve_cost_model as jax_serve_cost_model  # noqa: E402
from repro.core.descriptors import Range as JaxRange  # noqa: E402
from repro.serve import shard_store as jax_shard  # noqa: E402
from repro.serve.kv_cache import SegmentStore as JaxStore  # noqa: E402
from repro_torch.core.cost import CostModel, serve_cost_model  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.quant import dequantize_tree  # noqa: E402
from repro_torch.distributed.transport import ShardTransport  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore  # noqa: E402
from repro_torch.serve.shard_store import (  # noqa: E402
    HashRing,
    ShardedSegmentStore,
    decode_segment,
    encode_segment,
    resolve_wire_precision,
)


def _seg(tokens, fill=1.0, width=4):
    return {"k": torch.full((1, 1, tokens, 2, width), fill, dtype=torch.float32)}


def _rand_np(rng, tokens, width=4):
    return rng.standard_normal((1, 1, tokens, 2, width)).astype(np.float32)


def _rand_seg(rng, tokens, width=4):
    return {"k": torch.from_numpy(_rand_np(rng, tokens, width))}


def _sharded(n=2, **kw):
    kw.setdefault("cost_model", serve_cost_model())
    kw.setdefault("seq_bucket", 8)
    # low RTT so bucket-sized test segments price as fetch-worthy
    kw.setdefault("rtt_s", 1e-7)
    kw.setdefault("device", "cpu")
    return ShardedSegmentStore(n, **kw)


def _doc_on(st, shard, *, skip=0):
    """A doc id the ring homes on ``shard`` (deterministic scan)."""
    found = 0
    for i in range(10_000):
        d = f"doc-{i}"
        if st.shard_of(d) == shard:
            if found == skip:
                return d
            found += 1
    raise AssertionError(f"no doc id found for shard {shard}")


# ---------------------------------------------------------------------------
# hash ring
# ---------------------------------------------------------------------------

class TestHashRing:
    def test_deterministic_across_instances(self):
        a, b = HashRing(4), HashRing(4)
        keys = [f"k{i}" for i in range(200)]
        assert [a.place(k) for k in keys] == [b.place(k) for k in keys]

    def test_distribution_roughly_uniform(self):
        ring = HashRing(4)
        counts = [0] * 4
        for i in range(2000):
            counts[ring.place(f"key-{i}")] += 1
        assert min(counts) > 2000 // 4 * 0.5, counts
        assert max(counts) < 2000 // 4 * 1.6, counts

    def test_single_shard_takes_everything(self):
        ring = HashRing(1)
        assert {ring.place(f"k{i}") for i in range(50)} == {0}

    def test_growth_moves_minority_of_keys(self):
        r4, r5 = HashRing(4), HashRing(5)
        keys = [f"k{i}" for i in range(2000)]
        assert sum(r4.place(k) != r5.place(k) for k in keys) < 2000 * 0.4

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
    def test_placement_matches_reference(self, n):
        ours, theirs = HashRing(n), jax_shard.HashRing(n)
        keys = [f"key-{i}" for i in range(2000)]
        assert [ours.place(k) for k in keys] == [theirs.place(k) for k in keys]


# ---------------------------------------------------------------------------
# cost model: fetch pricing
# ---------------------------------------------------------------------------

class TestFetchPricing:
    def test_fetch_s_is_rtt_plus_wire(self):
        cm = CostModel()
        assert cm.fetch_s(2_000_000) == pytest.approx(
            cm.wire_rtt_s + 2_000_000 / cm.wire_bytes_per_s)
        assert cm.fetch_s(0, rtt=0.5, bw=1.0) == pytest.approx(0.5)

    def test_fetch_action_prefers_wire_for_big_rebuilds(self):
        cm = serve_cost_model()
        assert cm.fetch_action(512, 4_000_000) == "fetch"
        assert cm.fetch_action(8, 256) == "rebuild"
        assert cm.fetch_action(512, 4_000_000, bw=1e4) == "rebuild"


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

class TestWireCodec:
    def test_fp32_resident_quantizes_to_int8_within_scale(self):
        st = SegmentStore(seq_bucket=8, precision="fp32")
        caches = _rand_seg(np.random.default_rng(3), 8)
        sid = st.put(Range(0, 8), caches, doc_id="d")
        out = decode_segment(encode_segment(st, st.get(sid)), device="cpu")
        assert out.precision == "int8" and out.quant is not None
        assert out.seg_id == sid and out.doc_id == "d"
        assert (out.rng.lo, out.rng.hi, out.valid) == (0, 8, 8)
        deq = dequantize_tree(out.caches, out.quant)
        scale = max(float(s.max()) for s in out.quant.scales.values())
        err = float((deq["k"] - st.get(sid).caches["k"]).abs().max())
        assert err <= scale / 2 + 1e-6

    def test_fp32_wire_precision_is_lossless(self):
        st = SegmentStore(seq_bucket=8, precision="fp32")
        sid = st.put(Range(0, 8), _rand_seg(np.random.default_rng(4), 8), doc_id="d")
        out = decode_segment(encode_segment(st, st.get(sid), precision="fp32"),
                             device="cpu")
        assert out.precision == "fp32" and out.quant is None
        assert torch.equal(out.caches["k"], st.get(sid).caches["k"])

    def test_int8_resident_ships_exactly(self):
        st = SegmentStore(seq_bucket=8, precision="int8")
        sid = st.put(Range(0, 8), _rand_seg(np.random.default_rng(5), 8), doc_id="d")
        seg = st.get(sid)
        out = decode_segment(encode_segment(st, seg), device="cpu")
        assert out.precision == "int8"
        assert torch.equal(out.caches["k"], seg.caches["k"])
        for k, s in seg.quant.scales.items():
            assert torch.equal(out.quant.scales[k], s)

    def test_partial_bucket_valid_tail_survives(self):
        st = SegmentStore(seq_bucket=8, precision="fp32")
        sid = st.put(Range(0, 5), _seg(5, 2.0), doc_id="d")   # pads to 8
        out = decode_segment(encode_segment(st, st.get(sid)), device="cpu")
        assert out.valid == 5 and out.capacity == 8 and out.rng.hi == 5

    def test_bf16_resident_ships_as_stored(self):
        st = SegmentStore(seq_bucket=8, precision="fp32")
        x = _rand_seg(np.random.default_rng(6), 8)["k"].to(torch.bfloat16)
        sid = st.put(Range(0, 8), {"k": x}, doc_id="d")
        out = decode_segment(encode_segment(st, st.get(sid), precision="fp32"),
                             device="cpu")
        assert out.caches["k"].dtype == torch.bfloat16
        assert torch.equal(out.caches["k"], x)

    def test_resolve_wire_precision(self, monkeypatch):
        """The wire precision is the argument's, ``"int8"`` by default;
        ``REPRO_WIRE_PRECISION`` is not read."""
        monkeypatch.setenv("REPRO_WIRE_PRECISION", "fp32")
        assert resolve_wire_precision() == "int8"
        assert resolve_wire_precision("fp32") == "fp32"
        with pytest.raises(ValueError, match="wire precision"):
            resolve_wire_precision("fp16")

    @pytest.mark.parametrize("precision", ["int8", "fp32"])
    @pytest.mark.parametrize("sender", ["port", "repro"])
    def test_wire_crosses_packages(self, sender, precision):
        """A segment encoded by either package decodes in the other: int8
        codes and scales bitwise ``repro``'s own encoding, the fp32 wire
        the stored values exactly, the partial bucket's record intact."""
        x = _rand_np(np.random.default_rng(7), 5)
        ours = SegmentStore(seq_bucket=8, precision="fp32")
        theirs = JaxStore(seq_bucket=8, precision="fp32")
        sid = ours.put(Range(0, 5), {"k": torch.from_numpy(x)}, doc_id="d", seg_id="s")
        theirs.put(JaxRange(0, 5), {"k": jnp.asarray(x)}, doc_id="d", seg_id="s")
        ref = jax_shard.decode_segment(jax_shard.encode_segment(
            theirs, theirs.get(sid), precision=precision))
        if sender == "port":
            data = encode_segment(ours, ours.get(sid), precision=precision)
            got = jax_shard.decode_segment(data)
            codes = np.asarray(got.caches["k"])
            scales = {k: np.asarray(v) for k, v in (got.quant.scales.items()
                                                    if got.quant else ())}
        else:
            data = jax_shard.encode_segment(theirs, theirs.get(sid), precision=precision)
            got = decode_segment(data, device="cpu")
            codes = got.caches["k"].numpy()
            scales = {k: v.numpy() for k, v in (got.quant.scales.items()
                                               if got.quant else ())}
        assert (got.seg_id, got.doc_id, got.rng.lo, got.rng.hi, got.valid,
                got.capacity, got.precision) == \
            (ref.seg_id, ref.doc_id, ref.rng.lo, ref.rng.hi, ref.valid,
             ref.capacity, ref.precision)
        np.testing.assert_array_equal(codes, np.asarray(ref.caches["k"]))
        if precision == "int8":
            assert codes.dtype == np.int8 and sorted(scales) == sorted(ref.quant.scales)
            for k, v in scales.items():
                np.testing.assert_array_equal(v, np.asarray(ref.quant.scales[k]))
        else:
            np.testing.assert_array_equal(codes[:, :, :5], x)


# ---------------------------------------------------------------------------
# facade routing
# ---------------------------------------------------------------------------

class TestRouting:
    def test_put_routes_to_home_shard(self):
        st = _sharded(2)
        local, remote = _doc_on(st, 0), _doc_on(st, 1)
        s0 = st.put(Range(0, 8), _seg(8), doc_id=local)
        s1 = st.put(Range(0, 8), _seg(8, 2.0), doc_id=remote)
        assert s0 in st._segs and s1 not in st._segs
        assert s1 in st.remotes[0]._segs
        assert s0 in st and s1 in st
        assert st.put_forwards == 1 and st.put_forward_bytes > 0
        assert st.total_segments() == 2
        assert sorted(st.doc_ids()) == sorted([local, remote])

    def test_single_shard_facade_is_plain_store(self):
        st = _sharded(1)
        sid = st.put(Range(0, 8), _seg(8), doc_id="anything")
        assert sid in st._segs and st.put_forwards == 0
        assert st.transport.transfers == 0
        assert len(list(st.index("anything").items())) == 1

    def test_remote_get_is_an_on_demand_fetch(self):
        st = _sharded(2)
        sid = st.put(Range(0, 8), _seg(8, 3.0), doc_id=_doc_on(st, 1))
        seg = st.get(sid)
        assert st.on_demand_fetches == 1 and st.fetched_hits == 1
        assert st.transport.transfers == 1 and seg.fetched
        st.get(sid)
        assert st.transport.transfers == 1 and st.fetched_hits == 2

    def test_remote_index_filters_through_fetch_pricing(self):
        st = _sharded(2)
        remote = _doc_on(st, 1)
        st.put(Range(0, 8), _seg(8), doc_id=remote)
        assert len(list(st.index(remote).items())) == 1
        assert st.segment_bytes(remote)
        nofetch = _sharded(2, fetch=False)
        nofetch.put(Range(0, 8), _seg(8), doc_id=remote)
        assert list(nofetch.index(remote).items()) == []
        assert nofetch.segment_bytes(remote) == {}

    def test_cross_shard_alias_is_skipped(self):
        st = _sharded(4)
        src = _doc_on(st, 1)
        dst = next(d for d in (f"doc-{i}" for i in range(10_000))
                   if st.shard_of(d) != 1)
        st.put(Range(0, 8), _seg(8), doc_id=src)
        assert st.alias(src, dst) == 0
        assert st.cross_shard_alias_skips == 1

    def test_same_home_alias_and_release_route(self):
        st = _sharded(2)
        src, dst = _doc_on(st, 1), _doc_on(st, 1, skip=1)
        st.put(Range(0, 8), _seg(8), doc_id=src)
        assert st.alias(src, dst) == 1
        assert len(list(st.remotes[0].index(dst).items())) == 1
        assert st.release_doc(dst) == 0
        assert st.release_doc(src) == 1
        assert st.total_segments() == 0

    def test_cross_shard_rekey_migrates_segments(self):
        st = _sharded(2)
        old, new = _doc_on(st, 1), _doc_on(st, 0)
        a = st.put(Range(0, 8), _seg(8, 1.0), doc_id=old)
        b = st.put(Range(8, 16), _seg(8, 2.0), doc_id=old)
        c = st.put(Range(16, 24), _seg(8, 3.0), doc_id=old)
        assert st.rekey(old, new, upto=16) == 2
        assert a in st._segs and b in st._segs
        assert c in st.remotes[0]._segs
        assert st._segs[a].doc_id == new
        assert {s for s, _ in st.index(new).items()} == {a, b}
        assert st.cross_shard_rekeys == 1 and st.migrated_segments == 2

    def test_pin_guards_remote_resident_and_unpin_drops_fetch(self):
        st = _sharded(2)
        sid = st.put(Range(0, 8), _seg(8), doc_id=_doc_on(st, 1))
        tok = st.pin([sid])
        assert sid in st.remotes[0]._pins
        st.get(sid)
        assert sid in st._fetched
        st.unpin(tok)
        assert sid not in st.remotes[0]._pins
        assert sid not in st._fetched


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

class TestCoalescing:
    def test_one_doc_many_segments_one_transfer(self):
        st = _sharded(2)
        remote = _doc_on(st, 1)
        for j in range(3):
            st.put(Range(j * 8, (j + 1) * 8), _seg(8, float(j)), doc_id=remote)
        assert st.prefetch(remote, upto=24) == 3 and st.remote_fetches == 3
        assert st.transport.transfers == 1 and st.transport.items_sent == 3
        assert st.transport.coalesce_violations == 0

    def test_many_docs_one_transfer_per_shard(self):
        st = _sharded(4)
        docs = [_doc_on(st, s, skip=k) for s in (1, 2, 3) for k in (0, 1)]
        for d in docs:
            st.put(Range(0, 8), _seg(8), doc_id=d)
        st.prefetch_batch([(d, 8) for d in docs])
        assert st.transport.transfers == 3 and st.remote_fetches == 6
        rep = st.transport.report()
        assert rep["coalesce_violations"] == 0
        assert rep["max_transfers_per_shard_tick"] == 1

    def test_transport_counts_contract_violations(self):
        tr = ShardTransport(2)
        tr.begin_tick()
        tr.transfer(1, 100)
        tr.transfer(1, 100)
        tr.begin_tick()
        assert tr.coalesce_violations == 1
        assert tr.max_transfers_per_shard_tick == 2

    def test_fetch_cache_cap_evicts_unpinned(self):
        st = _sharded(2, fetch_cache_bytes=1)
        remote = _doc_on(st, 1)
        for j in range(4):
            st.put(Range(j * 8, (j + 1) * 8), _seg(8), doc_id=remote)
        st.prefetch(remote, upto=32)
        assert st.remote_fetches == 4 and len(st._fetched) == 1


# ---------------------------------------------------------------------------
# hedging and failure
# ---------------------------------------------------------------------------

class TestHedging:
    def test_observed_straggler_triggers_hedge_rebuild_win(self):
        st = _sharded(2, hedge_deadline_s=0.05)
        remote = _doc_on(st, 1)
        for j in range(2):
            st.put(Range(j * 8, (j + 1) * 8), _seg(8), doc_id=remote)
        st.transport.slowdown[1] = 1e7
        st.prefetch(remote, upto=16)
        assert st.transport.transfers == 1 and st.hedged_fetches == 0
        st._fetched.clear()
        st._fetched_bytes = 0
        st.prefetch(remote, upto=16)
        assert st.hedged_fetches == 1 and st.hedge_rebuild_wins == 1
        assert st.cancelled_fetches == 2 and st.transport.transfers == 1
        assert list(st.index(remote).items()) == []

    def test_estimate_prefers_observed_rate(self):
        tr = ShardTransport(2, bw_bytes_per_s=1e9, rtt_s=1e-3)
        nominal = tr.estimate_fetch_s(1, 1_000_000)
        assert nominal == pytest.approx(2e-3)
        tr.slowdown[1] = 100.0
        tr.begin_tick()
        tr.transfer(1, 1_000_000)
        assert tr.estimate_fetch_s(1, 1_000_000) > 10 * nominal

    def test_dead_shard_skips_fetch(self):
        st = _sharded(2)
        remote = _doc_on(st, 1)
        st.put(Range(0, 8), _seg(8), doc_id=remote)
        st.transport.fail(1)
        st.transport.advance(31.0)
        assert list(st.index(remote).items()) == []
        assert st.dead_shard_skips == 1
        st.transport.heal(1)
        st._views.clear()
        assert len(list(st.index(remote).items())) == 1

    def test_failed_shard_transfer_raises(self):
        tr = ShardTransport(2)
        tr.fail(1)
        with pytest.raises(RuntimeError, match="down"):
            tr.transfer(1, 100)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

class TestPersistence:
    def test_save_load_roundtrip_preserves_placement(self, tmp_path):
        st = _sharded(2)
        local, remote = _doc_on(st, 0), _doc_on(st, 1)
        s0 = st.put(Range(0, 8), _seg(8, 1.0), doc_id=local)
        s1 = st.put(Range(0, 8), _seg(8, 2.0), doc_id=remote)
        st.save(tmp_path / "snap")
        assert (tmp_path / "snap" / "shard-00").is_dir()
        assert (tmp_path / "snap" / "shard-01").is_dir()
        re = ShardedSegmentStore.load(tmp_path / "snap", cost_model=serve_cost_model(),
                                      device="cpu")
        assert re.n_shards == 2 and re.total_segments() == 2
        assert s0 in re._segs and s1 in re.remotes[0]._segs
        assert torch.equal(re._segs[s0].caches["k"], _seg(8, 1.0)["k"])
        assert re.device == torch.device("cpu")
        assert all(r.device == torch.device("cpu") for r in re.remotes)

    def test_load_rejects_shard_count_mismatch(self, tmp_path):
        st = _sharded(2)
        st.put(Range(0, 8), _seg(8), doc_id=_doc_on(st, 0))
        st.save(tmp_path / "snap")
        with pytest.raises(IOError, match="shards"):
            ShardedSegmentStore.load(tmp_path / "snap", n_shards=4, device="cpu")

    @pytest.mark.parametrize("saver", ["port", "repro"])
    def test_snapshot_crosses_packages(self, tmp_path, saver):
        """A sharded snapshot saved by either package loads in the other:
        the same segments on the same shards, payloads bitwise."""
        rng = np.random.default_rng(8)
        ours = _sharded(2)
        theirs = jax_shard.ShardedSegmentStore(
            2, cost_model=jax_serve_cost_model(), seq_bucket=8, rtt_s=1e-7)
        payloads = {}
        for i in range(6):
            doc = f"doc-{i}"
            x = _rand_np(rng, 8)
            sid = ours.put(Range(0, 8), {"k": torch.from_numpy(x)}, doc_id=doc)
            assert theirs.put(JaxRange(0, 8), {"k": jnp.asarray(x)}, doc_id=doc) == sid
            payloads[sid] = x
        if saver == "port":
            ours.save(tmp_path / "snap")
            back = jax_shard.ShardedSegmentStore.load(
                tmp_path / "snap", cost_model=jax_serve_cost_model())
            get = lambda st, sid: np.asarray(st._segs[sid].caches["k"])  # noqa: E731
        else:
            theirs.save(tmp_path / "snap")
            back = ShardedSegmentStore.load(tmp_path / "snap",
                                            cost_model=serve_cost_model(), device="cpu")
            get = lambda st, sid: st._segs[sid].caches["k"].numpy()  # noqa: E731
        src = ours if saver == "port" else theirs
        for st_src, st_back in zip(src._shards(), back._shards()):
            assert sorted(st_back._segs) == sorted(st_src._segs)
            for sid in st_back._segs:
                np.testing.assert_array_equal(get(st_back, sid), payloads[sid])


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

class TestReporting:
    def test_shard_report_finite_on_idle_store(self):
        rep = _sharded(3).shard_report()
        assert rep["shards"] == 3
        for k, v in rep.items():
            assert isinstance(v, (int, float)) and math.isfinite(v), (k, v)
        for i in range(3):
            assert rep[f"shard{i}_segments"] == 0

    def test_shard_summaries_track_occupancy(self):
        st = _sharded(2)
        st.put(Range(0, 8), _seg(8), doc_id=_doc_on(st, 1))
        by_shard = {s["shard"]: s for s in st.shard_summaries()}
        assert by_shard[0]["segments"] == 0
        assert by_shard[1]["segments"] == 1 and by_shard[1]["device_bytes"] > 0


# ---------------------------------------------------------------------------
# the twin replay: both packages' stores through one script
# ---------------------------------------------------------------------------

def _twin_script(st, put, rng_of, n_shards=3):
    """One script over a sharded store of either package; returns the
    observations to compare (indexes as they stand, per shard)."""
    seen = []

    def doc_on(shard, skip=0):
        return _doc_on(st, shard, skip=skip)

    docs = {name: doc_on(s, k) for name, (s, k) in {
        "l0": (0, 0), "l1": (0, 1), "r1": (1, 0), "r1b": (1, 1),
        "r2": (2, 0), "r2b": (2, 1)}.items()}
    rng = np.random.default_rng(11)
    for name, doc in docs.items():
        for j in range(3):
            put(st, rng_of(rng), j * 8, (j + 1) * 8, doc)

    def indexes():
        out = {}
        for name, doc in docs.items():
            out[name] = sorted((sid, r.lo, r.hi) for sid, r in st.index(doc).items())
        return out

    seen.append(("index", indexes()))
    st.prefetch_batch([(docs[n], 24) for n in ("r1", "r2", "l0", "r1b")])
    seen.append(("fetched", sorted(st._fetched)))
    got = [sid for sid, _ in st.index(docs["r2"]).items()]
    tok = st.pin(got)
    for sid in got:
        st.get(sid)
    st.unpin(tok)
    seen.append(("fetched after unpin", sorted(st._fetched)))
    seen.append(("alias same home", st.alias(docs["r1"], docs["r1b"], upto=16)))
    seen.append(("alias cross", st.alias(docs["r1"], docs["l0"])))
    # an edit whose new content key hashes to another shard
    seen.append(("rekey cross", st.rekey(docs["r2"], docs["l1"], upto=16)))
    seen.append(("release", st.release_doc(docs["r2"])))
    seen.append(("index after rekey", indexes()))
    # a straggler: the first fetch observes it, the next hedges
    st.transport.slowdown[1] = 1e7
    for _ in range(2):
        st._fetched.clear()
        st._fetched_bytes = 0
        st.prefetch_batch([(docs["r1"], 24), (docs["r1b"], 24)])
    seen.append(("index under straggler", indexes()))
    st.transport.slowdown[1] = 1.0
    # shard 2 fails and its heartbeat goes stale
    st.transport.fail(2)
    st.transport.advance(31.0)
    st.prefetch_batch([(docs["r2b"], 24)])
    seen.append(("index with a dead shard", indexes()))
    seen.append(("segments", [sorted(s._segs) for s in st._shards()]))
    seen.append(("report", st.shard_report()))
    return seen


def _put_port(st, x, lo, hi, doc):
    st.put(Range(lo, hi), {"k": torch.from_numpy(x)}, doc_id=doc)


def _put_repro(st, x, lo, hi, doc):
    st.put(JaxRange(lo, hi), {"k": jnp.asarray(x)}, doc_id=doc)


@pytest.mark.parametrize("wire", ["int8", "fp32"])
def test_twin_replay_matches_reference(wire):
    kw = dict(seq_bucket=8, rtt_s=1e-7, hedge_deadline_s=0.05, wire_precision=wire)
    ours = ShardedSegmentStore(3, cost_model=serve_cost_model(), device="cpu", **kw)
    theirs = jax_shard.ShardedSegmentStore(3, cost_model=jax_serve_cost_model(), **kw)
    rng_of = lambda rng: _rand_np(rng, 8)  # noqa: E731
    a = _twin_script(ours, _put_port, rng_of)
    b = _twin_script(theirs, _put_repro, rng_of)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        assert x == y, key
    rep = dict(a)["report"]
    assert rep["remote_fetches"] > 0 and rep["hedged_fetches"] > 0
    assert rep["hedge_rebuild_wins"] > 0 and rep["dead_shard_skips"] > 0
    assert rep["cross_shard_rekeys"] == 1 and rep["cross_shard_alias_skips"] == 1


# ---------------------------------------------------------------------------
# device resolution
# ---------------------------------------------------------------------------

def test_unset_device_comes_from_a_remote_first_put():
    """``device=None`` and the first put homed on a remote shard: the facade
    takes that put's device, and a fetch decodes onto it — never onto a
    default of its own."""
    st = ShardedSegmentStore(2, cost_model=serve_cost_model(), seq_bucket=8,
                             rtt_s=1e-7)
    assert st.device is None
    sid = st.put(Range(0, 8), _seg(8, 2.0), doc_id=_doc_on(st, 1))
    assert st.device == torch.device("cpu")
    assert all(s.device == torch.device("cpu") for s in st._shards())
    seg = st.get(sid)
    assert seg.fetched and st.on_demand_fetches == 1
    assert {x.device.type for x in seg.caches.values()} == {"cpu"}
    assert {s.device.type for s in seg.quant.scales.values()} == {"cpu"}
    deq = dequantize_tree(seg.caches, seg.quant)
    assert float((deq["k"] - 2.0).abs().max()) <= 2.0 / 127 / 2 + 1e-6


def test_fetch_without_a_device_raises():
    """A fetch batch on a store that never resolved a device is refused
    (nothing was put, so nothing could be fetched)."""
    st = ShardedSegmentStore(2, cost_model=serve_cost_model(), seq_bucket=8)
    with pytest.raises(RuntimeError, match="no device"):
        st._fetch_batch({1: ["missing"]})
