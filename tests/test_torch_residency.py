"""Segment residency in the port against ``repro``: tiers and precision.

The same put/get/prefetch sequences run through ``repro``'s
``SegmentStore`` and the port's, on the same numpy payloads (the
scenarios of ``tests/test_tiered_store.py`` and
``tests/test_quant_store.py``).  Required after every step: equal counters
(quantized, demotions, promotions, evictions, spill writes, prefetches and
the bytes each moved), equal per-tier bytes, the same segments on the same
tiers at the same precision, and bitwise-equal payloads and scales.  Inside
the port every tier round trip is bitwise: a promoted fp32 segment equals
what was put, a promoted int8 segment equals ``quantize_leaf`` of it.
"""
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.descriptors import Range as JRange  # noqa: E402
from repro.serve.kv_cache import SegmentStore as JaxStore  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.quant import dequantize_tree, quantize_leaf  # noqa: E402
from repro_torch.serve.kv_cache import SegmentStore, cache_nbytes  # noqa: E402

W = 4


def _data(i: int, tokens: int = 8) -> np.ndarray:
    rng = np.random.default_rng(100 + i)
    return (rng.standard_normal((1, 1, tokens, 2, W)) * (i + 1)).astype(np.float32)


NB8 = _data(0).nbytes

COUNTERS = ("quantized", "quant_bytes_saved", "demotions", "promotions",
            "demoted_bytes", "promoted_bytes", "evictions", "evicted_bytes",
            "prefetches", "spill_writes")


class Twin:
    """One store of each package, driven in lockstep."""

    def __init__(self, tmp_path=None, **kw):
        kw.setdefault("seq_bucket", 8)
        jkw, tkw = dict(kw), dict(kw)
        if tmp_path is not None:
            jkw["spill_dir"], tkw["spill_dir"] = tmp_path / "jspill", tmp_path / "tspill"
        self.j = JaxStore(**jkw)
        self.t = SegmentStore(device="cpu", **tkw)
        self.data: dict[str, np.ndarray] = {}

    def put(self, i: int, doc: str = "a") -> str:
        x = _data(i)
        js = self.j.put(JRange(8 * i, 8 * i + 8), {"k": jnp.asarray(x)}, doc_id=doc)
        ts = self.t.put(Range(8 * i, 8 * i + 8), {"k": torch.from_numpy(x)}, doc_id=doc)
        assert js == ts
        self.data[ts] = x
        self.check()
        return ts

    def get(self, sid: str):
        self.j.get(sid)
        seg = self.t.get(sid)
        self.check()
        return seg

    def prefetch(self, doc: str, **kw) -> int:
        n = self.t.prefetch(doc, **kw)
        assert self.j.prefetch(doc, **kw) == n
        self.check()
        return n

    def flush(self):
        self.j.flush_saves()
        self.t.flush_saves()
        self.check()

    def check(self):
        for name in COUNTERS:
            assert getattr(self.t, name) == getattr(self.j, name), name
        assert self.t.tier_bytes() == self.j.tier_bytes()
        assert self.t.quantized_segments() == self.j.quantized_segments()
        assert self.t.nbytes() == self.j.nbytes()
        assert list(self.t._segs) == list(self.j._segs)
        for sid, tseg in self.t._segs.items():
            jseg = self.j._segs[sid]
            assert (tseg.tier, tseg.precision, tseg.nbytes, tseg.capacity) == \
                (jseg.tier, jseg.precision, jseg.nbytes, jseg.capacity), sid
            tq, tsc = _payload(self.t, tseg)
            jq, jsc = _payload(self.j, jseg)
            np.testing.assert_array_equal(tq, jq)
            assert tsc.keys() == jsc.keys()
            for k in jsc:
                np.testing.assert_array_equal(tsc[k], jsc[k])

    def assert_port_bitwise(self):
        """Every segment promoted back to the device equals what was put
        (fp32) or the int8 codes and scales of what was put."""
        for sid, x in self.data.items():
            if sid not in self.t:
                continue
            seg = self.t.promote(sid)
            assert seg.tier == "device"
            got = seg.caches["k"]
            if seg.precision == "int8":
                q, s = quantize_leaf(torch.from_numpy(x), self.t.seq_bucket)
                assert torch.equal(got, q)
                assert torch.equal(next(iter(seg.quant.scales.values())), s)
                back = dequantize_tree(seg.caches, seg.quant)["k"]
                bound = s.repeat_interleave(self.t.seq_bucket, 2)[..., None] / 2
                assert bool(((back - torch.from_numpy(x)).abs() <= bound + 1e-7).all())
            else:
                assert torch.equal(got, torch.from_numpy(x))


def _payload(store, seg):
    """(leaf array, {scale key: array}) of a segment on any tier, without
    promoting it."""
    if seg.caches is None:
        leaves, scales = store._load_spill_payload(seg)
        return np.asarray(leaves[0]), {k: np.asarray(v) for k, v in scales.items()}
    x = seg.caches["k"]
    leaf = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    scales = {} if seg.quant is None else {
        k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in seg.quant.scales.items()}
    return leaf, scales


# -- scenarios (tests/test_tiered_store.py, tests/test_quant_store.py) ----------

def _demote_to_host(tmp_path):
    tw = Twin(byte_budget=2 * NB8 + 1, host_budget=64 * NB8, precision="fp32")
    sids = [tw.put(i) for i in range(4)]
    assert tw.t.evictions == 0 and tw.t.demotions["host"] >= 2
    host = [s for s in sids if tw.t._segs[s].tier == "host"]
    assert isinstance(tw.t._segs[host[0]].caches["k"], torch.Tensor)
    tw.get(host[0])
    assert tw.t.promotions["host"] == 1 and tw.t.promoted_bytes == NB8
    return tw


def _host_cascades_to_disk(tmp_path):
    tw = Twin(tmp_path, byte_budget=2 * NB8 + 1, host_budget=NB8 + 1,
              precision="fp32")
    sids = [tw.put(i) for i in range(5)]
    tw.flush()
    assert tw.t.demotions["disk"] >= 1 and tw.t.spill_writes >= 1
    victim = next(s for s in sids if tw.t._segs[s].tier == "disk")
    seg = tw.get(victim)
    assert tw.t.promotions["disk"] == 1 and seg.spill is not None
    writes = tw.t.spill_writes
    tw.t._demote(seg, "disk")
    tw.j._demote(tw.j._segs[victim], "disk")
    tw.check()
    assert tw.t.spill_writes == writes          # re-demotion is a metadata flip
    tw.get(victim)
    return tw


def _evict_policy(tmp_path):
    tw = Twin(tmp_path, byte_budget=2 * NB8 + 1, host_budget=64 * NB8,
              precision="fp32", tier_policy="evict")
    for i in range(4):
        tw.put(i)
    assert tw.t.evictions >= 2 and tw.t.demotions == {"host": 0, "disk": 0}
    return tw


def _pinned_never_demoted(tmp_path):
    tw = Twin(byte_budget=2 * NB8 + 1, host_budget=64 * NB8, precision="fp32")
    first = tw.put(0)
    with tw.t.pinned([first]), tw.j.pinned([first]):
        for i in range(1, 5):
            tw.put(i)
        assert tw.t._segs[first].tier == "device"
    tw.put(5)
    assert tw.t.device_nbytes() <= tw.t.byte_budget
    return tw


def _prefetch(tmp_path):
    tw = Twin(byte_budget=2 * NB8 + 1, host_budget=64 * NB8, precision="fp32")
    sids = [tw.put(i) for i in range(4)]
    on_device = next(s for s in sids if tw.t._segs[s].tier == "device")
    for _ in range(4):
        tw.get(on_device)
    assert tw.prefetch("a") > 0
    for i in range(4, 8):
        tw.put(i)
    tw.prefetch("a", upto=8)
    for i in range(8, 14):
        tw.put(i, doc="oneoff")
    assert tw.prefetch("oneoff") == 0
    return tw


def _forced_int8(tmp_path):
    tw = Twin(precision="int8")
    sids = [tw.put(i) for i in range(3)]
    seg = tw.t._segs[sids[0]]
    assert seg.caches["k"].dtype == torch.int8
    assert seg.nbytes == cache_nbytes(seg.caches) + seg.quant.nbytes() < NB8 // 2
    assert tw.t.quantized == 3 and tw.t.quant_bytes_saved == 3 * (NB8 - seg.nbytes)
    return tw


def _auto_quantizes_victims_in_place(tmp_path):
    tw = Twin(precision="auto", byte_budget=2 * NB8 + 1, host_budget=64 * NB8)
    for i in range(4):
        tw.put(i)
    assert tw.t.quantized >= 2 and tw.t.demotions == {"host": 0, "disk": 0}
    return tw


def _auto_without_tiers_stays_fp32(tmp_path):
    tw = Twin(precision="auto", byte_budget=2 * NB8 + 1)
    for i in range(4):
        tw.put(i)
    assert tw.t.quantized == 0 and tw.t.evictions >= 2
    return tw


def _hot_documents_keep_fp32(tmp_path):
    tw = Twin(precision="auto", host_budget=64 * NB8)
    hot = tw.put(0, doc="hot")
    for _ in range(int(tw.t.cost.fp32_pin_reuses * 2) + 2):
        tw.get(hot)
    tw.t.byte_budget = tw.j.byte_budget = 3 * NB8 + 1
    for i in range(1, 6):
        tw.put(i, doc="cold")
    seg = tw.t._segs[hot]
    assert tw.t.quantized >= 1 and seg.precision == "fp32" and seg.tier == "device"
    return tw


def _demotion_compresses_on_the_way_out(tmp_path):
    tw = Twin(tmp_path, precision="auto", byte_budget=1, host_budget=64 * NB8)
    a = tw.put(0)
    tw.put(1)
    seg = tw.t._segs[a]
    assert seg.tier == "host" and seg.precision == "int8"
    assert seg.caches["k"].dtype == torch.int8
    assert all(s.device.type == "cpu" for s in seg.quant.scales.values())
    return tw


def _int8_spill_roundtrip(tmp_path):
    tw = Twin(tmp_path, precision="int8", byte_budget=1, host_budget=1)
    sids = [tw.put(i) for i in range(3)]
    tw.flush()
    disk = [s for s in sids if tw.t._segs[s].tier == "disk"]
    assert disk
    spill = tw.t._segs[disk[0]].spill
    info = zipfile.ZipFile(spill["file"]).infolist()
    assert all(m.compress_type == zipfile.ZIP_DEFLATED for m in info)
    assert {m.filename for m in info} == {
        m.filename for m in zipfile.ZipFile(tw.j._segs[disk[0]].spill["file"]).infolist()}
    seg = tw.get(disk[0])
    assert seg.precision == "int8" and seg.caches["k"].dtype == torch.int8
    return tw


def _spill_read_while_pending(tmp_path):
    """A promotion before the background write lands reads the
    write-through copy."""
    tw = Twin(tmp_path, precision="fp32", byte_budget=1, host_budget=1)
    sids = [tw.put(i) for i in range(3)]
    disk = [s for s in sids if tw.t._segs[s].tier == "disk"]
    tw.get(disk[0])
    tw.flush()
    return tw


SCENARIOS = [_demote_to_host, _host_cascades_to_disk, _evict_policy,
             _pinned_never_demoted, _prefetch, _forced_int8,
             _auto_quantizes_victims_in_place, _auto_without_tiers_stays_fp32,
             _hot_documents_keep_fp32, _demotion_compresses_on_the_way_out,
             _int8_spill_roundtrip, _spill_read_while_pending]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[1:])
def test_residency_matches_reference(tmp_path, scenario):
    tw = scenario(tmp_path)
    tw.flush()
    tw.assert_port_bitwise()


def test_fp32_spill_stays_uncompressed(tmp_path):
    tw = Twin(tmp_path, precision="fp32", byte_budget=1, host_budget=1)
    tw.put(0)
    tw.put(1)
    tw.flush()
    disk = next(s for s in tw.t._segs.values() if s.tier == "disk")
    info = zipfile.ZipFile(disk.spill["file"]).infolist()
    assert all(m.compress_type == zipfile.ZIP_STORED for m in info)


def test_bf16_segments_round_trip_every_tier_bitwise(tmp_path):
    """bf16 payloads (no numpy type) through host and disk and back."""
    store = SegmentStore(byte_budget=1, host_budget=1, spill_dir=tmp_path / "s",
                         seq_bucket=8, precision="fp32", device="cpu")
    xs = [torch.from_numpy(_data(i)).to(torch.bfloat16) for i in range(3)]
    sids = [store.put(Range(8 * i, 8 * i + 8), {"k": x}) for i, x in enumerate(xs)]
    store.flush_saves()
    assert store.demotions["disk"] >= 1
    for sid, x in zip(sids, xs):
        got = store.get(sid).caches["k"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, x)


def test_tier_policy_env_override(monkeypatch):
    """The tier policy is the argument's, ``"tiered"`` by default, and
    an unknown one is refused; ``REPRO_TIER_POLICY`` is not read."""
    monkeypatch.setenv("REPRO_TIER_POLICY", "evict")
    assert SegmentStore(seq_bucket=8).tier_policy == "tiered"
    assert SegmentStore(seq_bucket=8, tier_policy="evict").tier_policy == "evict"
    monkeypatch.setenv("REPRO_TIER_POLICY", "bogus")
    assert SegmentStore(seq_bucket=8).tier_policy == "tiered"
    with pytest.raises(ValueError, match="tier policy"):
        SegmentStore(seq_bucket=8, tier_policy="bogus")


def test_precision_env_override(monkeypatch):
    """The store's precision is the argument's, ``"auto"`` by default;
    ``REPRO_SEGMENT_PRECISION`` is not read."""
    monkeypatch.setenv("REPRO_SEGMENT_PRECISION", "int8")
    assert SegmentStore(seq_bucket=8).precision == "auto"
    assert SegmentStore(seq_bucket=8, precision="fp32").precision == "fp32"
    with pytest.raises(ValueError, match="segment precision"):
        SegmentStore(seq_bucket=8, precision="fp16")
