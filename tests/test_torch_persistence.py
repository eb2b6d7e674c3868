"""Snapshots of the port's stores, and snapshots across the two packages.

The contracts of ``tests/test_segment_persistence.py`` inside the port
(round trip, retention, shedding under a tighter budget, a crash mid-
snapshot, an interrupted swap, a bad version, a corrupt file, incremental
saves that hard-link unchanged entries, load-then-save writing nothing),
and the format shared with ``repro`` (manifest version 3, one npz per
entry, sha256 per file) in both directions: a ``repro`` snapshot loads in
the port and a port snapshot loads in ``repro``, for ``SegmentStore`` at
fp32 and int8, with and without recorded tiers, and for ``ModelStore`` in
every statistics family.  Payloads, scales and statistics must be bitwise
equal.  A version 2 manifest loads as fp32; bf16 leaves (no numpy type:
``|V2`` on disk) round-trip bitwise and load from a ``repro`` snapshot.
"""
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import suffstats as jss  # noqa: E402
from repro.core.descriptors import Range as JRange  # noqa: E402
from repro.core.store import ModelStore as JaxModelStore  # noqa: E402
from repro.serve.kv_cache import SegmentStore as JaxStore  # noqa: E402
from repro_torch.core import suffstats as tss  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.store import (MANIFEST_NAME, ModelStore,  # noqa: E402
                                    compact_snapshot_dir, to_numpy, to_torch)
from repro_torch.serve.kv_cache import SegmentStore, segment_from_record  # noqa: E402


def _data(i: int, tokens: int = 8, width: int = 4) -> np.ndarray:
    rng = np.random.default_rng(200 + i)
    return (rng.standard_normal((2, 1, tokens, 2, width)) * (i + 1)).astype(np.float32)


def _tree(x: np.ndarray, lib):
    """An unsorted dict (v before k) with a state leaf that stays lossless."""
    conv = (x[:, :, :2, 0] * 0.5).copy()
    if lib == "jax":
        return [{"v": jnp.asarray(-x), "k": jnp.asarray(x), "conv": jnp.asarray(conv)}]
    return [{"v": torch.from_numpy(-x), "k": torch.from_numpy(x),
             "conv": torch.from_numpy(conv)}]


def _port(**kw) -> SegmentStore:
    kw.setdefault("seq_bucket", 8)
    return SegmentStore(device="cpu", **kw)


def _filled(store, n=3, lib="torch", doc="a"):
    R = Range if lib == "torch" else JRange
    return [store.put(R(8 * i, 8 * i + 8), _tree(_data(i), lib), doc_id=doc)
            for i in range(n)]


def _arrays(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seg_payload(store, seg):
    """{path: array} of the leaves plus {key: scale} of a segment on any tier."""
    if seg.caches is None:
        from repro_torch.core.store import unflatten_tree

        leaves, scales = store._load_spill_payload(seg)
        tree = unflatten_tree(seg.spill["record"]["tree"], leaves)
    else:
        tree = seg.caches
        scales = {} if seg.quant is None else seg.quant.scales
    leaves = {(i, k): _arrays(v) for i, d in enumerate(tree) for k, v in d.items()}
    return leaves, {k: _arrays(v) for k, v in scales.items()}


def _assert_same_segments(a, b, *, tiers: bool = True):
    assert sorted(a._segs) == sorted(b._segs)
    assert a.seq_bucket == b.seq_bucket and a.nbytes() == b.nbytes()
    for sid, sa in a._segs.items():
        sb = b._segs[sid]
        assert (sa.rng.lo, sa.rng.hi, sa.valid, sa.capacity, sa.nbytes,
                sa.doc_id, sa.hits) == (sb.rng.lo, sb.rng.hi, sb.valid,
                                        sb.capacity, sb.nbytes, sb.doc_id,
                                        sb.hits), sid
        assert sa.tier == sb.tier or not tiers, sid
        la, qa = _seg_payload(a, sa)
        lb, qb = _seg_payload(b, sb)
        assert la.keys() == lb.keys() and qa.keys() == qb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype
            np.testing.assert_array_equal(la[k], lb[k])
        for k in qa:
            np.testing.assert_array_equal(qa[k], qb[k])
        if sa.quant is not None and sb.quant is not None:
            assert sa.quant.manifest() == sb.quant.manifest()


# -- across the packages ---------------------------------------------------------

def _tier_kwargs(tiers, precision, spill_dir):
    """No tiers, or device and host budgets of one and a half segments
    each: the snapshot records every tier."""
    if tiers == "flat":
        return {}
    one = _port(precision=precision)
    nbytes = one.nbytes(None) if _filled(one, 1) else 0
    return dict(byte_budget=3 * nbytes // 2, host_budget=3 * nbytes // 2,
                spill_dir=spill_dir)


@pytest.mark.parametrize("tiers", ["flat", "tiered"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_reference_snapshot_loads_in_the_port(tmp_path, precision, tiers):
    kw = _tier_kwargs(tiers, precision, tmp_path / "jspill")
    src = JaxStore(seq_bucket=8, precision=precision, **kw)
    sids = _filled(src, 4, lib="jax")
    src.flush_saves()
    src.save(tmp_path / "st")
    if kw:
        kw["spill_dir"] = tmp_path / "tspill"
        assert {s.tier for s in src._segs.values()} == {"device", "host", "disk"}
    got = SegmentStore.load(tmp_path / "st", device="cpu", precision=precision, **kw)
    _assert_same_segments(src, got)
    assert got.quantized_segments() == (4 if precision == "int8" else 0)
    for sid in sids:                       # promotion rebuilds what was saved
        seg = got.get(sid)
        assert seg.tier == "device" and seg.precision == precision
        assert (seg.quant is not None) == (precision == "int8")


@pytest.mark.parametrize("tiers", ["flat", "tiered"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_port_snapshot_loads_in_the_reference(tmp_path, precision, tiers):
    kw = _tier_kwargs(tiers, precision, tmp_path / "tspill")
    src = _port(precision=precision, **kw)
    sids = _filled(src, 4)
    src.flush_saves()
    src.save(tmp_path / "st")
    if kw:
        kw["spill_dir"] = tmp_path / "jspill"
        assert {s.tier for s in src._segs.values()} == {"device", "host", "disk"}
    got = JaxStore.load(tmp_path / "st", precision=precision, **kw)
    _assert_same_segments(src, got)
    for sid in sids:
        seg = got.get(sid)
        assert seg.tier == "device" and seg.precision == precision


def test_v2_manifest_loads_as_fp32(tmp_path):
    src = JaxStore(seq_bucket=8, precision="fp32")
    sids = _filled(src, 2, lib="jax")
    src.save(tmp_path / "st")
    mpath = tmp_path / "st" / MANIFEST_NAME
    manifest = json.loads(mpath.read_text())
    manifest["version"] = 2
    for rec in manifest["entries"]:
        rec.pop("precision", None)
    mpath.write_text(json.dumps(manifest))
    got = SegmentStore.load(tmp_path / "st", device="cpu")
    assert got.quantized_segments() == 0
    assert all(s.precision == "fp32" and s.quant is None for s in got._segs.values())
    _assert_same_segments(src, got)
    assert sids


def test_bf16_leaves_round_trip_and_cross_load(tmp_path):
    x = _data(3)
    port = _port(precision="fp32")
    sid = port.put(Range(0, 8), {"k": torch.from_numpy(x).to(torch.bfloat16)})
    port.save(tmp_path / "p")
    with np.load(tmp_path / "p" / "entry_000000.npz") as z:
        assert z["leaf_0"].dtype == np.dtype("V2")
    back = SegmentStore.load(tmp_path / "p", device="cpu")._segs[sid].caches["k"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, port._segs[sid].caches["k"])
    # the JAX package writes bf16 as the same 2-byte void
    ref = JaxStore(seq_bucket=8, precision="fp32")
    rid = ref.put(JRange(0, 8), {"k": jnp.asarray(x, jnp.bfloat16)})
    ref.save(tmp_path / "r")
    got = SegmentStore.load(tmp_path / "r", device="cpu")._segs[rid].caches["k"]
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(ref._segs[rid].caches["k"]).view(np.int16))
    assert to_numpy(got).dtype == np.dtype("V2")
    assert torch.equal(to_torch(to_numpy(got)), got)


def _family_stats(family, seed, lib):
    X = np.random.default_rng(seed).standard_normal((300, 5))
    y = np.random.default_rng(seed + 1).integers(0, 3, 300)
    mod = jss if lib == "jax" else tss
    if family == "linreg":
        return mod.LinRegStats.from_data(X, X @ np.arange(5.0) + 0.1 * y)
    if family == "gaussian_nb":
        return mod.GaussianNBStats.from_data(X, y, 3)
    if family == "multinomial_nb":
        return mod.MultinomialNBStats.from_data(np.abs(X), y, 3)
    return mod.LogRegMixtureStats.from_chunk_weights(X[0], 300)


FAMILIES = ["linreg", "gaussian_nb", "multinomial_nb", "logreg"]


def _fields(stats):
    return {k: np.asarray(v) for k, v in vars(stats).items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_model_store_snapshots_cross_load(tmp_path, family):
    jst, tst = JaxModelStore(), ModelStore()
    for i in range(3):
        r = (100 * i, 100 * i + 100)
        jst.put(family, JRange(*r), _family_stats(family, i, "jax"), meta={"i": i})
        tst.put(family, Range(*r), _family_stats(family, i, "torch"), meta={"i": i})
    jst.get(next(iter(jst._models)))
    jst.save(tmp_path / "j")
    tst.save(tmp_path / "t")
    for src, got in ((jst, ModelStore.load(tmp_path / "j")),
                     (tst, JaxModelStore.load(tmp_path / "t"))):
        assert sorted(src._models) == sorted(got._models)
        for mid, sm in src._models.items():
            gm = got._models[mid]
            assert (gm.family, gm.rng.lo, gm.rng.hi, gm.meta, gm.hits) == \
                (sm.family, sm.rng.lo, sm.rng.hi, sm.meta, sm.hits)
            a, b = _fields(sm.stats), _fields(gm.stats)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    # the two packages wrote the same arrays under the same names
    for a, b in zip(sorted((tmp_path / "j").glob("entry_*.npz")),
                    sorted((tmp_path / "t").glob("entry_*.npz"))):
        with np.load(a) as za, np.load(b) as zb:
            assert za.files == zb.files
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])


def test_segment_from_record_reads_a_snapshot_entry(tmp_path):
    src = _port(precision="int8")
    sid = _filled(src, 1)[0]
    src.save(tmp_path / "st")
    rec = json.loads((tmp_path / "st" / MANIFEST_NAME).read_text())["entries"][0]
    with np.load(tmp_path / "st" / rec["file"]) as z:
        seg = segment_from_record(rec, z, device="cpu")
    ref = src._segs[sid]
    assert seg.precision == "int8" and seg.quant.manifest() == ref.quant.manifest()
    assert torch.equal(seg.caches[0]["k"], ref.caches[0]["k"])


# -- inside the port (tests/test_segment_persistence.py) -------------------------

def test_segment_store_roundtrip_and_retention(tmp_path):
    store = _port(seq_bucket=16)
    a = store.put(Range(0, 16), _tree(_data(0, 16), "torch"), doc_id="hot")
    b = store.put(Range(16, 23), _tree(_data(1, 7), "torch"), doc_id="cold")
    for _ in range(5):
        store.get(a)
    store.save(tmp_path / "st")
    loaded = SegmentStore.load(tmp_path / "st", device="cpu")
    _assert_same_segments(store, loaded)
    la, lb = loaded._segs[a], loaded._segs[b]
    assert lb.valid == 7 and lb.capacity == 16 and la.hits == 5
    assert la.last_used_s == pytest.approx(store._segs[a].last_used_s)
    assert loaded.observed_reuses("hot") == store.observed_reuses("hot") > 1
    assert loaded._pins == {}
    loaded.byte_budget = la.nbytes + 1
    loaded._maybe_evict()
    assert a in loaded and b not in loaded


def test_load_under_tighter_budget_sheds_down(tmp_path):
    store = _port()
    _filled(store, 4)
    store.save(tmp_path / "st")
    per = store.nbytes() // 4
    loaded = SegmentStore.load(tmp_path / "st", device="cpu", byte_budget=2 * per + 1)
    assert 1 <= len(loaded) <= 2 and loaded.nbytes() <= 2 * per + 1


@pytest.mark.parametrize("kind", ["segment", "model"])
def test_crash_mid_snapshot_preserves_previous(tmp_path, monkeypatch, kind):
    if kind == "segment":
        store = _port()
        _filled(store, 2)
    else:
        store = ModelStore()
        for i in range(2):
            store.put("linreg", Range(100 * i, 100 * i + 100), _family_stats("linreg", i, "torch"))
    target = tmp_path / "st"
    store.save(target)
    before = (target / MANIFEST_NAME).read_text()
    if kind == "segment":
        for i in (5, 6):
            store.put(Range(8 * i, 8 * i + 8), _tree(_data(i), "torch"), doc_id="a")
    else:
        for i in (5, 6):
            store.put("linreg", Range(100 * i, 100 * i + 100), _family_stats("linreg", i, "torch"))
    calls = {"n": 0}
    real = np.savez

    def exploding(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full")
        return real(*args, **kwargs)

    monkeypatch.setattr(np, "savez", exploding)
    with pytest.raises(OSError):
        store.save(target)
    monkeypatch.undo()
    assert (target / MANIFEST_NAME).read_text() == before
    assert not list(tmp_path.glob(".st.tmp-*"))
    loaded = SegmentStore.load(target, device="cpu") if kind == "segment" \
        else ModelStore.load(target)
    assert len(loaded) == 2


def test_interrupted_swap_and_crash_litter(tmp_path):
    store = _port()
    _filled(store, 2)
    target = tmp_path / "st"
    store.save(target)
    (tmp_path / ".st.tmp-999").mkdir()
    os.rename(target, tmp_path / ".st.old-12345")
    loaded = SegmentStore.load(target, device="cpu")
    assert len(loaded) == 2 and (target / MANIFEST_NAME).exists()
    loaded.save(target)
    assert not list(tmp_path.glob(".st.old-*")) and not list(tmp_path.glob(".st.tmp-*"))
    with pytest.raises(FileNotFoundError):
        SegmentStore.load(tmp_path / "never_saved", device="cpu")


def test_bad_version_and_corrupt_file_raise(tmp_path):
    store = _port()
    _filled(store, 2)
    store.save(tmp_path / "st")
    shutil.copytree(tmp_path / "st", tmp_path / "st2")
    mpath = tmp_path / "st" / MANIFEST_NAME
    manifest = json.loads(mpath.read_text())
    assert manifest["version"] == 3 and manifest["kind"] == "SegmentStore"
    manifest["version"] = 1
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="manifest version"):
        SegmentStore.load(tmp_path / "st", device="cpu")
    victim = next((tmp_path / "st2").glob("entry_*.npz"))
    victim.write_bytes(victim.read_bytes()[:-5] + b"xxxxx")
    with pytest.raises(IOError, match="checksum"):
        SegmentStore.load(tmp_path / "st2", device="cpu")


def _inodes(root):
    manifest = json.loads((root / MANIFEST_NAME).read_text())
    return {rec.get("seg_id") or rec.get("model_id"): os.stat(root / rec["file"]).st_ino
            for rec in manifest["entries"]}


def test_incremental_save_reuses_inodes_and_load_then_save_writes_nothing(tmp_path):
    store = _port()
    a, b = _filled(store, 2)
    target = tmp_path / "st"
    store.save(target)
    assert store.last_save == {"written": 2, "reused": 0}
    before = _inodes(target)
    c = store.put(Range(40, 48), _tree(_data(5), "torch"), doc_id="a")
    store.get(a)
    store.save(target)
    assert store.last_save == {"written": 1, "reused": 2}
    after = _inodes(target)
    assert after[a] == before[a] and after[b] == before[b] and c in after
    loaded = SegmentStore.load(target, device="cpu")
    assert loaded._segs[a].hits == 1
    loaded.save(target)
    assert loaded.last_save == {"written": 0, "reused": 3}
    assert len(SegmentStore.load(target, device="cpu")) == 3


def test_save_async_and_compaction(tmp_path):
    store = _port(byte_budget=1, host_budget=1, spill_dir=tmp_path / "spill",
                  precision="int8")
    _filled(store, 3)
    assert store.save_async(tmp_path / "st")
    store.flush_saves()
    assert store.bg_saves == 1 and not store.save_errors
    (tmp_path / "st" / "entry_999999.npz").write_bytes(b"stranded")
    res = compact_snapshot_dir(tmp_path / "st")
    assert res == {"kept": 3, "dropped": 1}
    for f in (tmp_path / "st").glob("entry_*.npz"):
        assert os.stat(f).st_nlink == 1
    loaded = SegmentStore.load(tmp_path / "st", device="cpu")
    _assert_same_segments(store, loaded, tiers=False)
    assert loaded.quantized_segments() == 3


def test_model_store_save_async_and_retention(tmp_path):
    store = ModelStore()
    hot = store.put("linreg", Range(0, 250), _family_stats("linreg", 1, "torch"))
    store.put("linreg", Range(250, 500), _family_stats("linreg", 2, "torch"))
    for _ in range(3):
        store.get(hot)
    assert store.save_async(tmp_path / "ms")
    store.flush_saves()
    loaded = ModelStore.load(tmp_path / "ms")
    assert {m.model_id: m.hits for m in loaded.models()}[hot] == 3


@pytest.mark.parametrize("lib", ["port", "reference"])
def test_int8_snapshot_loaded_under_pressure_keeps_its_scales(tmp_path, lib):
    """Entries that a tighter load-time budget demotes to host or spills to
    disk during their own insertion keep their int8 sidecar: promoted back,
    every segment equals the source's codes and scales."""
    if lib == "port":
        src = _port(precision="int8")
        sids = _filled(src, 4)
    else:
        src = JaxStore(seq_bucket=8, precision="int8")
        sids = _filled(src, 4, lib="jax")
    for sid in sids:          # reloaded hits make each newcomer the victim
        for _ in range(3):
            src.get(sid)
    src.save(tmp_path / "st")
    one = src.nbytes() // 4
    got = SegmentStore.load(tmp_path / "st", device="cpu", precision="int8",
                            byte_budget=one + 1, host_budget=one + 1,
                            spill_dir=tmp_path / "spill")
    got.flush_saves()
    assert got.demotions["host"] > 0 and got.demotions["disk"] > 0
    assert got.quantized_segments() == len(got) == 4
    for sid in list(src._segs):
        seg = got.get(sid)
        assert seg.precision == "int8" and seg.quant is not None
        ref = src._segs[sid]
        la, qa = _seg_payload(src, ref)
        lb, qb = _seg_payload(got, seg)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])
        assert qa.keys() == qb.keys()
        for k in qa:
            np.testing.assert_array_equal(qa[k], qb[k])
