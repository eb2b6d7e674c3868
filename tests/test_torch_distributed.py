"""The port's distribution layer: ``repro_torch.distributed``.

The contracts of ``tests/test_distributed.py``'s ``TestCompression`` (all
but the mesh all-gather, which belongs to training), ``TestWirePayloads``
and ``TestFault`` held inside the port, then against ``repro`` on the same
inputs: ``quantize_int8`` and ``ef_compress`` give ``repro``'s int8 codes
and scales bit for bit, and ``pack_arrays`` writes ``repro``'s bytes.
"""
import time

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as jax_compression  # noqa: E402
from repro.distributed import fault as jax_fault  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_bytes,
    dequantize_int8,
    ef_compress,
    ef_state_like,
    pack_arrays,
    quantize_int8,
    raw_bytes,
    unpack_arrays,
)
from repro_torch.distributed.fault import (  # noqa: E402
    HeartbeatMonitor,
    RetryPolicy,
    StragglerDetector,
    plan_elastic_mesh,
)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

class TestCompression:
    def test_quantize_roundtrip_error_bounded(self):
        x = _t(np.random.default_rng(0).standard_normal(1000) * 5)
        q, s = quantize_int8(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        err = (dequantize_int8(q, s) - x.float()).abs()
        assert float(err.max()) <= float(s) / 2 + 1e-6

    def test_error_feedback_removes_bias(self):
        """EF-int8 SGD converges where plain quantized SGD stalls/biases."""
        rng = np.random.default_rng(1)
        A = _t(rng.standard_normal((32, 8)).astype(np.float32))
        x_true = _t(rng.standard_normal(8).astype(np.float32))
        b = A @ x_true

        def grad(x):
            return 2 * A.T @ (A @ x - b) / 32

        x = torch.zeros(8)
        ef = torch.zeros(8)
        for _ in range(600):
            q, s, ef = ef_compress(grad(x), ef)
            x = x - 0.05 * dequantize_int8(q, s)
        assert float(torch.linalg.norm(x - x_true)) < 1e-2

    @pytest.mark.parametrize("scale", [0.0, 1e-14], ids=["zeros", "subfloor"])
    def test_zero_and_subfloor_tensors_roundtrip(self, scale):
        """Zeros come back exact with a finite positive scale; sub-floor
        values still obey the scale/2 bound."""
        x = _t((np.random.default_rng(2).standard_normal(64) * scale).astype(np.float32))
        q, s = quantize_int8(x)
        assert np.isfinite(float(s)) and float(s) > 0
        err = (dequantize_int8(q, s) - x).abs()
        assert float(err.max()) <= (float(s) / 2 + 1e-30 if scale else 0.0)

    def test_compression_ratio(self):
        g = {"w": torch.zeros(1024, 1024), "b": torch.zeros(1024)}
        assert compressed_bytes(g) < raw_bytes(g) / 3.9

    def test_ef_state_like(self):
        g = {"w": torch.zeros(4, 4, dtype=torch.bfloat16), "v": [torch.zeros(3)]}
        ef = ef_state_like(g)
        assert ef["w"].dtype == torch.float32 and ef["w"].shape == (4, 4)
        assert ef["v"][0].dtype == torch.float32 and ef["v"][0].shape == (3,)

    @pytest.mark.parametrize("scale", [5.0, 1e-3, 0.0], ids=["wide", "narrow", "zeros"])
    def test_codes_and_scales_match_reference(self, scale):
        x = (np.random.default_rng(3).standard_normal((17, 9)) * scale).astype(np.float32)
        jq, js = jax_compression.quantize_int8(jnp.asarray(x))
        q, s = quantize_int8(_t(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(jax_compression.dequantize_int8(jq, js)))

    def test_error_feedback_matches_reference(self):
        rng = np.random.default_rng(4)
        g = rng.standard_normal(257).astype(np.float32)
        ef = (rng.standard_normal(257) * 0.01).astype(np.float32)
        jq, js, jef = jax_compression.ef_compress(jnp.asarray(g), jnp.asarray(ef))
        q, s, new_ef = ef_compress(_t(g), _t(ef))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(new_ef.numpy(), np.asarray(jef))

    def test_byte_counts_match_reference(self):
        shapes = {"w": (64, 32), "b": (32,), "e": (3, 4, 5)}
        g = {k: torch.zeros(v) for k, v in shapes.items()}
        jg = {k: jnp.zeros(v) for k, v in shapes.items()}
        assert compressed_bytes(g) == jax_compression.compressed_bytes(jg)
        assert raw_bytes(g) == jax_compression.raw_bytes(jg)


# ---------------------------------------------------------------------------
# wire payloads
# ---------------------------------------------------------------------------

def _segment_payload(rng):
    # two padded KV leaves as a quantized segment ships them
    return {
        "leaf_0": rng.integers(-128, 128, (1, 1, 32, 2, 8)).astype(np.int8),
        "leaf_1": rng.integers(-128, 128, (1, 1, 32, 2, 8)).astype(np.int8),
        "qscale_0": rng.random((1, 1, 4, 2, 8)).astype(np.float32),
        "qscale_1": rng.random((1, 1, 4, 2, 8)).astype(np.float32),
    }


def _mixed_payload(rng):
    return {
        "leaf_0": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "leaf_1": np.arange(6, dtype=np.int32),
        "leaf_2": np.full((2, 2), 1.5, np.float32),
    }


def _degenerate_payload(rng):
    # a fully-invalid tail pads to a zero-length valid region
    return {"leaf_0": np.zeros((1, 1, 0, 2, 4), np.float32),
            "leaf_1": np.float32(3.25)}


PAYLOADS = {"segment": _segment_payload, "mixed": _mixed_payload,
            "degenerate": _degenerate_payload}


class TestWirePayloads:
    @pytest.mark.parametrize("kind", list(PAYLOADS))
    def test_roundtrip(self, kind):
        arrays = PAYLOADS[kind](np.random.default_rng(0))
        out = unpack_arrays(pack_arrays(arrays))
        assert sorted(out.files) == sorted(arrays)
        for k, v in arrays.items():
            v = np.asarray(v)
            assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
            np.testing.assert_array_equal(out[k], v)

    def test_padded_payload_deflates(self):
        """Bucket padding is mostly zeros: the frame comes in well under the
        raw bytes (savez_compressed deflates)."""
        x = np.zeros((1, 1, 128, 2, 64), np.float32)
        x[..., :5, :, :] = 1.0
        assert len(pack_arrays({"leaf_0": x})) < x.nbytes / 10

    @pytest.mark.parametrize("kind", list(PAYLOADS))
    def test_bytes_match_reference(self, kind, monkeypatch):
        """The same arrays pack to ``repro``'s bytes (the zip entries'
        timestamps held at one instant), and each package unpacks the
        other's."""
        arrays = PAYLOADS[kind](np.random.default_rng(1))
        now = time.time()
        monkeypatch.setattr(time, "time", lambda: now)
        ours, theirs = pack_arrays(arrays), jax_compression.pack_arrays(arrays)
        assert ours == theirs
        for data, unpack in ((ours, jax_compression.unpack_arrays),
                             (theirs, unpack_arrays)):
            out = unpack(data)
            for k, v in arrays.items():
                np.testing.assert_array_equal(out[k], np.asarray(v))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

class TestFault:
    def test_heartbeat(self):
        hb = HeartbeatMonitor(timeout_s=10.0)
        hb.beat("h0", t=100.0)
        hb.beat("h1", t=105.0)
        assert hb.dead(now=112.0) == ["h0"]
        assert hb.alive(now=112.0) == ["h1"]

    def test_straggler_detection(self):
        sd = StragglerDetector(factor=2.0, min_samples=3)
        for _ in range(5):
            for h in ("a", "b", "c"):
                sd.observe(h, 1.0)
            sd.observe("slow", 5.0)
        assert sd.stragglers() == ["slow"]

    def test_heartbeat_revival_and_unknown_hosts(self):
        hb = HeartbeatMonitor(timeout_s=10.0)
        hb.beat("h0", t=0.0)
        assert hb.dead(now=11.0) == ["h0"]
        hb.beat("h0", t=12.0)
        assert hb.dead(now=13.0) == [] and hb.alive(now=13.0) == ["h0"]
        assert "ghost" not in hb.alive(now=13.0) + hb.dead(now=13.0)

    def test_heartbeat_boundary_is_exclusive(self):
        hb = HeartbeatMonitor(timeout_s=10.0)
        hb.beat("h0", t=0.0)
        assert hb.alive(now=10.0) == ["h0"]     # exactly at timeout: alive
        assert hb.dead(now=10.0 + 1e-9) == ["h0"]

    def test_two_host_straggler_flagged(self):
        """With an even fleet the lower median keeps a 2-shard deployment
        able to flag its own straggler."""
        sd = StragglerDetector(factor=2.0, min_samples=3)
        for _ in range(5):
            sd.observe("fast", 1.0)
            sd.observe("slow", 10.0)
        assert sd.fleet_median() == 1.0
        assert sd.stragglers() == ["slow"]

    def test_fleet_median_is_lower_middle(self):
        sd = StragglerDetector()
        for host, v in (("a", 1.0), ("b", 2.0), ("c", 3.0), ("d", 9.0)):
            sd.observe(host, v)
        assert sd.fleet_median() == 2.0
        assert StragglerDetector().fleet_median() == 0.0

    def test_straggler_needs_min_samples(self):
        sd = StragglerDetector(factor=2.0, min_samples=3)
        for _ in range(3):
            sd.observe("fast", 1.0)
        sd.observe("slow", 50.0)
        sd.observe("slow", 50.0)
        assert sd.stragglers() == []             # two samples: not yet
        sd.observe("slow", 50.0)
        assert sd.stragglers() == ["slow"]

    def test_straggler_ewma_recovers(self):
        sd = StragglerDetector(alpha=0.5, factor=2.0, min_samples=3)
        for _ in range(4):
            sd.observe("fast", 1.0)
            sd.observe("was-slow", 20.0)
        assert sd.stragglers() == ["was-slow"]
        for _ in range(10):
            sd.observe("fast", 1.0)
            sd.observe("was-slow", 1.0)
        assert sd.stragglers() == []

    def test_elastic_mesh_plan(self):
        assert plan_elastic_mesh(64, 4, 16) == (16, 16)
        assert plan_elastic_mesh(60, 4, 16) == (8, 16)
        with pytest.raises(ValueError):
            plan_elastic_mesh(1, 4, 16)

    def test_retry_policy(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        assert RetryPolicy(max_retries=3, backoff_s=0.001).run(flaky) == "ok"
        assert calls["n"] == 3

    def test_detector_and_monitor_match_reference(self):
        """One trace of beats and step times through both packages' classes
        gives the same dead, alive, median and straggler answers."""
        rng = np.random.default_rng(6)
        ours = (HeartbeatMonitor(timeout_s=3.0), StragglerDetector())
        theirs = (jax_fault.HeartbeatMonitor(timeout_s=3.0), jax_fault.StragglerDetector())
        for step in range(40):
            host = f"h{int(rng.integers(0, 5))}"
            dt = float(rng.gamma(2.0)) * (8.0 if host == "h3" else 1.0)
            for hb, sd in (ours, theirs):
                hb.beat(host, t=float(step))
                sd.observe(host, dt)
            now = step + 0.5
            assert ours[0].dead(now=now) == theirs[0].dead(now=now)
            assert ours[0].alive(now=now) == theirs[0].alive(now=now)
            assert ours[1].fleet_median() == theirs[1].fleet_median()
            assert ours[1].stragglers() == theirs[1].stragglers()
        for n in (16, 17, 60, 64, 256):
            assert plan_elastic_mesh(n, 4, 16) == jax_fault.plan_elastic_mesh(n, 4, 16)
