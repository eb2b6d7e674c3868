"""Blockwise int8 quantization and the ``quant_kv`` dequant: the port
against ``repro`` on the same numpy inputs.

Required exactly: the int8 codes and fp32 scales of ``quantize_leaf``
(fp32 cast, block ``amax``, ``amax/127``, fp32 division, round half to
even, clamp ±127), the plain dequant at fp32 against ``repro``'s kernel
in interpret mode and its ``mode="ref"`` route, and ``QuantMeta``'s leaf
keys on a tree whose dict insertion order is not sorted.  The round trip
stays within half a quantization step (``scale/2``) of its block, as a
hypothesis property like ``tests/test_quant.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels.quant_kv.kernel import dequant_blocks_streams  # noqa: E402
from repro.kernels.quant_kv.ops import dequantize_leaf as jax_dequantize_leaf  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.quant_kv import ops  # noqa: E402
from repro_torch.kernels.quant_kv.kernel import leaf_layout  # noqa: E402
from repro_torch.kernels.quant_kv.ref import (dequant_blocks_ref,  # noqa: E402
                                              dequantize_leaf_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

#: (shape, block): ranks 4, 5 and 6; S a multiple of the block and not;
#: cols 16, 24 and 128 after the head axis
SHAPES = [((2, 1, 24, 3, 16), 8), ((2, 1, 20, 3, 16), 8), ((3, 1, 17, 24), 4),
          ((2, 1, 40, 2, 3, 8), 16), ((1, 2, 33, 2, 128), 16), ((2, 1, 5, 4), 8)]


def _leaf(shape, seed, *, zero_block=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 50.0)).astype(np.float32)
    if zero_block is not None:
        x[:, :, :zero_block] = 0.0     # an all-zero block: scale 1/127
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,block", SHAPES)
def test_quantize_leaf_codes_equal_reference(shape, block, dtype):
    x = _leaf(shape, sum(shape) + block, zero_block=min(block, shape[2]))
    jdt, tdt = DTYPES[dtype]
    jqv, jsc = jq.quantize_leaf(jnp.asarray(x, jdt), block)
    tqv, tsc = tq.quantize_leaf(torch.from_numpy(x).to(tdt), block)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert float(tsc[:, :, 0].min()) == pytest.approx(1.0 / 127.0)


@pytest.mark.parametrize("shape,block", SHAPES)
def test_dequantize_leaf_bitwise_equal_reference(shape, block):
    """The port's plain version (the CPU route) against ``repro``'s kernel
    in interpret mode and its reference route, at fp32 out."""
    x = _leaf(shape, 7 + block, zero_block=block)
    q, s = tq.quantize_leaf(torch.from_numpy(x), block)
    jqv, jsc = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    got = ops.dequantize_leaf(q, s, block=block, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == q.shape
    for mode in ("kernel", "ref"):
        want = jax_dequantize_leaf(jqv, jsc, block=block, dtype=jnp.float32,
                                   mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,block", SHAPES[:3])
def test_dequantize_leaf_bf16_is_fp32_then_cast(shape, block):
    """bf16 out is the fp32 product rounded once: ``repro``'s fp32 result
    cast with ``astype``."""
    q, s = tq.quantize_leaf(torch.from_numpy(_leaf(shape, 3)), block)
    got = ops.dequantize_leaf(q, s, block=block, dtype="bfloat16")
    want = jax_dequantize_leaf(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               block=block, dtype=jnp.bfloat16, mode="ref")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_dequantize_blocks_matches_the_tpu_kernel():
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (6, 8, 16)).astype(np.int8)
    s = rng.uniform(1e-3, 2.0, (6,)).astype(np.float32)
    want = dequant_blocks_streams(jnp.asarray(q), jnp.asarray(s), interpret=True)
    got = ops.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dequant_blocks_ref(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("shape,block", SHAPES)
def test_native_layout_plain_equals_block_layout(shape, block):
    """The native-layout plain version computes the block layout's function:
    the kernel's index arithmetic ``(d01·nb + s/block)·H + h`` picks the
    scale that ``repro``'s pad/transpose layout gives each row."""
    q, s = tq.quantize_leaf(torch.from_numpy(_leaf(shape, 11)), block)
    d01, S, H, cols = leaf_layout(tuple(q.shape), s.shape[2], block)
    assert d01 * S * H * cols == q.numel() and s.numel() == d01 * s.shape[2] * H
    flat_q, flat_s = q.reshape(-1), s.reshape(-1)
    e = torch.arange(q.numel())
    r = e // cols
    h, t = r % H, r // H
    idx = (t // S * s.shape[2] + (t % S) // block) * H + h
    want = flat_q.float() * flat_s[idx]
    got = dequantize_leaf_ref(q, s, block=block, dtype=torch.float32)
    torch.testing.assert_close(got.reshape(-1), want, rtol=0, atol=0)


def test_leaf_layout_rejects_short_scales():
    with pytest.raises(ValueError, match="exceed"):
        leaf_layout((1, 1, 40, 2, 8), 2, 16)
    with pytest.raises(ValueError, match="rank"):
        leaf_layout((4, 8), 1, 8)


# -- trees ---------------------------------------------------------------------

def _unsorted_tree(seed):
    """Insertion order v, k, ssm, ck: not the sorted order JAX flattens in."""
    rng = np.random.default_rng(seed)
    return [{"v": rng.standard_normal((2, 1, 16, 2, 4)).astype(np.float32),
             "k": rng.standard_normal((2, 1, 16, 2, 4)).astype(np.float32),
             "ssm": rng.standard_normal((2, 1, 4, 4)).astype(np.float32),
             "ck": np.ones((2, 1, 3, 4), np.float32)},
            {"c_kv": rng.standard_normal((2, 1, 16, 8)).astype(np.float32)}]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def test_quant_meta_keys_follow_jax_leaf_order():
    tree = _unsorted_tree(1)
    jqt, jmeta = jq.quantize_tree(_map(tree, jnp.asarray), block=8)
    tqt, tmeta = tq.quantize_tree(_map(tree, torch.from_numpy), block=8)
    # sorted flattening: ck=0, k=1, ssm=2, v=3, c_kv=4
    assert sorted(tmeta.scales) == sorted(jmeta.scales) == ["1", "3", "4"]
    assert tmeta.dtypes == jmeta.dtypes and tmeta.manifest() == jmeta.manifest()
    for k in jmeta.scales:
        np.testing.assert_array_equal(tmeta.scales[k].numpy(),
                                      np.asarray(jmeta.scales[k]))
    assert tmeta.nbytes() == jmeta.nbytes()
    # the port keeps its own insertion order; leaves equal by path
    assert list(tqt[0]) == ["v", "k", "ssm", "ck"]
    for i, d in enumerate(tqt):
        for key, x in d.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(jqt[i][key]))
    back = tq.dequantize_tree(tqt, tmeta)
    jback = jq.dequantize_tree(jqt, jmeta, mode="ref")
    for i, d in enumerate(back):
        for key, x in d.items():
            assert x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), np.asarray(jback[i][key]))
    # state and constant leaves pass through untouched
    assert tqt[0]["ssm"].dtype == torch.float32
    np.testing.assert_array_equal(tqt[0]["ck"].numpy(), tree[0]["ck"])


def test_quantize_tree_of_int8_is_a_noop():
    qt, _ = tq.quantize_tree(_map(_unsorted_tree(2), torch.from_numpy), block=8)
    _, meta = tq.quantize_tree(qt, block=8)
    assert not meta.scales


def test_resolve_precision_env_and_validation(monkeypatch):
    """The port's precision is its argument's, ``"auto"`` by default;
    ``REPRO_SEGMENT_PRECISION`` is not read."""
    assert tq.PRECISIONS == jq.PRECISIONS
    monkeypatch.setenv("REPRO_SEGMENT_PRECISION", "fp32")
    assert tq.resolve_precision() == "auto"
    assert tq.resolve_precision("int8") == "int8"
    with pytest.raises(ValueError, match="segment precision"):
        tq.resolve_precision("fp16")


# -- property: the round trip stays within scale/2 -----------------------------

@given(
    dims=st.tuples(st.integers(1, 3), st.integers(1, 17),
                   st.integers(1, 4), st.integers(1, 6)),
    block=st.sampled_from([1, 4, 8, 16]),
    mode=st.sampled_from(["normal", "zero", "negative", "mixed_mag"]),
    rank5=st.booleans(),
    seed=st.integers(0, 2**16),
)
@settings(max_examples=30, deadline=None)
def test_roundtrip_error_bounded(dims, block, mode, rank5, seed):
    layers, seq, heads, hd = dims
    shape = (layers, 1, seq, heads, hd) if rank5 else (layers, 1, seq, hd)
    rng = np.random.default_rng(seed)
    if mode == "zero":
        x = np.zeros(shape, np.float32)
    elif mode == "negative":
        x = -np.abs(rng.standard_normal(shape)).astype(np.float32) - 0.1
    elif mode == "mixed_mag":
        x = (rng.standard_normal(shape)
             * np.logspace(-3, 3, seq).reshape((1, 1, seq) + (1,) * (len(shape) - 3))
             ).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32) * 5
    q, s = tq.quantize_leaf(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and q.shape == x.shape
    err = (tq.dequantize_leaf(q, s, block=block, dtype=torch.float32)
           - torch.from_numpy(x)).abs()
    rows = s.repeat_interleave(block, dim=2)[:, :, :seq]
    bound = rows.reshape(rows.shape + (1,) * (x.ndim - rows.ndim))
    assert bool((err <= bound / 2 + 1e-7).all()), (shape, block)
