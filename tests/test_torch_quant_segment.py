"""One ``quant_kv`` call per segment, on the CPU.

``ops.dequantize_leaves`` takes every quantized leaf of one stored segment
(one launch on the card); on the CPU it runs the plain version per leaf,
so its results, and ``core/quant.py::dequantize_tree``'s, must equal
``dequantize_leaf_ref`` leaf by leaf and ``repro.core.quant.dequantize_tree``
bitwise, fed the same numpy inputs.  The kernel's descriptor table carries
each leaf's ``leaf_layout``; the entry point refuses mixed block sizes,
mixed output dtypes, more leaves than the kernel's parameter struct holds
and a leaf off a 16-byte boundary, before anything is launched.
"""
import struct

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels.quant_kv import kernel as qk  # noqa: E402
from repro_torch.kernels.quant_kv import ops  # noqa: E402
from repro_torch.kernels.quant_kv.ref import dequantize_leaf_ref  # noqa: E402

#: one segment's leaves: (shape, block); per-head rank 5 and 6, headless
#: rank 4, S a multiple of the block and not, cols 4 (scalar) to 128
SEGMENTS = {
    "dense k/v": [((3, 1, 32, 2, 128), 16), ((3, 1, 32, 2, 128), 16)],
    "ragged S": [((2, 1, 20, 3, 16), 8), ((2, 1, 20, 3, 24), 8)],
    "mixed ranks": [((2, 1, 17, 24), 8), ((2, 1, 17, 2, 3, 8), 8), ((2, 1, 17, 4), 8)],
    "eight leaves": [((1, 2, 9 + i, 2, 16), 4) for i in range(8)],
}


def _leaves(shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, (shape, block) in enumerate(shapes):
        x = (rng.standard_normal(shape) * rng.uniform(0.01, 50.0)).astype(np.float32)
        if i == 0:
            x[:, :, :block] = 0.0                      # an all-zero block
        out.append((x, block))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segment_call_is_per_leaf_plain_bitwise(name, dtype):
    leaves = _leaves(SEGMENTS[name], len(name))
    block = leaves[0][1]
    qs = [tq.quantize_leaf(torch.from_numpy(x), block) for x, _ in leaves]
    got = ops.dequantize_leaves(qs, block=block, dtype=dtype)
    assert len(got) == len(qs)
    for (q, s), g in zip(qs, got):
        want = dequantize_leaf_ref(q, s, block=block, dtype=dtype)
        assert g.dtype == dtype and g.shape == q.shape
        assert torch.equal(g, want)
        assert torch.equal(ops.dequantize_leaf(q, s, block=block, dtype=dtype), want)
    # one value per leaf that agree is the same call
    same = ops.dequantize_leaves(qs, block=[block] * len(qs),
                                 dtype=[str(dtype)[6:]] * len(qs))
    assert all(torch.equal(a, b) for a, b in zip(same, got))


def _tree(shapes, seed):
    """A stored segment's tree: per layer group a dict of k/v leaves, plus a
    state leaf that stays lossless."""
    rng = np.random.default_rng(seed)
    tree = [{"v": rng.standard_normal(shape).astype(np.float32),
             "k": rng.standard_normal(shape).astype(np.float32)} for shape in shapes]
    tree[0]["ssm"] = rng.standard_normal((2, 1, 4, 4)).astype(np.float32)
    return tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shapes,block", [
    ([(2, 1, 24, 2, 16)], 8),                                    # k, v: one call
    ([(2, 1, 20, 3, 24), (2, 1, 20, 24)], 8),                    # four leaves
    ([(1, 1, 9, 2, 16)] * 5, 4),                                 # ten: two calls
])
def test_dequantize_tree_matches_reference_bitwise(shapes, block, dtype):
    tree = _tree(shapes, len(shapes) + block)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jqt, jmeta = jq.quantize_tree(_map(tree, lambda a: jnp.asarray(a, jdt)), block=block)
    tqt, tmeta = tq.quantize_tree(_map(tree, lambda a: torch.from_numpy(a).to(tdt)),
                                  block=block)
    assert sorted(tmeta.scales) == sorted(jmeta.scales)
    got = tq.dequantize_tree(tqt, tmeta)
    want = jq.dequantize_tree(jqt, jmeta)
    flat_got = [x for _, x in tq.sorted_leaves_with_path(got)]
    flat_want = [x for _, x in tq.sorted_leaves_with_path(want)]
    assert len(flat_got) == len(flat_want)
    for j, (g, w) in enumerate(zip(flat_got, flat_want)):
        if str(j) in tmeta.scales:
            assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    # and leaf by leaf through the plain version
    for j, (_, q) in enumerate(tq.sorted_leaves_with_path(tqt)):
        if str(j) in tmeta.scales:
            assert torch.equal(flat_got[j], dequantize_leaf_ref(
                q, tmeta.scales[str(j)], block=block, dtype=tdt))


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_descriptor_table_carries_each_leaf_layout(name):
    leaves = _leaves(SEGMENTS[name], 3)
    block = leaves[0][1]
    qs = [tq.quantize_leaf(torch.from_numpy(x), block) for x, _ in leaves]
    layouts = [qk.leaf_layout(tuple(q.shape), s.shape[2], block) + (s.shape[2],)
               for q, s in qs]
    outs = [torch.empty(q.shape, dtype=torch.bfloat16) for q, _ in qs]
    table = qk.segment_table([(q, s, o.data_ptr(), lay)
                              for (q, s), o, lay in zip(qs, outs, layouts)])
    words = struct.unpack(f"<{len(table) // 8}q", table)
    assert len(words) == qk.LEAF_WORDS * len(qs) <= qk.LEAF_WORDS * qk.MAX_LEAVES
    for i, ((q, s), o, lay) in enumerate(zip(qs, outs, layouts)):
        w = words[i * qk.LEAF_WORDS:(i + 1) * qk.LEAF_WORDS]
        assert w[:3] == (q.data_ptr(), s.data_ptr(), o.data_ptr())
        assert w[3:] == lay
        assert lay == qk.leaf_layout(tuple(q.shape), s.shape[2], block) + (s.shape[2],)
        d01, S, H, cols, nb = lay
        assert d01 * S * H * cols == q.numel() and d01 * nb * H == s.numel()


def test_segment_call_refuses_what_one_launch_cannot_take():
    (x, block), = _leaves([((2, 1, 16, 2, 16), 8)], 5)
    q, s = tq.quantize_leaf(torch.from_numpy(x), block)
    q4, s4 = tq.quantize_leaf(torch.from_numpy(x), 4)
    with pytest.raises(ValueError, match="one block size"):
        ops.dequantize_leaves([(q, s), (q4, s4)], block=[8, 4], dtype=torch.float32)
    with pytest.raises(ValueError, match="one output dtype"):
        ops.dequantize_leaves([(q, s), (q, s)], block=8, dtype=["float32", "bfloat16"])
    with pytest.raises(ValueError, match="leaves"):
        ops.dequantize_leaves([(q, s)] * (qk.MAX_LEAVES + 1), block=8, dtype=torch.float32)
    with pytest.raises(ValueError, match="leaves"):
        ops.dequantize_leaves([], block=8, dtype=torch.float32)
    # the kernel's own checks run before anything is launched
    lay = qk.leaf_layout(tuple(q.shape), s.shape[2], 8) + (s.shape[2],)
    before = qk.KERNEL.launches
    with pytest.raises(ValueError, match="leaves"):
        qk.dequant_cuda([(q, s, lay)] * (qk.MAX_LEAVES + 1), block=8, dtype=torch.float32)
    buf = torch.empty(q.numel() + 32, dtype=torch.int8)
    at = (16 - buf.data_ptr() % 16) % 16 + 1          # one byte past a boundary
    odd = buf[at:at + q.numel()].view(q.shape)
    odd.copy_(q)
    assert odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        qk.dequant_cuda([(q, s, lay), (odd, s, lay)], block=8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="output dtype"):
        qk.dequant_cuda([(q, s, lay)], block=8, dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        qk.dequant_cuda([(q, s, lay), (q.transpose(3, 4).contiguous().transpose(3, 4),
                                       s, lay)], block=8, dtype=torch.float32)
    assert qk.KERNEL.launches == before


def test_output_views_start_on_16_byte_boundaries():
    shapes = ((3, 1, 17, 2, 16), (5,), (2, 1, 9, 24), (1,))
    total, views = qk.out_views(shapes)
    ends = [off for _, _, off in views[1:]] + [total]
    for (shape, strides, off), end, sh in zip(views, ends, shapes):
        assert shape == sh and off % qk.OUT_ALIGN == 0
        assert off + int(np.prod(sh)) <= end
        assert torch.empty(sh).stride() == strides       # contiguous views
