"""The split-KV decode algorithm in plain PyTorch, on the CPU.

``ref.py::decode_attention_split`` is what the CUDA decode kernel computes:
per-split partials (``m``, ``l``, unnormalised ``acc``) over fixed splits of
``split`` positions, then a combine over the live splits in ascending
order.  At the kernel's split length it must match
``repro``'s Pallas kernel (interpret mode) at ``tests/test_torch_kernels.py``'s
tolerance, match the port's blocked plain version in fp32 within 1e-6, and
keep the two invariants serving rests on: a row's output is bitwise the same
at any padded capacity and in any batch.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ops as jax_decode  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    MAX_SPLITS, SPLIT, decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_blocked, decode_attention_split)

RTOL, ATOL = 1e-4, 1e-5          # tests/test_torch_kernels.py's
HD = 16


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grouped(q, kv):
    """(B, 1, H, hd) numpy → (B, KV, G, hd) tensor."""
    b, _, h, hd = q.shape
    return torch.from_numpy(q)[:, 0].reshape(b, kv, h // kv, hd)


@pytest.mark.parametrize("kv,g", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("t", [640, 300])
def test_split_matches_jax_kernel(t, kv, g):
    """Rows at pos 0, split − 1, split and T − 1: one split, its last
    position, the first position of the second split, and the full cache
    (T = 300 ends inside a split)."""
    b, h = 4, kv * g
    seed = t + 10 * kv
    q = _rand((b, 1, h, HD), seed)
    k = _rand((b, t, kv, HD), seed + 1)
    v = _rand((b, t, kv, HD), seed + 2)
    pos = np.asarray([0, SPLIT - 1, SPLIT, t - 1], np.int32)
    want = jax_decode.decode_attention(q, k, v, pos=jnp.asarray(pos), chunk=64,
                                       interpret=True)
    got = decode_attention_split(_grouped(q, kv), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(pos),
                                 split=SPLIT)
    np.testing.assert_allclose(got.numpy().reshape(b, 1, h, HD), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv,g,t", [(1, 1, 100), (2, 4, 640), (4, 3, 333)])
def test_split_matches_blocked_fp32(kv, g, t):
    b = 5
    q = torch.from_numpy(_rand((b, kv, g, HD), 30 + t))
    k = torch.from_numpy(_rand((b, t, kv, HD), 31 + t))
    v = torch.from_numpy(_rand((b, t, kv, HD), 32 + t))
    pos = torch.tensor([0, t // 3, t // 2, t - 2, t - 1], dtype=torch.int32)
    got = decode_attention_split(q, k, v, pos, split=SPLIT)
    want = decode_attention_blocked(q, k, v, pos)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("small,big,pos_list", [
    (640, 1600, [0, SPLIT + 7, 2 * SPLIT + 1, 639]),    # up to 5 splits
    (300, 700, [0, SPLIT - 1, SPLIT, 299]),              # cap inside a split
    (130, 2000, [1, 2, SPLIT, 129]),
])
def test_split_bit_invariant_to_capacity(small, big, pos_list):
    """A garbage tail (×1e3) past each row's pos at the larger capacity."""
    b, kv, g = 4, 2, 3
    q = torch.from_numpy(_rand((b, kv, g, HD), 40))
    k = torch.from_numpy(_rand((b, small, kv, HD), 41))
    v = torch.from_numpy(_rand((b, small, kv, HD), 42))
    kb = torch.from_numpy(_rand((b, big, kv, HD), 43, 1e3))
    vb = torch.from_numpy(_rand((b, big, kv, HD), 44, 1e3))
    kb[:, :small], vb[:, :small] = k, v
    pos = torch.tensor(pos_list, dtype=torch.int32)
    out_small = decode_attention_split(q, k, v, pos, split=SPLIT)
    out_big = decode_attention_split(q, kb, vb, pos, split=SPLIT)
    assert torch.equal(out_small, out_big)


@pytest.mark.parametrize("pos_list", [
    [599, 3, SPLIT, 2 * SPLIT + 5],
    [0, 0, 599, SPLIT - 1],
])
def test_split_row_independent_of_batch(pos_list):
    """Each row of a batch of 4 equals the same row computed alone."""
    b, kv, g, t = 4, 4, 2, 600
    q = torch.from_numpy(_rand((b, kv, g, HD), 50))
    k = torch.from_numpy(_rand((b, t, kv, HD), 51))
    v = torch.from_numpy(_rand((b, t, kv, HD), 52))
    pos = torch.tensor(pos_list, dtype=torch.int32)
    batch = decode_attention_split(q, k, v, pos, split=SPLIT)
    for row in range(b):
        alone = decode_attention_split(q[row:row + 1], k[row:row + 1],
                                       v[row:row + 1], pos[row:row + 1],
                                       split=SPLIT)
        assert torch.equal(batch[row:row + 1], alone)


def test_launcher_refuses_capacity_past_combine_limit():
    """One split past what the combine's shared memory takes is refused
    before anything is launched."""
    cap = (MAX_SPLITS + 1) * SPLIT
    q = torch.zeros((1, 1, 2, HD), dtype=torch.bfloat16)
    k = torch.zeros((1, cap, 1, HD), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="capacity"):
        decode_attention_cuda(q, k, k, torch.zeros(1, dtype=torch.int32))
