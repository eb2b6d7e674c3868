"""The port's kernel plain versions against the JAX package's Pallas kernels.

Same numpy inputs (``np.random.default_rng``) go through
``repro.kernels.*.ops`` in Pallas interpret mode and through the port's
wrappers on CPU tensors (which route to the plain PyTorch versions).
Tolerance rtol 1e-4 / atol 1e-5: the JAX kernel tests' own, since fp32
reduction order differs between the two frameworks.  Capacity
bit-invariance of decode is checked exactly inside the port.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ops as jax_decode  # noqa: E402
from repro.kernels.extend_attention import ops as jax_extend  # noqa: E402
from repro_torch.kernels.common import bucket_len, pad_axis, round_up  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_blocked, decode_attention_ref)
from repro_torch.kernels.extend_attention import ops as extend_ops  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kv_heads", [4, 2, 1])       # GQA group sizes 1/2/4
@pytest.mark.parametrize("t_real", [16, 55, 96])      # prefix-empty → full
def test_extend_plain_matches_jax_kernel(kv_heads, t_real):
    b, nb, h, hd, cap = 2, 16, 4, 16, 96
    q = _rand((b, nb, h, hd), 10)
    k = _rand((b, cap, kv_heads, hd), 11)
    v = _rand((b, cap, kv_heads, hd), 12)
    want = jax_extend.extend_attention(q, k, v, t_real=t_real, chunk=32,
                                       interpret=True)
    got = extend_ops.extend_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      t_real=torch.tensor(t_real, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv,g", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("t", [64, 200, 320])
def test_decode_plain_matches_jax_kernel(kv, g, t):
    """Ragged per-row pos including the pos=0 and pos=T−1 boundaries."""
    b, hd = 4, 16
    h = kv * g
    q = _rand((b, 1, h, hd), kv * 10 + t)
    k = _rand((b, t, kv, hd), kv * 10 + t + 1)
    v = _rand((b, t, kv, hd), kv * 10 + t + 2)
    pos = np.asarray([0, 1, t // 2, t - 1], np.int32)
    want = jax_decode.decode_attention(q, k, v, pos=jnp.asarray(pos), chunk=64,
                                       interpret=True)
    got = decode_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    dense = decode_attention_ref(torch.from_numpy(q)[:, 0].reshape(b, kv, g, hd),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy().reshape(b, kv, g, hd), dense.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_decode_output_bit_invariant_to_padded_capacity():
    """Growing the padded capacity from 256 to 2048 changes no bit of the
    port's decode output (garbage past pos is never read into a sum)."""
    b, kv, g, hd, small, big = 3, 2, 2, 16, 256, 2048
    q = torch.from_numpy(_rand((b, 1, kv * g, hd), 3))
    k = torch.from_numpy(_rand((b, small, kv, hd), 4))
    v = torch.from_numpy(_rand((b, small, kv, hd), 5))
    pos = torch.tensor([0, 100, small - 1], dtype=torch.int32)
    kb = torch.from_numpy(_rand((b, big, kv, hd), 6) * 1e3)   # garbage tail
    vb = torch.from_numpy(_rand((b, big, kv, hd), 7) * 1e3)
    kb[:, :small], vb[:, :small] = k, v
    out_small = decode_ops.decode_attention(q, k, v, pos=pos)
    out_big = decode_ops.decode_attention(q, kb, vb, pos=pos)
    assert torch.equal(out_small, out_big)


def test_blocked_decode_matches_dense_oracle():
    b, t, kv, g, hd = 2, 700, 2, 4, 16
    q = torch.from_numpy(_rand((b, kv, g, hd), 20))
    k = torch.from_numpy(_rand((b, t, kv, hd), 21))
    v = torch.from_numpy(_rand((b, t, kv, hd), 22))
    pos = torch.tensor([300, 699], dtype=torch.int32)
    np.testing.assert_allclose(decode_attention_blocked(q, k, v, pos).numpy(),
                               decode_attention_ref(q, k, v, pos).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_padding_helpers_match_reference():
    from repro.kernels import common as jax_common

    for x, m in [(0, 8), (5, 8), (64, 64), (65, 64)]:
        assert round_up(x, m) == jax_common.round_up(x, m)
        assert bucket_len(x, m) == jax_common.bucket_len(x, m)
    a = _rand((2, 5, 3), 30)
    np.testing.assert_array_equal(
        pad_axis(torch.from_numpy(a), 1, 8).numpy(),
        np.asarray(jax_common.pad_axis(jnp.asarray(a), 1, 8)))
