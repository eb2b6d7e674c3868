"""The bf16 extend kernel's tile walk in plain PyTorch, on the CPU.

``ref.py::extend_attention_tiled`` is what the CUDA extend kernel computes:
stacked q rows ``r = g·nb + i`` in blocks of 64, online softmaxes over
64-position KV tiles dealt to two interleaved walks that stop at the
block's last visible position and merge in order, and P entering the P·V
product in fp32, once rounded to bf16, or as a sum of two or three bf16
terms (the kernels use three).  In fp32 it must match ``repro``'s Pallas
kernel (interpret mode) at ``tests/test_torch_kernels.py``'s tolerance and
the port's plain version within 1e-6; its output is bitwise the same at any
padded capacity; and on bf16 inputs the three-term form is within one bf16
ulp (+1e-6) of the fp32 plain version, which P rounded once to bf16 is not,
and two terms are not where few positions' P·V cancel near zero.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels.extend_attention import ops as jax_extend  # noqa: E402
from repro_torch.kernels.common import within_bf16_ulp  # noqa: E402
from repro_torch.kernels.extend_attention.ref import (  # noqa: E402
    P_MODES, extend_attention_ref, extend_attention_tiled)

RTOL, ATOL = 1e-4, 1e-5          # tests/test_torch_kernels.py's
KV, CAP = 2, 200


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(b, nb, g, hd, cap, seed):
    return (_rand((b, nb, KV * g, hd), seed), _rand((b, cap, KV, hd), seed + 1),
            _rand((b, cap, KV, hd), seed + 2))


@pytest.mark.parametrize("t_real", ["empty prefix", 130, CAP])
@pytest.mark.parametrize("nb", [1, 32, 100])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 32])
def test_tiled_fp32_matches_jax_kernel(hd, g, nb, t_real):
    """nb 1 (a 1-token extend), 32, and 100 with G·nb not a multiple of 64
    (a row block straddles two heads); t_real from an empty prefix (t_real
    = nb) to the full capacity."""
    t_real = nb if t_real == "empty prefix" else t_real
    q, k, v = _inputs(2, nb, g, hd, CAP, hd + 10 * g + nb)
    want = jax_extend.extend_attention(q, k, v, t_real=t_real, chunk=64,
                                       interpret=True)
    got = extend_attention_tiled(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), t_real=t_real)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p_mode", P_MODES)
@pytest.mark.parametrize("g,nb,t_real", [(4, 100, 150), (1, 1, 77), (8, 16, 200)])
def test_tiled_fp32_matches_plain_version(g, nb, t_real, p_mode):
    """On fp32 inputs the tile walk is the plain version's softmax in
    another order; the bf16 P modes only differ from it by P's rounding."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, nb, g, 16, CAP, 60 + g))
    got = extend_attention_tiled(q, k, v, t_real=t_real, p_mode=p_mode)
    want = extend_attention_ref(q, k, v, t_real=t_real)
    tol = {"fp32": 1e-6, "bf16x3": 1e-6, "bf16x2": 1e-5, "bf16": 1e-2}[p_mode]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_mode", P_MODES)
@pytest.mark.parametrize("small,big,nb,t_real", [
    (200, 640, 100, 200),        # t_real at the small capacity
    (130, 2000, 1, 97),          # a 1-token extend, the last tile ragged
    (256, 300, 64, 192),         # t_real on a tile boundary
])
def test_tiled_bit_invariant_to_capacity(small, big, nb, t_real, p_mode, dtype):
    """A garbage tail (×1e3) past t_real at the larger capacity changes no
    bit: tiles are zero-filled past t_real, as the kernel stages them."""
    b, g, hd = 2, 4, 16
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(b, nb, g, hd, small, 70))
    kb = torch.from_numpy(_rand((b, big, KV, hd), 73, 1e3)).to(dtype)
    vb = torch.from_numpy(_rand((b, big, KV, hd), 74, 1e3)).to(dtype)
    kb[:, :small], vb[:, :small] = k, v
    out_small = extend_attention_tiled(q, k, v, t_real=t_real, p_mode=p_mode)
    out_big = extend_attention_tiled(q, kb, vb, t_real=t_real, p_mode=p_mode)
    assert torch.equal(out_small, out_big)


def _bf16_case(g, hd, nb, cap, t_real):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(1, nb, g, hd, cap, 80))
    want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=t_real)
    return q, k, v, want


@pytest.mark.parametrize("g,hd,nb,cap,t_real", [
    (4, 64, 64, 512, 512), (8, 128, 100, 400, 400),     # long prefixes
    (8, 128, 32, 256, 32), (4, 64, 64, 512, 64),        # empty prefixes
])
def test_three_term_p_within_one_bf16_ulp(g, hd, nb, cap, t_real):
    """bf16 inputs, bf16 output: with P as three bf16 terms every element is
    within one bf16 ulp (+1e-6) of the fp32 plain version on the same bf16
    values; with P rounded once to bf16 (the decode kernel's P before this
    was repaired) some element is not."""
    q, k, v, want = _bf16_case(g, hd, nb, cap, t_real)
    three = extend_attention_tiled(q, k, v, t_real=t_real, p_mode="bf16x3")
    once = extend_attention_tiled(q, k, v, t_real=t_real, p_mode="bf16")
    assert three.dtype == once.dtype == torch.bfloat16
    ok, worst = within_bf16_ulp(three, want)
    assert ok, f"three-term P: error {worst:.3g}x the bound"
    ok, worst = within_bf16_ulp(once, want)
    assert not ok, f"once-rounded P stayed within one ulp ({worst:.3g}x the bound)"


def test_two_term_p_misses_one_ulp_over_few_positions():
    """Two bf16 terms carry P to 2^-18: over an empty prefix (rows attend to
    1..nb positions) some output where P·V cancels near zero strays more
    than 1e-6 past one ulp, which is why the kernels take three.  The shape
    is the card test's where a two-term kernel first missed
    (``test_torch_gpu_kernels.py::test_extend_kernel_matches_plain``, hd 128,
    G 8, nb = t_real = 32)."""
    g, hd, nb, cap = 8, 128, 32, 256
    q, k, v, want = _bf16_case(g, hd, nb, cap, nb)
    two = extend_attention_tiled(q, k, v, t_real=nb, p_mode="bf16x2")
    ok, worst = within_bf16_ulp(two, want)
    assert not ok, f"two-term P stayed within one ulp ({worst:.3g}x the bound)"
