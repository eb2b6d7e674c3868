"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``hopper`` fixture skips every test where no CUDA
device of compute capability ≥ 9.0 is present (decided when the test runs,
never at import, so every pytest worker collects the same tests).  Run on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: attention fp32 rtol 1e-4 / atol 1e-5 (reduction order); bf16
inputs against the fp32 plain version on the same bf16 values at 2e-2, and
element by element within one bf16 ulp of it plus 1e-6
(``common.within_bf16_ulp``): the output's rounding takes half an ulp, and
both kernels carry P into the P·V product as a sum of three bf16 terms,
to 2^-27.  Extend output is bitwise invariant to padded capacity, decode
output to capacity and to the batch.  The int8 dequant kernel must equal its
plain version bitwise (one fp32 multiply, one rounding).  The analytics
kernels keep
``tests/test_kernels.py``'s tolerances (fp32 sums in another order), and two
launches on the same data must agree bitwise (no atomics, fixed order).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.common import enqueued, within_bf16_ulp  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_blocked, decode_attention_split)
from repro_torch.kernels.extend_attention import kernel as extend_kernel  # noqa: E402
from repro_torch.kernels.extend_attention import ops as extend_ops  # noqa: E402
from repro_torch.kernels.extend_attention.ref import extend_attention_ref  # noqa: E402
from repro_torch.kernels.linreg_stats import kernel as linreg_kernel  # noqa: E402
from repro_torch.kernels.linreg_stats import ops as linreg_ops  # noqa: E402
from repro_torch.kernels.linreg_stats.ref import linreg_stats_ref  # noqa: E402
from repro_torch.kernels.logreg_sgd import kernel as logreg_kernel  # noqa: E402
from repro_torch.kernels.logreg_sgd import ops as logreg_ops  # noqa: E402
from repro_torch.kernels.nb_stats import kernel as nb_kernel  # noqa: E402
from repro_torch.kernels.nb_stats import ops as nb_ops  # noqa: E402
from repro_torch.kernels.nb_stats.ref import nb_stats_ref  # noqa: E402
from repro_torch.kernels.quant_kv import kernel as quant_kernel  # noqa: E402
from repro_torch.kernels.quant_kv import ops as quant_ops  # noqa: E402
from repro_torch.kernels.quant_kv.ref import (dequant_blocks_ref,  # noqa: E402
                                              dequantize_leaf_ref)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
#: bf16 decode kernel against the plain form of its own algorithm: a few
#: times the 5.6e-4 an H100 gave at chip_smoke.py's decode shape while P was
#: rounded once to bf16, well below outputs of |out| ~ 0.02-1; the one-ulp
#: check beside it is the tighter one
DECODE_BF16_SPLIT_TOL = (1e-2, 2e-3)


def _assert_within_one_ulp(got, want):
    ok, worst = within_bf16_ulp(got, want)
    assert ok, f"bf16 output strays {worst:.3g}x past one bf16 ulp (+1e-6)"


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,kv,g", [(16, 2, 2), (128, 2, 8), (64, 4, 1), (192, 2, 12),
                                     (64, 20, 1)])
@pytest.mark.parametrize("t_real", [32, 200, 256])
def test_extend_kernel_matches_plain(hopper, dtype, hd, kv, g, t_real):
    b, nb, cap = 2, 32, 256
    q = _randn((b, nb, kv * g, hd), dtype, hopper, 1)
    k = _randn((b, cap, kv, hd), dtype, hopper, 2)
    v = _randn((b, cap, kv, hd), dtype, hopper, 3)
    before = extend_kernel.KERNEL.launches
    out = extend_ops.extend_attention(q, k, v, t_real=t_real)
    torch.cuda.synchronize()
    assert extend_kernel.KERNEL.launches == before + 1
    want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=t_real)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _assert_within_one_ulp(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,t_real", [(1, 1), (1, 300), (100, 100), (100, 511)])
def test_extend_kernel_rows_straddle_heads(hopper, dtype, nb, t_real):
    """A 1-token extend (G rows in one block) and nb 100 at G 8 (G·nb = 800,
    not a multiple of 64: row blocks straddle two heads)."""
    b, kv, g, hd, cap = 2, 2, 8, 128, 512
    q = _randn((b, nb, kv * g, hd), dtype, hopper, 34)
    k = _randn((b, cap, kv, hd), dtype, hopper, 35)
    v = _randn((b, cap, kv, hd), dtype, hopper, 36)
    out = extend_ops.extend_attention(q, k, v, t_real=t_real)
    want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=t_real)
    torch.cuda.synchronize()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _assert_within_one_ulp(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small,big,nb,t_real", [
    (256, 1024, 128, 256), (200, 640, 100, 163), (130, 2176, 1, 97)])
def test_extend_kernel_bit_invariant_to_capacity(hopper, dtype, small, big, nb, t_real):
    """A garbage tail (×100) past t_real at the larger capacity changes no
    bit of the output."""
    b, kv, g, hd = 1, 4, 8, 64
    q = _randn((b, nb, kv * g, hd), dtype, hopper, 37)
    k = _randn((b, small, kv, hd), dtype, hopper, 38)
    v = _randn((b, small, kv, hd), dtype, hopper, 39)
    kb = _randn((b, big, kv, hd), dtype, hopper, 40) * 100
    vb = _randn((b, big, kv, hd), dtype, hopper, 41) * 100
    kb[:, :small], vb[:, :small] = k, v
    small_out = extend_ops.extend_attention(q, k, v, t_real=t_real)
    big_out = extend_ops.extend_attention(q, kb, vb, t_real=t_real)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out)


#: MLA's (nope, rope, v) widths: q·k 192 / v 128 at full width, 24 / 16 reduced
MLA_WIDTHS = pytest.mark.parametrize("nope,rope,hv", [(128, 64, 128), (16, 8, 16)],
                                     ids=["qk192_v128", "qk24_v16"])


def _mla_operands(b, nb, h, t, nope, rope, hv, dtype, device, seed):
    return (_randn((b, nb, h, nope), dtype, device, seed),
            _randn((b, nb, h, rope), dtype, device, seed + 1),
            _randn((b, t, h, nope), dtype, device, seed + 2),
            _randn((b, t, rope), dtype, device, seed + 3),
            _randn((b, t, h, hv), dtype, device, seed + 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@MLA_WIDTHS
@pytest.mark.parametrize("nb,t_real", [(1, 1), (1, 300), (100, 100), (100, 511),
                                       (128, 128), (128, 400)])
def test_extend_kernel_mla_form_matches_plain(hopper, dtype, nope, rope, hv, nb, t_real):
    """``ops.extend_attention_mla`` (packed [nope ‖ rope] q·k, v width ≠ q·k
    width, G 1) launches the kernel once and agrees with the plain version
    on the same packed operands."""
    b, h, cap = 2, 8, 512
    qn, qr, kn, kr, v = _mla_operands(b, nb, h, cap, nope, rope, hv, dtype, hopper, 50)
    before = extend_kernel.KERNEL.launches
    out = extend_ops.extend_attention_mla(qn, qr, kn, kr, v, t_real=t_real)
    torch.cuda.synchronize()
    assert extend_kernel.KERNEL.launches == before + 1
    assert tuple(out.shape) == (b, nb, h, hv) and out.dtype == dtype
    q, k = extend_ops.pack_mla(qn, qr, kn, kr)
    want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=t_real)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _assert_within_one_ulp(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@MLA_WIDTHS
@pytest.mark.parametrize("small,big,nb,t_real", [(256, 1024, 128, 256), (200, 640, 100, 163),
                                                 (130, 2176, 1, 97)])
def test_extend_kernel_mla_form_bit_invariant_to_capacity(hopper, dtype, nope, rope, hv,
                                                          small, big, nb, t_real):
    b, h = 1, 4
    qn, qr, kn, kr, v = _mla_operands(b, nb, h, small, nope, rope, hv, dtype, hopper, 60)
    _, _, knb, krb, vb = _mla_operands(b, nb, h, big, nope, rope, hv, dtype, hopper, 70)
    knb, krb, vb = knb * 100, krb * 100, vb * 100
    knb[:, :small], krb[:, :small], vb[:, :small] = kn, kr, v
    small_out = extend_ops.extend_attention_mla(qn, qr, kn, kr, v, t_real=t_real)
    big_out = extend_ops.extend_attention_mla(qn, qr, knb, krb, vb, t_real=t_real)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out)


# -- nemotron-4-340b's form: hd 192, G 12 --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,t_real", [(1, 1), (1, 300), (100, 100), (100, 511),
                                       (128, 128), (128, 400)])
def test_extend_kernel_hd192_rows_straddle_heads(hopper, dtype, nb, t_real):
    """(q·k 192, v 192) at G 12: nb 100 gives G·nb = 1200 rows, so row blocks
    straddle heads; one launch per call."""
    b, kv, g, hd, cap = 1, 2, 12, 192, 512
    q = _randn((b, nb, kv * g, hd), dtype, hopper, 80)
    k = _randn((b, cap, kv, hd), dtype, hopper, 81)
    v = _randn((b, cap, kv, hd), dtype, hopper, 82)
    before = extend_kernel.KERNEL.launches
    out = extend_ops.extend_attention(q, k, v, t_real=t_real)
    torch.cuda.synchronize()
    assert extend_kernel.KERNEL.launches == before + 1
    want = extend_attention_ref(q.float(), k.float(), v.float(), t_real=t_real)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _assert_within_one_ulp(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small,big,nb,t_real", [
    (256, 1024, 128, 256), (200, 640, 100, 163), (130, 2176, 1, 97)])
def test_extend_kernel_hd192_bit_invariant_to_capacity(hopper, dtype, small, big, nb,
                                                       t_real):
    b, kv, g, hd = 1, 2, 12, 192
    q = _randn((b, nb, kv * g, hd), dtype, hopper, 83)
    k = _randn((b, small, kv, hd), dtype, hopper, 84)
    v = _randn((b, small, kv, hd), dtype, hopper, 85)
    kb = _randn((b, big, kv, hd), dtype, hopper, 86) * 100
    vb = _randn((b, big, kv, hd), dtype, hopper, 87) * 100
    kb[:, :small], vb[:, :small] = k, v
    small_out = extend_ops.extend_attention(q, k, v, t_real=t_real)
    big_out = extend_ops.extend_attention(q, kb, vb, t_real=t_real)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out)


@pytest.mark.parametrize("hqk,hv", [(24, 24), (256, 256), (128, 192), (24, 32), (48, 16)])
def test_extend_kernel_raises_on_an_unbuilt_pair(hopper, hqk, hv):
    q = torch.zeros((1, 4, 4, hqk), device=hopper, dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 4, hqk), device=hopper, dtype=torch.bfloat16)
    v = torch.zeros((1, 64, 4, hv), device=hopper, dtype=torch.bfloat16)
    before = extend_kernel.KERNEL.launches
    with pytest.raises(ValueError, match="not built"):
        extend_ops.extend_attention(q, k, v, t_real=8)
    assert extend_kernel.KERNEL.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,kv,g", [(16, 2, 2), (128, 8, 8), (32, 1, 16), (192, 2, 12),
                                     (64, 20, 1)])
def test_decode_kernel_matches_plain(hopper, dtype, hd, kv, g):
    b, t = 4, 600
    q = _randn((b, 1, kv * g, hd), dtype, hopper, 4)
    k = _randn((b, t, kv, hd), dtype, hopper, 5)
    v = _randn((b, t, kv, hd), dtype, hopper, 6)
    pos = torch.tensor([0, 255, 256, t - 1], dtype=torch.int32, device=hopper)
    before = decode_kernel.KERNEL.launches
    out = decode_ops.decode_attention(q, k, v, pos=pos)
    torch.cuda.synchronize()
    assert decode_kernel.KERNEL.launches == before + 1
    want = decode_attention_blocked(q.float()[:, 0].reshape(b, kv, g, hd),
                                    k.float(), v.float(), pos)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float().reshape(b, kv, g, hd), want,
                               rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _assert_within_one_ulp(out.reshape(b, kv, g, hd), want)


@pytest.mark.parametrize("small,big,pos_list", [
    (256, 2048, [0, 17, 128, 255]),           # one split
    (2048, 8192, [0, 300, 1000, 2047]),       # several splits: the combine
])
def test_decode_kernel_bit_invariant_to_capacity(hopper, small, big, pos_list):
    b, kv, g, hd = 4, 8, 8, 128
    q = _randn((b, 1, kv * g, hd), torch.bfloat16, hopper, 7)
    k = _randn((b, small, kv, hd), torch.bfloat16, hopper, 8)
    v = _randn((b, small, kv, hd), torch.bfloat16, hopper, 9)
    kb = _randn((b, big, kv, hd), torch.bfloat16, hopper, 10) * 100
    vb = _randn((b, big, kv, hd), torch.bfloat16, hopper, 11) * 100
    kb[:, :small], vb[:, :small] = k, v
    pos = torch.tensor(pos_list, dtype=torch.int32, device=hopper)
    small_out = decode_ops.decode_attention(q, k, v, pos=pos)
    big_out = decode_ops.decode_attention(q, kb, vb, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_row_independent_of_batch(hopper, dtype):
    b, kv, g, hd, t = 4, 8, 8, 128, 1100
    q = _randn((b, 1, kv * g, hd), dtype, hopper, 12)
    k = _randn((b, t, kv, hd), dtype, hopper, 13)
    v = _randn((b, t, kv, hd), dtype, hopper, 14)
    pos = torch.tensor([t - 1, 3, 128, 700], dtype=torch.int32, device=hopper)
    batch = decode_ops.decode_attention(q, k, v, pos=pos)
    for r in range(b):
        alone = decode_ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                            pos=pos[r:r + 1])
        torch.cuda.synchronize()
        assert torch.equal(batch[r:r + 1], alone), f"row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small,big,pos_list", [
    (256, 2048, [0, 17, 128, 255]),
    (2048, 8192, [0, 300, 1000, 2047]),
])
def test_decode_kernel_hd192_bit_invariant_to_capacity(hopper, dtype, small, big, pos_list):
    """hd 192, G 12: every column chunk of the CUDA-core path (48 a row, more
    than a warp's lanes) and both N tiles of the tensor-core path."""
    b, kv, g, hd = 4, 2, 12, 192
    q = _randn((b, 1, kv * g, hd), dtype, hopper, 90)
    k = _randn((b, small, kv, hd), dtype, hopper, 91)
    v = _randn((b, small, kv, hd), dtype, hopper, 92)
    kb = _randn((b, big, kv, hd), dtype, hopper, 93) * 100
    vb = _randn((b, big, kv, hd), dtype, hopper, 94) * 100
    kb[:, :small], vb[:, :small] = k, v
    pos = torch.tensor(pos_list, dtype=torch.int32, device=hopper)
    small_out = decode_ops.decode_attention(q, k, v, pos=pos)
    big_out = decode_ops.decode_attention(q, kb, vb, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_hd192_row_independent_of_batch(hopper, dtype):
    b, kv, g, hd, t = 4, 8, 12, 192, 1100
    q = _randn((b, 1, kv * g, hd), dtype, hopper, 95)
    k = _randn((b, t, kv, hd), dtype, hopper, 96)
    v = _randn((b, t, kv, hd), dtype, hopper, 97)
    pos = torch.tensor([t - 1, 3, 128, 700], dtype=torch.int32, device=hopper)
    batch = decode_ops.decode_attention(q, k, v, pos=pos)
    for r in range(b):
        alone = decode_ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                            pos=pos[r:r + 1])
        torch.cuda.synchronize()
        assert torch.equal(batch[r:r + 1], alone), f"row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,kv,g", [(16, 2, 2), (128, 8, 8), (64, 2, 5), (32, 1, 16),
                                     (192, 8, 12)])
def test_decode_kernel_matches_split_algorithm(hopper, dtype, hd, kv, g):
    """The kernel against the plain form of its own split/combine algorithm:
    fp32 at rtol 1e-5 (same splits, another order inside a split), bf16 at
    2e-2, at :data:`DECODE_BF16_SPLIT_TOL` and within one bf16 ulp (P as
    three bf16 terms in the tensor-core product, bf16 output)."""
    b, t = 4, 1300
    q = _randn((b, 1, kv * g, hd), dtype, hopper, 15)
    k = _randn((b, t, kv, hd), dtype, hopper, 16)
    v = _randn((b, t, kv, hd), dtype, hopper, 17)
    pos = torch.tensor([0, 511, 512, t - 1], dtype=torch.int32, device=hopper)
    out = decode_ops.decode_attention(q, k, v, pos=pos)
    want = decode_attention_split(q.float()[:, 0].reshape(b, kv, g, hd),
                                  k.float(), v.float(), pos,
                                  split=decode_kernel.SPLIT)
    torch.cuda.synchronize()
    got = out.float().reshape(b, kv, g, hd)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        for rtol, atol in (TOL[dtype], DECODE_BF16_SPLIT_TOL):
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        _assert_within_one_ulp(got, want)


def test_decode_kernel_capacity_limit(hopper):
    """The largest capacity the combine's shared memory takes launches and
    matches the split algorithm; one split more is refused before launch."""
    kv, g, hd = 1, 2, 16
    cap = decode_kernel.MAX_SPLITS * decode_kernel.SPLIT
    q = _randn((1, 1, kv * g, hd), torch.float32, hopper, 18)
    k = _randn((1, cap, kv, hd), torch.float32, hopper, 19)
    v = _randn((1, cap, kv, hd), torch.float32, hopper, 20)
    pos = torch.tensor([cap - 1], dtype=torch.int32, device=hopper)
    out = decode_ops.decode_attention(q, k, v, pos=pos)
    want = decode_attention_split(q[:, 0].reshape(1, kv, g, hd), k, v, pos,
                                  split=decode_kernel.SPLIT)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.reshape(1, kv, g, hd), want, rtol=1e-5, atol=1e-5)
    big = torch.zeros((1, cap + 1, kv, hd), device=hopper)
    with pytest.raises(ValueError, match="capacity"):
        decode_ops.decode_attention(q, big, big, pos=pos)


def test_wrappers_reject_bad_inputs(hopper):
    q = torch.zeros((1, 4, 4, 48), device=hopper)
    k = torch.zeros((1, 8, 2, 48), device=hopper)
    with pytest.raises(ValueError, match="head dim"):
        extend_ops.extend_attention(q, k, k, t_real=8)
    q = torch.zeros((1, 1, 4, 16), device=hopper, dtype=torch.float16)
    k = torch.zeros((1, 8, 2, 16), device=hopper, dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_ops.decode_attention(q, k, k, pos=torch.zeros(1, dtype=torch.int32))


# -- analytics kernels ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 10, 15, 16, 127, 130])    # narrow: d + 1 <= 16
@pytest.mark.parametrize("n", [1, 3, 64, 513, 2048, 50_000, 70_000])
@pytest.mark.parametrize("lo", [0, 1], ids=["row0", "odd_row"])
def test_linreg_kernel_matches_plain(hopper, dtype, d, n, lo):
    """``lo`` 1: X and y are views from row 1 of their tables, as the
    engine's fetches are (X off a 16-byte boundary, y off 8)."""
    X = _randn((lo + n, d), dtype, hopper, 20)[lo:]
    y = _randn((lo + n,), dtype, hopper, 21)[lo:]
    before = linreg_kernel.KERNEL.launches
    A, B, yty = linreg_ops.linreg_stats(X, y, with_yty=True)
    torch.cuda.synchronize()
    assert linreg_kernel.KERNEL.launches == before + 1
    Ar, Br, ytyr = linreg_stats_ref(X, y)
    rtol = 5e-3 if dtype == torch.bfloat16 else 5e-4
    atol = n * 2e-2 * rtol
    torch.testing.assert_close(A, Ar, rtol=rtol, atol=atol)
    torch.testing.assert_close(B, Br, rtol=rtol, atol=atol)
    torch.testing.assert_close(yty, ytyr, rtol=rtol, atol=atol)
    assert torch.equal(A, A.T)                      # fma(a, b) == fma(b, a)


def test_linreg_kernel_bitwise_repeatable(hopper):
    X = _randn((1_000_003, 10), torch.float32, hopper, 22)
    y = _randn((1_000_003,), torch.float32, hopper, 23)
    first = linreg_ops.linreg_stats(X, y, with_yty=True)
    again = linreg_ops.linreg_stats(X, y, with_yty=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_enqueued_reads_every_operation_of_a_call(hopper):
    """The count the one-launch tests rest on: a CUDA graph of one call holds
    each kernel, copy and memset it enqueued."""
    x = torch.zeros(1024, device=hopper)
    host = torch.ones(1024).pin_memory()

    def three():
        x.add_(1.0)
        x.copy_(host, non_blocking=True)
        x.zero_()

    kinds = enqueued(three)
    assert sum(kinds.values()) == 3 and kinds.get("memcpy") == 1
    assert enqueued(lambda: linreg_ops.zt_z(x[:30].view(3, 10), x[30:33])) == {"kernel": 1}


@pytest.mark.parametrize("n", [3, 50_000, 5_000_000])
def test_linreg_narrow_form_is_one_launch(hopper, n):
    X = _randn((n, 10), torch.float32, hopper, 42)
    y = _randn((n,), torch.float32, hopper, 43)
    before = linreg_kernel.KERNEL.launches
    linreg_ops.zt_z(X, y)
    assert linreg_kernel.KERNEL.launches == before + 1
    assert enqueued(lambda: linreg_ops.zt_z(X, y)) == {"kernel": 1}


@pytest.mark.parametrize("n,lo", [(50_000, 0), (50_000, 1), (5_000_000, 3)])
def test_linreg_ticket_returns_to_zero(hopper, n, lo):
    """100 launches back to back, and launches on two streams interleaved,
    give bitwise the first launch's G: the ticket is reset by every launch
    and each stream has its own."""
    X = _randn((lo + n, 10), torch.float32, hopper, 44)[lo:]
    y = _randn((lo + n,), torch.float32, hopper, 45)[lo:]
    first = linreg_ops.zt_z(X, y)
    runs = [linreg_ops.zt_z(X, y) for _ in range(100)]
    side = torch.cuda.Stream(hopper)
    X2, y2 = X[: n // 2], y[: n // 2]
    half = linreg_ops.zt_z(X2, y2)
    torch.cuda.synchronize()
    mixed = []
    for _ in range(10):
        with torch.cuda.stream(side):
            mixed.append(("side", linreg_ops.zt_z(X2, y2)))
        mixed.append(("main", linreg_ops.zt_z(X, y)))
    torch.cuda.synchronize()
    assert all(torch.equal(G, first) for G in runs)
    for which, G in mixed:
        assert torch.equal(G, half if which == "side" else first), which
    assert torch.equal(first, first.T)


@pytest.mark.parametrize("n_classes", [2, 3, 13])
@pytest.mark.parametrize("d", [5, 64, 129])
@pytest.mark.parametrize("n", [100, 1024, 70_000])
def test_nb_kernel_matches_plain(hopper, n_classes, d, n):
    X = _randn((n, d), torch.float32, hopper, 24)
    g = torch.Generator(device=hopper).manual_seed(25)
    y = torch.randint(0, n_classes, (n,), generator=g, device=hopper, dtype=torch.int32)
    y[::17] = -1                                     # unlabelled rows count nowhere
    before = nb_kernel.KERNEL.launches
    c, S, SS = nb_ops.nb_stats(X, y, n_classes)
    torch.cuda.synchronize()
    assert nb_kernel.KERNEL.launches == before + 1
    cr, Sr, SSr = nb_stats_ref(X, y, n_classes)
    assert torch.equal(c, cr)
    scale = max(1.0, n / 1024)
    torch.testing.assert_close(S, Sr, rtol=1e-4, atol=1e-3 * scale)
    torch.testing.assert_close(SS, SSr, rtol=1e-4, atol=1e-2 * scale)


def test_nb_kernel_bitwise_repeatable_and_class_limit(hopper):
    X = _randn((1_000_003, 10), torch.float32, hopper, 26)
    g = torch.Generator(device=hopper).manual_seed(27)
    y = torch.randint(0, 13, (1_000_003,), generator=g, device=hopper, dtype=torch.int32)
    first = nb_ops.nb_stats(X, y, 13)
    again = nb_ops.nb_stats(X, y, 13)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    with pytest.raises(ValueError, match="classes"):
        nb_ops.nb_stats(X[:10], y[:10], nb_kernel.MAX_CLASSES + 1)


@pytest.mark.parametrize("d", [1, 8, 32, 33, 100])     # z by thread (d <= 32) or warp
@pytest.mark.parametrize("n,batch", [(512, 64), (1000, 50), (4096, 128)])
def test_logreg_kernel_matches_plain(hopper, n, batch, d):
    X = _randn((n, d), torch.float32, hopper, 28)
    y = (_randn((n,), torch.float32, hopper, 29) > 0).float()
    before = logreg_kernel.KERNEL.launches
    w = logreg_ops.logreg_sgd(X, y, lam=1e-3, lr=0.3, batch=batch)
    torch.cuda.synchronize()
    assert logreg_kernel.KERNEL.launches == before + 1
    want = logreg_ops.logreg_sgd(X.cpu(), y.cpu(), lam=1e-3, lr=0.3, batch=batch)
    torch.testing.assert_close(w.cpu(), want, rtol=2e-4, atol=2e-5)


def test_logreg_kernel_batched_and_bitwise_repeatable(hopper):
    X = _randn((37, 1000, 10), torch.float32, hopper, 30)
    y = (_randn((37, 1000), torch.float32, hopper, 31) > 0).float()
    w, b = logreg_ops.logreg_sgd_batched(X, y, batch=64)
    w2, b2 = logreg_ops.logreg_sgd_batched(X, y, batch=64)
    torch.cuda.synchronize()
    assert torch.equal(w, w2) and torch.equal(b, b2)
    for i in (0, 17, 36):
        wi = logreg_ops.logreg_sgd(X[i], y[i], batch=64)
        assert torch.equal(wi[:-1], w[i]) and torch.equal(wi[-1:], b[i])
    with pytest.raises(ValueError, match="shared memory"):
        logreg_ops.logreg_sgd(X[0, :, :1], y[0], batch=60_000)


@pytest.mark.parametrize("n,d", [(50_000, 10), (70_001, 5), (1_000_003, 10), (3_000, 64)])
@pytest.mark.parametrize("lo", [0, 1, 3], ids=["row0", "row1", "row3"])
def test_nb_kernel_one_launch_bitwise_repeatable(hopper, n, d, lo):
    """One launch and one device kernel per call (narrow form at d 5 and 10,
    C 2; wide at d 64), counts exact and S, SS within the plain version's
    tolerance on views from row 0 and odd rows (whose X starts off a 16-byte
    boundary: the staged spans' element heads and tails), and bitwise the
    same G over 20 calls, and with a second stream's calls interleaved
    (each stream has its own ticket)."""
    X = _randn((lo + n, d), torch.float32, hopper, 50)[lo:]
    g = torch.Generator(device=hopper).manual_seed(51)
    y = torch.randint(-1, 2, (lo + n,), generator=g, device=hopper, dtype=torch.int32)[lo:]
    before = nb_kernel.KERNEL.launches
    first = nb_ops.grouped_stats(X, y, 2)
    assert nb_kernel.KERNEL.launches == before + 1
    assert enqueued(lambda: nb_ops.grouped_stats(X, y, 2)) == {"kernel": 1}
    runs = [nb_ops.grouped_stats(X, y, 2) for _ in range(20)]
    side = torch.cuda.Stream(hopper)
    X2, y2 = X[1: n // 2], y[1: n // 2]
    half = nb_ops.grouped_stats(X2, y2, 2)
    torch.cuda.synchronize()
    mixed = []
    for _ in range(10):
        with torch.cuda.stream(side):
            mixed.append(("side", nb_ops.grouped_stats(X2, y2, 2)))
        mixed.append(("main", nb_ops.grouped_stats(X, y, 2)))
    torch.cuda.synchronize()
    assert all(torch.equal(G, first) for G in runs)
    for which, G in mixed:
        assert torch.equal(G, half if which == "side" else first), which
    scale = max(1.0, n / 1024)
    for G, (Xv, yv) in ((first, (X, y)), (half, (X2, y2))):
        cr, Sr, SSr = nb_stats_ref(Xv, yv, 2)
        assert torch.equal(G[:, 0], cr)
        torch.testing.assert_close(G[:, 1:1 + d], Sr, rtol=1e-4, atol=1e-3 * scale)
        torch.testing.assert_close(G[:, 1 + d:], SSr, rtol=1e-4, atol=1e-2 * scale)


def _logreg_data(n, d, device, seed):
    X = _randn((n, d), torch.float32, device, seed)
    y = (_randn((n,), torch.float32, device, seed + 1) > 0).to(torch.int32)
    return X, y


@pytest.mark.parametrize("n,l,batch,d", [
    (3 * 1000 + 17, 1000, 64, 10),     # warp form, ragged last chunk
    (4 * 1000, 1000, 64, 10),          # warp form, whole chunks
    (600, 1000, 64, 10),               # warp form, n < l
    (2 * 512 + 40, 512, 32, 32),       # warp form at its widest d
    (3 * 1000 + 17, 1000, 128, 3),
    (3 * 1000 + 17, 1000, 50, 10),     # block form: batch not a multiple of 32
    (2 * 700 + 9, 700, 64, 40),        # block form: d > 32
])
@pytest.mark.parametrize("lo", [0, 1], ids=["row0", "row1"])
def test_logreg_segment_matches_plain(hopper, n, l, batch, d, lo):
    X, y = _logreg_data(lo + n, d, hopper, 52)
    X, y = X[lo:], y[lo:]
    before = logreg_kernel.KERNEL.launches
    W = logreg_ops.logreg_sgd_segment(X, y, chunk_size=l, lam=1e-3, lr=0.3, batch=batch)
    torch.cuda.synchronize()
    assert logreg_kernel.KERNEL.launches == before + 1
    assert W.shape == (-(-n // l), d + 1)
    want = logreg_ops.logreg_sgd_segment(X.cpu(), y.cpu(), chunk_size=l, lam=1e-3,
                                         lr=0.3, batch=batch)
    torch.testing.assert_close(W.cpu(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("p", [1, 5, 500])
def test_logreg_chunk_alone_equals_chunk_in_segment(hopper, p):
    """A chunk's weights are bitwise the same alone and inside a segment of
    p chunks (plus a ragged tail), from int32 and fp32 labels, and from the
    same rows as a view at row 1 of a table, as a copy at row 0 and as a
    copy 4 bytes past an 8-byte boundary."""
    l, d = 10_000, 10
    n = p * l + 4_321
    X, y = _logreg_data(n + 1, d, hopper, 53)
    word1 = torch.empty(n * d + 1, device=hopper)[1:].view(n, d)
    word1.copy_(X[1:])
    views = {"row1": (X[1:], y[1:]), "row0": (X[1:].clone(), y[1:].clone()),
             "word1": (word1, y[1:])}
    got = {}
    for name, (Xv, yv) in views.items():
        W = logreg_ops.logreg_sgd_segment(Xv, yv, chunk_size=l)
        Wf = logreg_ops.logreg_sgd_segment(Xv, yv.float(), chunk_size=l)
        torch.cuda.synchronize()
        assert torch.equal(W, Wf), name
        for c in sorted({0, p // 2, p - 1, p}):      # chunk p is the ragged tail
            rows = slice(c * l, min((c + 1) * l, n))
            assert torch.equal(logreg_ops.logreg_sgd(Xv[rows], yv[rows]), W[c]), (name, c)
        got[name] = W
    assert torch.equal(got["row0"], got["row1"]) and torch.equal(got["row0"], got["word1"])


def test_engine_on_the_card_plans_like_the_cpu(hopper):
    import numpy as np

    from repro_torch.core.descriptors import Range
    from repro_torch.core.engine import IncrementalAnalyticsEngine
    from repro_torch.data.synthetic import make_classification
    from repro_torch.data.tabular import ArrayBackend

    X, y = make_classification(60_000, d=10, n_classes=2, seed=3)
    plans = {}
    for dev in (hopper, "cpu"):
        eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device=dev))
        eng.warm("gaussian_nb", [Range(0, 20_000), Range(30_000, 50_000)])
        q = eng.query("gaussian_nb", Range(5_000, 45_000))
        plans[str(dev)] = ([(s.rng.lo, s.rng.hi, s.sign, s.model_id) for s in q.plan.steps],
                           q.used_reuse, q.stats)
    (p1, r1, s1), (p2, r2, s2) = plans.values()
    assert p1 == p2 and r1 and r2
    np.testing.assert_allclose(s1.S, s2.S, rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(s1.counts, s2.counts)


# -- int8 KV dequantization --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block", [
    ((2, 1, 24, 3, 16), 8), ((2, 1, 20, 3, 24), 8), ((24, 1, 128, 8, 128), 64),
    ((1, 2, 33, 2, 128), 16), ((3, 1, 17, 24), 4), ((2, 1, 40, 16), 16),
    ((2, 1, 40, 2, 3, 8), 16)])
def test_quant_kv_kernel_matches_plain_bitwise(hopper, shape, block, dtype):
    from repro_torch.core.quant import quantize_leaf

    x = _randn(shape, torch.float32, hopper, 32) * 3
    x[:, :, :block] = 0                            # an all-zero block
    q, s = quantize_leaf(x, block)
    before = quant_kernel.KERNEL.launches
    out = quant_ops.dequantize_leaf(q, s, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert quant_kernel.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = dequantize_leaf_ref(q, s, block=block, dtype=dtype)
    assert torch.equal(out, want)
    cpu = quant_ops.dequantize_leaf(q.cpu(), s.cpu(), block=block, dtype=dtype)
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaves,block", [
    ([(24, 1, 128, 8, 128)] * 2, 64),                      # a full-width segment
    ([(2, 1, 24, 3, 16), (2, 1, 20, 3, 24)], 8),           # vector and scalar leaves
    ([(1, 2, 33, 2, 128), (3, 1, 17, 24), (2, 1, 40, 16), (2, 1, 40, 2, 3, 8),
      (2, 1, 24, 3, 16), (1, 2, 33, 2, 128), (2, 1, 20, 3, 24), (3, 1, 9, 4)], 16),
])
def test_quant_kv_segment_is_one_launch_and_bitwise(hopper, leaves, block, dtype):
    from repro_torch.core.quant import quantize_leaf

    qs = []
    for i, shape in enumerate(leaves):
        x = _randn(shape, torch.float32, hopper, 50 + i) * 3
        x[:, :, :block] = 0                        # an all-zero block
        qs.append(quantize_leaf(x, block))
    before = quant_kernel.KERNEL.launches
    outs = quant_ops.dequantize_leaves(qs, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert quant_kernel.KERNEL.launches == before + 1
    for (q, s), out in zip(qs, outs):
        assert out.dtype == dtype and out.shape == q.shape
        assert out.data_ptr() % 16 == 0
        assert torch.equal(out, dequantize_leaf_ref(q, s, block=block, dtype=dtype))
    assert enqueued(lambda: quant_ops.dequantize_leaves(qs, block=block,
                                                        dtype=dtype)) == {"kernel": 1}


def test_quant_kv_blocks_layout_and_bad_inputs(hopper):
    g = torch.Generator(device=hopper).manual_seed(33)
    q = torch.randint(-127, 128, (6, 8, 16), generator=g, device=hopper).to(torch.int8)
    s = torch.rand((6,), generator=g, device=hopper) + 1e-3
    out = quant_ops.dequantize_blocks(q, s)
    torch.cuda.synchronize()
    assert torch.equal(out, dequant_blocks_ref(q, s))
    with pytest.raises(TypeError):
        quant_ops.dequantize_leaf(q.reshape(6, 1, 8, 16).float(), s.reshape(6, 1, 1),
                                  block=8, dtype=torch.float32)
    with pytest.raises(TypeError, match="output dtype"):
        quant_ops.dequantize_leaf(q.reshape(6, 1, 8, 16), s.reshape(6, 1, 1), block=8,
                                  dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        quant_ops.dequantize_leaf(q.reshape(6, 1, 8, 16)[:, :, ::2], s.reshape(6, 1, 1),
                                  block=8, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        quant_ops.dequantize_leaf(q.reshape(-1)[1:97].reshape(2, 1, 3, 16),
                                  s[:2].reshape(2, 1, 1), block=8, dtype=torch.float32)
