"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``hopper`` fixture skips every test where no CUDA
device of compute capability ≥ 9.0 is present (decided when the test runs,
never at import, so every pytest worker collects the same tests).  Run on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (reduction order); bf16 inputs
against the fp32 plain version on the same bf16 values at 2e-2, for the
bf16 rounding of the output.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_blocked  # noqa: E402
from repro_torch.kernels.extend_attention import kernel as extend_kernel  # noqa: E402
from repro_torch.kernels.extend_attention import ops as extend_ops  # noqa: E402
from repro_torch.kernels.extend_attention.ref import extend_attention_ref  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


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
@pytest.mark.parametrize("hd,kv,g", [(16, 2, 2), (128, 2, 8), (64, 4, 1)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,kv,g", [(16, 2, 2), (128, 8, 8), (32, 1, 16)])
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


def test_decode_kernel_bit_invariant_to_capacity(hopper):
    b, kv, g, hd = 4, 8, 8, 128
    q = _randn((b, 1, kv * g, hd), torch.bfloat16, hopper, 7)
    k = _randn((b, 256, kv, hd), torch.bfloat16, hopper, 8)
    v = _randn((b, 256, kv, hd), torch.bfloat16, hopper, 9)
    kb = _randn((b, 2048, kv, hd), torch.bfloat16, hopper, 10) * 100
    vb = _randn((b, 2048, kv, hd), torch.bfloat16, hopper, 11) * 100
    kb[:, :256], vb[:, :256] = k, v
    pos = torch.tensor([0, 17, 128, 255], dtype=torch.int32, device=hopper)
    small = decode_ops.decode_attention(q, k, v, pos=pos)
    big = decode_ops.decode_attention(q, kb, vb, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(small, big)


def test_wrappers_reject_bad_inputs(hopper):
    q = torch.zeros((1, 4, 4, 48), device=hopper)
    k = torch.zeros((1, 8, 2, 48), device=hopper)
    with pytest.raises(ValueError, match="head dim"):
        extend_ops.extend_attention(q, k, k, t_real=8)
    q = torch.zeros((1, 1, 4, 16), device=hopper, dtype=torch.float16)
    k = torch.zeros((1, 8, 2, 16), device=hopper, dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_ops.decode_attention(q, k, k, pos=torch.zeros(1, dtype=torch.int32))
