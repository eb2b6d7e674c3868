"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``hopper`` fixture skips every test where no CUDA
device of compute capability ≥ 9.0 is present (decided when the test runs,
never at import, so every pytest worker collects the same tests).  Run on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: attention fp32 rtol 1e-4 / atol 1e-5 (reduction order); bf16
inputs against the fp32 plain version on the same bf16 values at 2e-2, for
the bf16 rounding of the output.  The analytics kernels keep
``tests/test_kernels.py``'s tolerances (fp32 sums in another order), and two
launches on the same data must agree bitwise (no atomics, fixed order).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_blocked  # noqa: E402
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


# -- analytics kernels ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 10, 15, 16, 127, 130])    # narrow: d + 1 <= 16
@pytest.mark.parametrize("n", [64, 513, 2048, 70_000])
def test_linreg_kernel_matches_plain(hopper, dtype, d, n):
    X = _randn((n, d), dtype, hopper, 20)
    y = _randn((n,), dtype, hopper, 21)
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
