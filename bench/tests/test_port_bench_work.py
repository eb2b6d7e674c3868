"""The yardstick's operations and bytes reproduce the kernel table's
bounds at the same shapes."""
import pytest

from bench import work


def test_extend_bound_b1_kv8_g8_nb128_t4096():
    f, b = work.extend_attention(b=1, nb=128, h=64, kv=8, hd=128, hd_v=128, t_real=4096)
    assert work.bound_s(f, b, "bf16") * 1e3 == pytest.approx(0.0171, abs=5e-5)
    assert f / work.PEAK_FLOPS["bf16"] > b / work.HBM_BYTES_PER_S   # operations bound it


def test_decode_bound_on_phase9_pack():
    # phase 9's round-2 pack: eight rows at these prefixes, one query each
    prefixes = [1024, 4112, 2048, 3072, 1024, 2048, 512, 4112]
    f, b = work.decode_attention(pos=prefixes, h=64, kv=8, hd=128, hd_v=128)
    assert work.bound_s(f, b, "bf16") * 1e3 == pytest.approx(0.0220, abs=5e-5)
    assert b / work.HBM_BYTES_PER_S > f / work.PEAK_FLOPS["bf16"]   # bytes bound it


def test_linreg_stats_bound_5m_by_10():
    f, b = work.linreg_stats(n=5_000_000, d=10)
    assert work.bound_s(f, b, "fp32") * 1e3 == pytest.approx(0.0657, abs=5e-5)


def test_nb_and_logreg_read_the_table_once():
    assert work.nb_stats(n=50_000, d=10, classes=2)[1] == 50_000 * 44 + 4 * 2 * 21
    f, b = work.logreg_sgd(n=50_000, d=10, chunk=10_000)
    assert f == 4.0 * 50_000 * 10 and b == 50_000 * 44 + 5 * 11 * 4


def test_model_flops_of_the_configuration():
    per = work.layer_weights(d=8192, h=64, kv=8, hd=128, ff=22016)
    params = 24 * per + 2 * 102400 * 8192 + 24 * 2 * 8192 + 8192
    assert params / 1e9 == pytest.approx(18.29, abs=0.01)
    dims = dict(layers=24, d=8192, h=64, kv=8, hd=128, ff=22016, vocab=102400)
    one = work.lm_span_flops(**dims, start=100, n=1)
    assert one == pytest.approx(24 * (2 * per + 4 * 64 * 128 * 101) + 2 * 8192 * 102400)
    # a span is its tokens one by one, with the head once
    many = work.lm_span_flops(**dims, start=100, n=3)
    each = sum(work.lm_span_flops(**dims, start=100 + i, n=1) for i in range(3))
    assert many == pytest.approx(each - 2 * 2 * 8192 * 102400)
