"""The absorbed MLA decode kernel's yardstick (``bench/metrics/
mla_decode_roofline.py``), checked by hand on one small launch, and read
from a traced record as the harness keeps it."""
import pytest

from bench import core, work

metric = core._module(core.BENCH / "metrics" / "mla_decode_roofline.py",
                      "bench_metric_mla_decode_roofline")


def test_work_of_one_small_launch_by_hand():
    # two rows at positions 2 and 0: 3 + 1 positions; H 2, kv_lora 8, rope
    # 4, v 8
    f, n = metric.mla_decode(pos=[2, 0], h=2, kv_lora=8, rope=4, v=8)
    # scores and p.c_kv: 2 heads x (2 x 8 + 4) x 2 a position; W_uv: 2 rows
    # x 2 heads x 8 x 8 x 2
    assert f == 2 * 2 * (2 * 8 + 4) * 4 + 2 * 2 * 2 * 8 * 8 == 832
    # bf16 latents of 4 positions (12 wide), q of 2 rows x 2 heads (12
    # wide), bf16 W_uv 8 x 2 x 8, fp32 output 2 x 2 x 8, int32 pos
    assert n == 2 * 4 * 12 + 2 * 4 * 12 + 2 * 128 + 4 * 32 + 4 * 2 == 584


def test_the_cell_shape_is_bound_by_bytes():
    pos = [2063, 3000, 4100, 5000, 6000, 7000, 8000, 8191]
    f, n = metric.mla_decode(pos=pos, h=128, kv_lora=512, rope=64, v=128)
    assert n / work.HBM_BYTES_PER_S > f / work.PEAK_FLOPS["bf16"]
    assert work.bound_s(f, n, "bf16") * 1e3 == pytest.approx(0.0204, abs=5e-5)


def _rec(pos, *, seen, counted, secs=1e-3):
    call = ([{"shape": (len(pos), 2, 8), "elt": 2}, {"shape": (len(pos), 2, 4), "elt": 2},
             {"shape": (len(pos), 64, 8), "elt": 2}, {"shape": (len(pos), 64, 4), "elt": 2},
             {"shape": (8, 2, 8), "elt": 2}], {"pos": pos, "scale": 0.2})
    ops = {"void (anonymous namespace)::mla_decode_split<__nv_bfloat16, true>(Args)":
           {"s": secs * 0.9, "count": seen},
           "(anonymous namespace)::mla_decode_combine(Args)": {"s": secs * 0.1, "count": seen},
           "void (anonymous namespace)::split_kernel<float, 128>()": {"s": 5.0, "count": 9}}
    return {"launches": {"mla_decode": [call] * counted}, "summary": {"ops": ops},
            "kernel_launches": {"repro_torch.kernels.mla_decode.kernel": counted}}


def test_share_reads_the_launches_and_no_other_kernel():
    got = metric.read(_rec([2, 0], seen=3, counted=3))
    f, n = metric.mla_decode(pos=[2, 0], h=2, kv_lora=8, rope=4, v=8)
    assert got == pytest.approx(100.0 * 3 * work.bound_s(f, n, "bf16") / 1e-3)


def test_a_program_without_the_kernel_reads_nothing():
    rec = _rec([2, 0], seen=0, counted=0)
    rec["launches"] = {}
    assert metric.read(rec) is None


def test_counts_that_disagree_fail_the_run():
    with pytest.raises(RuntimeError):
        metric.read(_rec([2, 0], seen=2, counted=3))
