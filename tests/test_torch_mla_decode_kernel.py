"""MLA's absorbed decode kernel (``kernels/mla_decode``) and its plain
version.

On the CPU: the plain version (``ref.py::mla_decode_plain``) and the model's
absorbed decode through it are bitwise the arithmetic the model ran before
the kernel (written out below as ``_former_decode``), in fp32 and bf16, at
the reduced DeepSeek-V2 widths with ragged positions; the wrapper sends CPU
tensors to the plain version and reports one call to the kernel hook; the
CUDA wrapper refuses what the kernel does not take before it touches a
card; the serving report counts what the route reads.

Marked ``gpu`` (the ``hopper`` fixture skips them where no CUDA device of
compute capability ≥ 9.0 is present, decided when the test runs): the
kernel against the plain version on the card at DeepSeek-V2's widths (H
128, kv_lora 512, rope 64, v 128, YaRN's gain in q) and at the reduced
ones, on the output after ``W_uv`` (the kernel keeps ``o_lat`` inside).
Tolerance: the kernel computes the plain version's products exactly (bf16
operands, fp32 accumulation; P as three bf16 terms, to 2^-27; ``W_uv``
widened exactly to fp32) and sums them in another order, so
``|got − want| ≤ 1e-5 · max |want|``.  Its output is
bitwise invariant to the padded capacity and to the batch.  Run on the card
with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mla_decode_kernel.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import RopeScaling, get_config, reduced  # noqa: E402
from repro_torch.kernels.common import WORK  # noqa: E402
from repro_torch.kernels.mla_decode import kernel as mla_kernel  # noqa: E402
from repro_torch.kernels.mla_decode import ops as mla_ops  # noqa: E402
from repro_torch.kernels.mla_decode.ref import mla_decode_plain  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.common import yarn_softmax_gain  # noqa: E402

NEG_INF = -1e30


def _former_decode(q_nope, q_rope, c_new, kr_new, cache_ckv, cache_krope, pos, w_uk, w_uv, *,
                   scale):
    """The model's absorbed decode before the kernel, verbatim."""
    b = q_nope.shape[0]
    t = cache_ckv.shape[1]
    rows = torch.arange(b, device=cache_ckv.device)
    cache_ckv[rows, pos.long()] = c_new[:, 0].to(cache_ckv.dtype)
    cache_krope[rows, pos.long()] = kr_new[:, 0].to(cache_krope.dtype)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    sc = torch.einsum("bhl,btl->bht", q_lat.float(), cache_ckv.float())
    sc = sc + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(), cache_krope.float())
    sc = sc * scale
    valid = torch.arange(t, device=sc.device)[None] <= pos[:, None]
    sc = torch.where(valid[:, None, :], sc, NEG_INF)
    prob = torch.softmax(sc, dim=-1)
    o_lat = torch.einsum("bht,btl->bhl", prob, cache_ckv.float())
    return torch.einsum("bhl,lhv->bhv", o_lat, w_uv.float())


def _reduced_operands(dtype, pos, cap=40, seed=0):
    cfg = reduced(get_config("deepseek-v2-236b"))
    m, h = cfg.mla, cfg.n_heads
    b = len(pos)
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    ops = dict(q_nope=r(b, 1, h, m.qk_nope_head_dim), q_rope=r(b, 1, h, m.qk_rope_head_dim),
               c_new=r(b, 1, m.kv_lora_rank), kr_new=r(b, 1, m.qk_rope_head_dim),
               cache_ckv=r(b, cap, m.kv_lora_rank), cache_krope=r(b, cap, m.qk_rope_head_dim),
               pos=torch.tensor(pos, dtype=torch.int32),
               w_uk=r(m.kv_lora_rank, h, m.qk_nope_head_dim),
               w_uv=r(m.kv_lora_rank, h, m.v_head_dim))
    return ops, (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


RAGGED = [[0], [39], [3, 39, 0, 17]]


@pytest.mark.parametrize("pos", RAGGED, ids=["pos0", "last", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_version_is_the_former_arithmetic_bitwise(dtype, pos):
    ops, scale = _reduced_operands(dtype, pos)
    want_caches = (ops["cache_ckv"].clone(), ops["cache_krope"].clone())
    want = _former_decode(**{**ops, "cache_ckv": want_caches[0],
                                       "cache_krope": want_caches[1]}, scale=scale)
    got = mla._decode_plain(**ops, scale=scale)
    assert torch.equal(got, want)
    assert torch.equal(ops["cache_ckv"], want_caches[0])
    assert torch.equal(ops["cache_krope"], want_caches[1])
    q_lat = torch.einsum("bhd,lhd->bhl", ops["q_nope"][:, 0], ops["w_uk"])
    out = mla_decode_plain(q_lat, ops["q_rope"][:, 0], ops["cache_ckv"], ops["cache_krope"],
                           ops["w_uv"], ops["pos"], scale=scale)
    assert out.dtype == torch.float32 and torch.equal(out, want)


class _Hook:
    def __init__(self) -> None:
        self.calls = []

    def kernel(self, name, work, fn, *args, **kwargs):
        self.calls.append((name, work(*args, **kwargs)))
        return fn(*args, **kwargs)


def test_wrapper_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    def no_card(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(mla_ops, "mla_decode_cuda", no_card)
    ops, scale = _reduced_operands(torch.bfloat16, [3, 39])
    q_lat = torch.einsum("bhd,lhd->bhl", ops["q_nope"][:, 0], ops["w_uk"])
    args = (q_lat, ops["q_rope"][:, 0], ops["cache_ckv"], ops["cache_krope"], ops["w_uv"],
            ops["pos"])
    want = mla_decode_plain(*args, scale=scale)
    assert torch.equal(mla_ops.mla_decode_attention(*args, scale=scale), want)
    hook = _Hook()
    monkeypatch.setattr(WORK, "counter", hook, raising=False)
    assert torch.equal(mla_ops.mla_decode_attention(*args, scale=scale), want)
    (name, (flops, nbytes)), = hook.calls
    b, h, l = q_lat.shape
    r, t, v = ops["q_rope"].shape[-1], ops["cache_ckv"].shape[1], ops["w_uv"].shape[-1]
    assert name == "mla_decode"
    # the plain version's capacity, and W_uv
    assert flops == 2 * h * (2 * l + r) * b * t + 2 * b * h * l * v
    assert nbytes == 2 * (b * h * (l + r) + b * t * (l + r) + l * h * v) + 4 * b + 4 * b * h * v


def _cuda_args(**change):
    b, h, t, l, r, v = 2, 4, 40, 16, 8, 16
    args = dict(q_lat=torch.zeros(b, h, l, dtype=torch.bfloat16),
                q_rope=torch.zeros(b, h, r, dtype=torch.bfloat16),
                cache_ckv=torch.zeros(b, t, l, dtype=torch.bfloat16),
                cache_krope=torch.zeros(b, t, r, dtype=torch.bfloat16),
                w_uv=torch.zeros(l, h, v, dtype=torch.bfloat16),
                pos=torch.zeros(b, dtype=torch.int32))
    args.update(change)
    return args


REFUSED = {
    "fp16": (TypeError, dict(q_lat=torch.zeros(2, 4, 16, dtype=torch.float16))),
    "mixed-dtypes": (TypeError, dict(cache_krope=torch.zeros(2, 40, 8))),
    "q-batch": (ValueError, dict(q_lat=torch.zeros(3, 4, 16, dtype=torch.bfloat16))),
    "latent-width": (ValueError, dict(cache_ckv=torch.zeros(2, 40, 24, dtype=torch.bfloat16))),
    "rope-capacity": (ValueError, dict(cache_krope=torch.zeros(2, 41, 8, dtype=torch.bfloat16))),
    "not-3d": (ValueError, dict(q_rope=torch.zeros(2, 1, 4, 8, dtype=torch.bfloat16))),
    "odd-width": (ValueError, dict(q_rope=torch.zeros(2, 4, 4, dtype=torch.bfloat16),
                                   cache_krope=torch.zeros(2, 40, 4, dtype=torch.bfloat16))),
    "strided-cache": (ValueError, dict(
        cache_ckv=torch.zeros(2, 80, 16, dtype=torch.bfloat16)[:, ::2])),
    "w_uv-heads": (ValueError, dict(w_uv=torch.zeros(16, 2, 16, dtype=torch.bfloat16))),
    "w_uv-width": (ValueError, dict(w_uv=torch.zeros(16, 4, 12, dtype=torch.bfloat16))),
    "w_uv-dtype": (TypeError, dict(w_uv=torch.zeros(16, 4, 16))),
    "pos-int64": (TypeError, dict(pos=torch.zeros(2, dtype=torch.int64))),
    "pos-shape": (TypeError, dict(pos=torch.zeros(3, dtype=torch.int32))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_cuda_wrapper_refuses_before_the_card(case):
    exc, change = REFUSED[case]
    before = mla_kernel.KERNEL.launches
    with pytest.raises(exc):
        mla_kernel.mla_decode_cuda(**_cuda_args(**change), scale=0.1)
    assert mla_kernel.KERNEL.launches == before


def test_positions_read_in_whole_splits():
    split = mla_kernel.SPLIT
    assert split == 256
    live = [1, 256, 257, 8256]
    assert mla_ops.positions_read(live, 8256, kernel=True) == 256 + 256 + 512 + 8256
    assert mla_ops.positions_read(live, 8256, kernel=False) == 4 * 8256
    assert mla_ops.positions_read([200], 160, kernel=True) == 160       # capped


def test_report_counts_what_the_route_reads(monkeypatch):
    """On the CPU the report counts the capacity and names the route
    "dense"; on a CUDA device it counts whole splits of each row's own
    positions (the formula, applied to a CPU manager whose route is set)."""
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager

    cfg = reduced(get_config("deepseek-v2-236b"))
    model = LM(cfg, device="cpu")
    mgr = SessionManager(model, model.init(torch.Generator().manual_seed(0)))
    m = cfg.mla
    per_pos = 2.0 * cfg.n_heads * (2 * m.kv_lora_rank + m.qk_rope_head_dim) * cfg.n_layers
    assert mgr.decode_mode == "dense"
    assert mgr._decode_attn_flops([61, 600], 640) == per_pos * 2 * 640
    monkeypatch.setattr(mgr, "_mla_kernel", True)
    assert mgr._decode_attn_flops([61, 600], 640) == per_pos * (256 + 640)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda", 0)


#: DeepSeek-V2's published YaRN (factor 40, mscale 0.707 both): its softmax
#: gain, folded into q as the model does
GAIN = yarn_softmax_gain(RopeScaling(factor=40.0, original_max_position_embeddings=4096,
                                     mscale=0.707, mscale_all_dim=0.707))
CAP = 8256


def _card_operands(dev, pos, *, cap=CAP, h=128, l=512, r=64, nope=128, v=128,
                   dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(pos)

    def rn(*shape, gain=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * gain).to(dtype)

    return (rn(b, h, l, gain=GAIN), rn(b, h, r, gain=GAIN), rn(b, cap, l), rn(b, cap, r),
            rn(l, h, v, gain=l ** -0.5), torch.tensor(pos, dtype=torch.int32, device=dev),
            (nope + r) ** -0.5)


def _normwise(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


POS_CASES = {"B1-pos0": [0], "B1-split-last": [255], "B1-split-first": [256],
             "B1-last": [CAP - 1],
             "B8": [0, 255, 256, 2047, 5000, 8191, CAP - 1, 4100]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(POS_CASES))
def test_kernel_matches_plain_at_dsv2_widths(hopper, case):
    *args, scale = _card_operands(hopper, POS_CASES[case])
    before = mla_kernel.KERNEL.launches
    got = mla_ops.mla_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    assert mla_kernel.KERNEL.launches == before + 1
    want = mla_decode_plain(*args, scale=scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _normwise(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("widths", [(4, 16, 8, 16, 16), (16, 512, 64, 128, 128)],
                         ids=["reduced", "full-width-16-heads"])
def test_kernel_matches_plain_on_the_cuda_cores_and_odd_heads(hopper, dtype, widths):
    h, l, r, nope, v = widths
    if dtype == torch.bfloat16 and l == 512:
        h = 80                    # the tensor cores, with a half-empty head block
    *args, scale = _card_operands(hopper, [0, 300, 700], cap=704, h=h, l=l, r=r, nope=nope,
                                  v=v, dtype=dtype)
    got = mla_ops.mla_decode_attention(*args, scale=scale)
    want = mla_decode_plain(*args, scale=scale)
    assert _normwise(got, want) <= 1e-5


@pytest.mark.gpu
def test_output_bitwise_invariant_to_capacity_and_batch(hopper):
    pos = [0, 255, 256, 2047, 3000, 4095, 4159, 1000]
    q_lat, q_rope, ckv, krope, w_uv, p, scale = _card_operands(hopper, pos)
    big = mla_ops.mla_decode_attention(q_lat, q_rope, ckv, krope, w_uv, p, scale=scale)
    small = mla_ops.mla_decode_attention(q_lat, q_rope, ckv[:, :4160].contiguous(),
                                         krope[:, :4160].contiguous(), w_uv, p, scale=scale)
    assert torch.equal(big, small)
    row = 4
    alone = mla_ops.mla_decode_attention(q_lat[row:row + 1], q_rope[row:row + 1],
                                         ckv[row:row + 1], krope[row:row + 1], w_uv,
                                         p[row:row + 1], scale=scale)
    assert torch.equal(alone[0], big[row])


@pytest.mark.gpu
def test_one_call_enqueues_its_two_kernels(hopper):
    from repro_torch.kernels.common import enqueued

    *args, scale = _card_operands(hopper, [100, 5000])
    assert enqueued(lambda: mla_ops.mla_decode_attention(*args, scale=scale)) == {"kernel": 2}


@pytest.mark.gpu
def test_report_counts_positions_read_on_the_card(hopper):
    """A pack of a 600-token and a 64-token session: the report names the
    kernel route and counts each row's whole splits, below the capacity
    that the plain version reads; one launch a layer a decode call."""
    from repro_torch.kernels.mla_decode.ops import positions_read
    from repro_torch.models.lm import LM
    from repro_torch.serve.session import SessionManager

    cfg = reduced(get_config("deepseek-v2-236b"))
    model = LM(cfg, device=hopper)
    params = model.init(torch.Generator(device=hopper).manual_seed(0))
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (600, 64)]
    mgr = SessionManager(model, params, chunk_tokens=64, decode_bucket=64, max_batch=8,
                         async_prefill=False)
    rows = []
    orig = mgr._decode_attn_flops

    def spy(live, cap):
        rows.append((list(live), cap))
        return orig(live, cap)

    mgr._decode_attn_flops = spy
    before = mla_kernel.KERNEL.launches
    for doc in docs:
        mgr.submit(mgr.add_session(doc), len(doc), 3)
    mgr.run()
    torch.cuda.synchronize()
    m = cfg.mla
    per_pos = 2.0 * cfg.n_heads * (2 * m.kv_lora_rank + m.qk_rope_head_dim) * cfg.n_layers
    want = sum(per_pos * positions_read(live, cap, kernel=True) for live, cap in rows)
    dense = sum(per_pos * cap * len(live) for live, cap in rows)
    assert mgr.decode_mode == "kernel"
    assert any(len(live) == 2 for live, _ in rows)
    assert mgr.sched.decode_attn_flops == want < dense
    assert mla_kernel.KERNEL.launches - before == cfg.n_layers * mgr.sched.decode_calls
