"""The decode step replayed from CUDA graphs over reused pack buffers, on
the card.

Marked ``gpu``; the ``hopper`` fixture skips every test where no CUDA
device of compute capability ≥ 9.0 is present.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_graphs.py

``tests/test_torch_pack_pool.py``'s script (eight sessions, session 0's
short requests regrouping the pack 8 → 7 → 8 over 40 and more decode
calls) runs twice on one reduced model, through ``SessionManager`` with
async prefill: once as it serves, the decode step replayed from graphs,
and once with the step's operations called eagerly on the instance.  The
greedy tokens must be bitwise equal, for GQA attention (``deepseek-67b``),
MLA with MoE (``deepseek-v2-236b``, with the JAX package's router and with
DeepSeek-V2's published one: group-limited, unnormalised scaled gates,
dropless, a held share of the experts, YaRN) and SSD (``mamba2-130m``); a kernel
hook and ``KERNEL.launches`` must read the same calls and counts both ways
(for MLA, one absorbed decode kernel launch a layer a decode call);
a capture must count nothing.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import RopeScaling, get_config, reduced  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import WORK  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.extend_attention import kernel as extend_kernel  # noqa: E402
from repro_torch.kernels.mla_decode import kernel as mla_kernel  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.kv_cache import pad_cache_to  # noqa: E402
from repro_torch.serve.session import SessionManager  # noqa: E402
from test_torch_pack_pool import regroup_script  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda", 0)


#: reduced deepseek-v2-236b under the published router (``_published_v2``)
PUBLISHED_V2 = "deepseek-v2-published"


def _published_v2():
    """Reduced ``deepseek-v2-236b`` (8 experts, top 2) under DeepSeek-V2's
    router: 4 groups of 2, the top 2 groups, gates the scores × 16,
    dropless, holding experts 2..5, with YaRN."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    moe = dataclasses.replace(cfg.moe, topk_method="group_limited_greedy", n_group=4,
                              topk_group=2, norm_topk_prob=False, routed_scaling_factor=16.0,
                              capacity_factor=None, experts_held=(2, 4))
    return dataclasses.replace(cfg, moe=moe, rope_scaling=RopeScaling(
        factor=40.0, original_max_position_embeddings=32, mscale=0.707, mscale_all_dim=0.707))


def _setup(arch, dev):
    cfg = _published_v2() if arch == PUBLISHED_V2 else reduced(get_config(arch))
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, cfg.vocab_size, 160).astype(np.int32) for _ in range(8)]
    return model, params, docs


class _Log:
    """The harness's ``LaunchLog`` in small: each outermost report, small
    integer operands by reference (read after a synchronise), the others
    by shape."""

    def __init__(self) -> None:
        self.seen = []
        self._depth = 0

    def kernel(self, name, work, fn, *args, **kwargs):
        if not self._depth:
            self.seen.append((name, args, kwargs))
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1

    def resolved(self) -> list:
        def r(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.numel() <= 64 and not x.is_floating_point():
                return ("values", x.cpu().tolist())
            return ("shape", tuple(x.shape), x.element_size())
        return [(name, [r(a) for a in args], {k: r(v) for k, v in kw.items()})
                for name, args, kw in self.seen]


def _serve(model, params, docs, *, eager: bool):
    """The script through a fresh manager; (tokens, batches, hook record,
    launches of the three attention kernels, the manager)."""
    mgr = SessionManager(model, params, chunk_tokens=32, decode_bucket=32, max_batch=8,
                         async_prefill=True)
    if eager:
        model.decode_step = lambda p, c, t, s: (model._decode(p, c, t, s), c)
    log = _Log()
    kernels = (decode_kernel.KERNEL, extend_kernel.KERNEL, mla_kernel.KERNEL)
    before = [k.launches for k in kernels]
    WORK.counter = log
    try:
        out, batches = regroup_script(mgr, docs)
    finally:
        WORK.counter = None
        model.__dict__.pop("decode_step", None)
    torch.cuda.synchronize()
    launches = tuple(k.launches - n for k, n in zip(kernels, before))
    return out, batches, log.resolved(), launches, mgr


@pytest.mark.parametrize("arch", ["deepseek-67b", "deepseek-v2-236b", "mamba2-130m",
                                  PUBLISHED_V2])
def test_replayed_steps_stream_as_eager_steps(hopper, arch):
    model, params, docs = _setup(arch, hopper)
    graphs = model.decode_graphs
    got, batches, got_log, got_launches, mgr = _serve(model, params, docs, eager=False)
    replays, captures = graphs.replays, graphs.captures
    want, want_batches, want_log, want_launches, _ = _serve(model, params, docs, eager=True)
    assert (graphs.replays, graphs.captures) == (replays, captures)
    assert got == want
    assert batches == want_batches and len(batches) >= 40
    assert got_log == want_log
    assert got_launches == want_launches
    sc = mgr.sched
    assert sc.decode_replays == replays > len(batches) // 2
    assert sc.decode_captures == captures > 0
    assert sc.pack_reuses > 0
    rep = mgr.report()
    assert rep["decode_graph_hit_share"] == replays / len(batches)
    layers = model.cfg.n_layers
    if arch == "deepseek-67b":
        assert got_launches[0] == layers * len(batches)
        assert [e[0] for e in got_log].count("decode_attention") == layers * len(batches)
    if model.cfg.mla is not None:      # the absorbed decode kernel inside the graphs
        assert got_launches[2] == layers * len(batches)
        assert [e[0] for e in got_log].count("mla_decode") == layers * len(batches)


def test_a_capture_counts_nothing(hopper):
    """A launch while the stream captures is noted for the graph, not
    counted; the graph's replay computes what the eager call does."""
    b, t, kv, g, hd = 2, 256, 2, 4, 64
    gen = torch.Generator(device=hopper).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=hopper).to(torch.bfloat16)
               for shape in ((b, 1, kv * g, hd), (b, t, kv, hd), (b, t, kv, hd)))
    pos = torch.tensor([7, 200], dtype=torch.int32, device=hopper)
    want = decode_ops.decode_attention(q, k, v, pos=pos)
    before = decode_kernel.KERNEL.launches
    noted = {}
    stream = torch.cuda.Stream(device=hopper)
    stream.wait_stream(torch.cuda.current_stream(hopper))
    graph = torch.cuda.CUDAGraph()
    build.CAPTURED.launches = noted
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin()
            out = decode_ops.decode_attention(q, k, v, pos=pos)
            graph.capture_end()
    finally:
        build.CAPTURED.launches = None
    torch.cuda.current_stream(hopper).wait_stream(stream)
    assert decode_kernel.KERNEL.launches == before
    assert noted == {decode_kernel.KERNEL: 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_model_steps_count_once_each(hopper):
    """Three steps over one pack, with a hook: eager (a key's first), then
    captured and replayed, then replayed; each counts the layers' launches
    once, and the hook sees each step's reports once, with its own pos."""
    model, params, docs = _setup("deepseek-67b", hopper)
    layers = model.cfg.n_layers
    caches = model.prefill(params, {"tokens": torch.as_tensor(
        np.stack([docs[0][:40], docs[1][:40]]), device=hopper)})[1]
    caches = pad_cache_to(caches, 64)
    graphs = model.decode_graphs
    log = _Log()
    tokens = torch.tensor([[3], [4]], device=hopper)
    with torch.no_grad():
        for step in range(3):
            pos = torch.tensor([40 + step, 40 + step], dtype=torch.int32, device=hopper)
            before = decode_kernel.KERNEL.launches
            WORK.counter = log
            try:
                model.decode_step(params, caches, tokens, pos)
            finally:
                WORK.counter = None
            torch.cuda.synchronize()
            assert decode_kernel.KERNEL.launches - before == layers
            assert len(log.seen) == layers * (step + 1)
            assert all(kw["pos"] is pos for _, _, kw in log.seen[-layers:])
    assert (graphs.captures, graphs.replays) == (1, 1)
