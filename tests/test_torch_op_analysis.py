"""The port's step cost analysis (``launch/op_analysis.py``) against
``repro``'s HLO analysis and ``torch.utils.flop_counter``.

* ``analyze_hlo``'s closed-form probes (``test_hlo_analysis.py``) hold for
  the counter on the same programs written in torch;
* with no mesh the counter's FLOPs equal ``FlopCounterMode``'s, and for
  every reduced arch's prefill and gradient of ``loss_fn`` (B 2, S 128,
  the cross stacks with their context) they equal ``analyze_hlo``'s on
  ``repro``'s compiled program, but for the SSD gradients: XLA contracts
  the gradient of each decay factor of the chunked scan (``y_off`` and the
  chunk states) over ``p`` in a ``dot``, which torch takes as a product
  and a sum, so ``analyze_hlo`` counts 2 · 2·B·L·h·p = 4·B·S·d_inner more
  per SSD layer, no more and no less;
* each kernel wrapper's formula equals ``FlopCounterMode`` of its plain
  version at two shapes, and under the counter a wrapper counts its
  formula and none of its inner ops;
* a rules context over plain tensors leaves a reduced serving stream and
  training step bitwise unchanged (``constrain``, ``local_region`` and the
  kernel hooks stand aside), and the counter the serving stream;
* in one subprocess, a fake process group of 4 ranks: a (2, 2) trace's
  per-device FLOPs of one sharded product are a quarter of the global
  count, and a ``DTensor`` all-to-all (a CPU mesh's all-gather and chunk)
  is counted as an all-to-all of the operand's bytes.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.distributed.sharding import make_rules, use_rules  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_blocked  # noqa: E402
from repro_torch.kernels.extend_attention import ops as ext  # noqa: E402
from repro_torch.kernels.extend_attention.ref import extend_attention_ref  # noqa: E402
from repro_torch.kernels.linreg_stats import ops as lin  # noqa: E402
from repro_torch.kernels.linreg_stats.ref import linreg_stats_ref, zt_z_ref  # noqa: E402
from repro_torch.kernels.logreg_sgd import ops as lg  # noqa: E402
from repro_torch.kernels.logreg_sgd.ref import sgd_segment_ref  # noqa: E402
from repro_torch.kernels.mla_decode import ops as mla  # noqa: E402
from repro_torch.kernels.mla_decode.ref import mla_decode_plain  # noqa: E402
from repro_torch.kernels.nb_stats import ops as nb  # noqa: E402
from repro_torch.kernels.nb_stats.ref import grouped_stats_ref, nb_stats_ref  # noqa: E402
from repro_torch.kernels.quant_kv import ops as qk  # noqa: E402
from repro_torch.kernels.quant_kv.ref import dequant_blocks_ref, dequantize_leaf_ref  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter, analyze  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map_with_path, tree_unflatten  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
B, S = 2, 128


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flop_counter(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return fc.get_total_flops()


# -- analyze_hlo's closed-form probes -----------------------------------------

def test_scan_trip_counts_exact():
    ws, x = torch.randn(12, 64, 64), torch.randn(8, 64)

    def f():
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return c

    assert analyze(f)["flops"] == 12 * 2 * 8 * 64 * 64


def test_nested_loop_multiplies():
    ws, x = torch.randn(3, 16, 16), torch.randn(4, 16)

    def f():
        c = x
        for _ in range(5):
            for w in ws:
                c = c @ w
        return c

    assert analyze(f)["flops"] == 5 * 3 * 2 * 4 * 16 * 16


def test_unlooped_matmul_and_bytes():
    a, b = torch.randn(32, 64), torch.randn(64, 128)
    res = analyze(lambda: a @ b)
    assert res["flops"] == 2 * 32 * 64 * 128
    assert res["collective_bytes"] == 0.0 and res["collective_by_kind"] == {}
    assert res["op_bytes"] == 2 * 32 * 128 * 4          # 2 × the written result


def test_views_write_nothing_and_top_contributors_name_the_code():
    a, w = torch.randn(8, 32), torch.randn(7, 32, 32)

    def chain():
        c = a
        for i in range(7):
            c = torch.tanh(c @ w[i])                        # w[i]: a view
        return c.T

    with OpCounter() as c:
        chain()
    res = c.result()
    assert res["op_bytes"] == 7 * 2 * (2 * 8 * 32 * 4)     # mm and tanh write; views don't
    top = c.top_contributors(3, "flops")
    assert top[0][0] == 7 * 2 * 8 * 32 * 32 and top[0][3] == 7
    assert top[0][1] == "aten.mm"


# -- the counter against FlopCounterMode and analyze_hlo ---------------------

def _jax_flops(name: str) -> tuple:
    jcfg = jax_reduced(jax_get_config(name))
    jm = JaxLM(jcfg)
    ps = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "targets": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jcfg.encoder_layers:
        batch["enc_feats"] = jax.ShapeDtypeStruct((B, jcfg.encoder_context, jcfg.d_model),
                                                  jnp.float32)
    if jcfg.vision_context:
        batch["image_embeds"] = jax.ShapeDtypeStruct((B, jcfg.vision_context, jcfg.d_model),
                                                     jnp.float32)
    pre = {k: v for k, v in batch.items() if k != "targets"}
    prefill = analyze_hlo(jax.jit(jm.prefill).lower(ps, pre).compile().as_text())["flops"]
    grad = analyze_hlo(jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b)[0]))
                       .lower(ps, batch).compile().as_text())["flops"]
    return prefill, grad


def _port_flops(name: str) -> tuple:
    """The port's prefill and loss_fn gradient on fake tensors: (counter
    prefill, counter gradient, FlopCounterMode gradient)."""
    cfg = reduced(get_config(name))
    model = LM(cfg, device="cpu")
    with FakeTensorMode():
        params = tree_map_with_path(lambda _, s: torch.empty(s.shape), model.specs)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
                 "targets": torch.zeros((B, S), dtype=torch.int32)}
        if cfg.encoder_layers:
            batch["enc_feats"] = torch.zeros((B, cfg.encoder_context, cfg.d_model))
        if cfg.vision_context:
            batch["image_embeds"] = torch.zeros((B, cfg.vision_context, cfg.d_model))
        pre = {k: v for k, v in batch.items() if k != "targets"}
        prefill = analyze(model.prefill, params, pre)["flops"]

        def grad():
            live = [p.detach().requires_grad_() for p in tree_leaves(params)]
            loss, _ = model.loss_fn(tree_unflatten(params, live), batch)
            torch.autograd.grad(loss, live, allow_unused=True)

        g = analyze(grad)["flops"]
        g_fc = flop_counter(grad)
    return prefill, g, g_fc


def ssd_gap(name: str) -> int:
    """FLOPs ``analyze_hlo`` counts in an SSD gradient that torch does not:
    per SSD layer, the gradients of the two decay factors, 2·B·S·d_inner
    each (a ``dot`` over p in XLA; a product and a sum in torch)."""
    cfg = reduced(get_config(name))
    if cfg.ssm is None:
        return 0
    n_ssd = sum(n * sum(ls.mixer == "ssd" for ls in period)
                for period, n in LM(cfg, device="cpu").segments)
    return n_ssd * 2 * 2 * B * S * cfg.ssm.d_inner(cfg.d_model)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_flops_match_analyze_hlo(name):
    j_prefill, j_grad = _jax_flops(name)
    prefill, grad, grad_fc = _port_flops(name)
    assert grad == grad_fc                                  # no mesh: FlopCounterMode's
    assert prefill == j_prefill
    assert j_grad - grad == ssd_gap(name)
    if name in ("mamba2-130m", "jamba-v0.1-52b"):
        assert ssd_gap(name) == {"mamba2-130m": 262_144, "jamba-v0.1-52b": 917_504}[name]


# -- kernel formulas -------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _decode_case(b, t, kv, g, hd, pmax):
    gen = _gen(t)
    q = torch.randn(b, 1, kv * g, hd, generator=gen)
    k, v = torch.randn(b, t, kv, hd, generator=gen), torch.randn(b, t, kv, hd, generator=gen)
    pos = torch.tensor([pmax] + [1] * (b - 1))
    plain = flop_counter(decode_attention_blocked, q[:, 0].reshape(b, kv, g, hd), k, v, pos)
    return plain, dec.decode_work(q, k, v, pos=pos), analyze(dec.decode_attention, q, k, v,
                                                              pos=pos)


def _extend_case(b, nb_, t, kv, g, hd, hdv):
    gen = _gen(nb_)
    q = torch.randn(b, nb_, kv * g, hd, generator=gen)
    k, v = torch.randn(b, t, kv, hd, generator=gen), torch.randn(b, t, kv, hdv, generator=gen)
    return (flop_counter(extend_attention_ref, q, k, v, t_real=t - 7),
            ext.extend_work(q, k, v, t_real=t - 7),
            analyze(ext.extend_attention, q, k, v, t_real=t - 7))


def _mla_decode_case(b, t, h, l, r, v, pmax):
    gen = _gen(t)
    q_lat, q_rope = torch.randn(b, h, l, generator=gen), torch.randn(b, h, r, generator=gen)
    ckv, krope = torch.randn(b, t, l, generator=gen), torch.randn(b, t, r, generator=gen)
    w_uv = torch.randn(l, h, v, generator=gen)
    pos = torch.tensor([pmax] + [1] * (b - 1), dtype=torch.int32)
    args = (q_lat, q_rope, ckv, krope, w_uv)
    return (flop_counter(mla_decode_plain, *args, pos, scale=0.1),
            mla.mla_decode_work(*args, pos=pos, scale=0.1),
            analyze(mla.mla_decode_attention, *args, pos, scale=0.1))


def _quant_case(g, rows, cols):
    gen = _gen(rows)
    q = torch.randint(-127, 128, (g, rows, cols), dtype=torch.int8, generator=gen)
    s = torch.rand(g, generator=gen)
    leaf = torch.randint(-127, 128, (2, 1, 3 * rows, 2, cols), dtype=torch.int8, generator=gen)
    scale = torch.rand(2, 1, 3, generator=gen)
    assert flop_counter(dequantize_leaf_ref, leaf, scale, block=rows, dtype=torch.float32) == 0
    res = analyze(qk.dequantize_leaves, [(leaf, scale)], block=rows, dtype=torch.float32)
    assert res["kernels"]["quant_kv"]["bytes"] == leaf.numel() * 5 + scale.numel() * 4
    return flop_counter(dequant_blocks_ref, q, s), qk.dequant_blocks_work(q, s), analyze(
        qk.dequantize_blocks, q, s)


def _linreg_case(n, d):
    gen = _gen(n)
    X, y = torch.randn(n, d, generator=gen), torch.randn(n, generator=gen)
    assert flop_counter(linreg_stats_ref, X, y) == lin.stats_work(X, y)[0]
    assert analyze(lin.linreg_stats, X, y)["flops"] == lin.stats_work(X, y)[0]
    return flop_counter(zt_z_ref, X, y), lin.stats_work(X, y), analyze(lin.zt_z, X, y)


def _nb_case(n, d):
    gen = _gen(n)
    X = torch.randn(n, d, generator=gen)
    y = torch.randint(0, 3, (n,), dtype=torch.int32, generator=gen)
    assert flop_counter(nb_stats_ref, X, y, 3) == nb.grouped_work(X, y, 3)[0]
    assert analyze(nb.nb_stats, X, y, 3)["flops"] == nb.grouped_work(X, y, 3)[0]
    return flop_counter(grouped_stats_ref, X, y, 3), nb.grouped_work(X, y, 3), analyze(
        nb.grouped_stats, X, y, 3)


def _logreg_case(n, d):
    gen = _gen(n)
    X = torch.randn(n, d, generator=gen)
    y = (torch.randn(n, generator=gen) > 0).float()
    kw = dict(chunk_size=300, lam=1e-3, lr=0.5, batch=64)
    return (flop_counter(sgd_segment_ref, X, y, **kw), lg.segment_work(X, y, **kw),
            analyze(lg.logreg_sgd_segment, X, y, **kw))


KERNEL_CASES = {
    "decode_attention": (_decode_case, [(2, 600, 2, 3, 16, 300), (3, 256, 1, 4, 32, 17)]),
    "extend_attention": (_extend_case, [(2, 8, 64, 2, 2, 16, 16), (1, 16, 96, 1, 4, 24, 16)]),
    "mla_decode": (_mla_decode_case, [(2, 40, 4, 16, 8, 16, 30), (3, 64, 8, 32, 16, 8, 5)]),
    "quant_kv": (_quant_case, [(3, 16, 8), (2, 32, 64)]),
    "linreg_stats": (_linreg_case, [(1000, 7), (4096, 10)]),
    "nb_stats": (_nb_case, [(1000, 7), (4096, 10)]),
    "logreg_sgd": (_logreg_case, [(1000, 7), (4096, 10)]),
}


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_formula_is_the_plain_versions_count(kernel, case):
    make, shapes = KERNEL_CASES[kernel]
    plain, (flops, nbytes), res = make(*shapes[case])
    assert flops == plain
    assert nbytes > 0
    assert res["flops"] == flops                          # the formula, no inner op
    assert res["kernels"] == {kernel: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert res["op_bytes"] == 2 * nbytes


def test_serving_step_counts_kernels_as_flop_counter_counts_plain_versions():
    """A reduced prefill, extend chunk and decode step on CPU tensors: the
    counter's FLOPs (kernel formulas) equal FlopCounterMode's (their plain
    versions' products), with one extend and decode call a layer."""
    cfg = reduced(get_config("deepseek-67b"))
    model = LM(cfg, device="cpu")
    params = model.init(_gen(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32))
    _, caches = model.prefill(params, {"tokens": toks[:, :16]})
    caches = tree_map_with_path(
        lambda _, x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 48)), caches)

    def steps(c):
        model.prefill_extend(params, c, toks[:, 16:24], 16)
        model.decode_step(params, c, toks[:, :1], torch.tensor([24, 24], dtype=torch.int32))

    fc = flop_counter(steps, tree_map_with_path(lambda _, x: x.clone(), caches))
    res = analyze(steps, tree_map_with_path(lambda _, x: x.clone(), caches))
    assert res["flops"] == fc
    layers = cfg.n_layers
    assert res["kernels"]["extend_attention"]["calls"] == layers
    assert res["kernels"]["decode_attention"]["calls"] == layers


def test_hooks_leave_serving_and_training_bitwise():
    """A reduced serving stream (prefill, extend, decode) and a training
    step give bitwise the same inside a rules context over plain tensors
    (where ``constrain``, ``local_region`` and the kernel hooks stand
    aside) as outside one; with the counter on, the serving stream too.
    (The counter decomposes ops the FLOP table lacks, as
    ``FlopCounterMode`` does, which may round a backward pass otherwise.)"""
    from test_torch_sharding import FakeMesh

    cfg = reduced(get_config("deepseek-v2-236b"))
    model = LM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32))

    def run():
        params = model.init(_gen(3))
        logits, caches = model.prefill(params, {"tokens": toks[:, :16]})
        caches = tree_map_with_path(
            lambda _, x: torch.nn.functional.pad(x, (0,) * (2 * (x.ndim - 3)) + (0, 48)),
            caches)
        l2, _ = model.prefill_extend(params, caches, toks[:, 16:24], 16)
        l3, _ = model.decode_step(params, caches, toks[:, 24:25],
                                  torch.tensor([24, 24], dtype=torch.int32))
        step, opt = make_train_step(model, make_optimizer("adamw"), microbatches=2)
        state = opt.init(params)
        batch = {"tokens": toks[:, :24], "targets": toks[:, 1:25]}
        params, state, met = step(params, state, batch, 0)
        return [logits, l2, l3, met["loss"], met["grad_norm"]] + tree_leaves(params) \
            + tree_leaves(state)

    want = run()
    with OpCounter():
        counted = run()
    with use_rules(make_rules(), FakeMesh()):
        ruled = run()
    for a, c in zip(want, ruled):
        assert torch.equal(a, c)
    for a, b in zip(want[:3], counted[:3]):
        assert torch.equal(a, b)


# -- per device and collectives, on a fake process group --------------------------

SCRIPT = textwrap.dedent("""
    import json, logging, sys
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.common import make_struct

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    with FakeTensorMode():
        a = make_struct((256, 4096), torch.float32, (mesh, (Shard(0), Replicate())), "cpu")
        b = make_struct((4096, 8192), torch.float32, (mesh, (Replicate(), Shard(1))), "cpu")
        with OpCounter() as c:
            y = a @ b
        out["product"] = [c.result()["flops"], 2 * 256 * 4096 * 8192,
                          list(y._local_tensor.shape)]
        x = make_struct((8, 16, 32), torch.float32, (mesh, (Shard(0), Replicate())), "cpu")
        with OpCounter() as c:
            z = x.redistribute(mesh, (Shard(1), Replicate()))
        r = c.result()
        out["a2a"] = [r["collective_by_kind"], r["collective_count"],
                      x._local_tensor.numel() * 4, list(z._local_tensor.shape)]
        with OpCounter() as c:
            x.redistribute(mesh, (Replicate(), Replicate()))
            s = make_struct((8, 16), torch.float32, (mesh, (Replicate(), Replicate())), "cpu")
            torch.ops._c10d_functional.wait_tensor(torch.ops._c10d_functional.all_reduce(
                s._local_tensor, "sum", mesh.get_group("model").group_name))
        r = c.result()
        out["gather_reduce"] = [r["collective_by_kind"], x._local_tensor.numel() * 4 * 2,
                                8 * 16 * 4 * 2]
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def fake_group_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("op_analysis") / "out.json"
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                          env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


def test_sharded_product_counts_one_devices_share(fake_group_results):
    flops, global_flops, local = fake_group_results["product"]
    assert flops * 4 == global_flops
    assert local == [128, 4096]


def test_census_counts_an_all_to_all_as_one(fake_group_results):
    by_kind, count, operand, local = fake_group_results["a2a"]
    assert by_kind == {"all-to-all": operand} and count == {"all-to-all": 1}
    assert local == [8, 8, 32]


def test_census_all_gather_and_all_reduce(fake_group_results):
    by_kind, gathered, reduced_bytes = fake_group_results["gather_reduce"]
    assert by_kind == {"all-gather": gathered, "all-reduce": reduced_bytes}
