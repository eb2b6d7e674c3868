"""The multipod step with tensor parallelism against ``repro``'s.

One module-scoped run of each side, every test only reading what they wrote,
both on a (2, 1, 2) ``pod`` × ``data`` × ``model`` mesh:

* ``repro`` in one subprocess on 4 virtual CPU devices:
  ``compressed_psum`` under ``jax.vmap(axis_name="pod")`` and
  ``ef_compress`` on per-pod inputs, and its jitted multipod step (GSPMD
  over ``data`` and ``model`` inside a ``shard_map`` over ``pod``) for 3
  steps compressed and not (reduced ``qwen3-32b``, 2 microbatches, batch
  8 × 32 of ``test_multipod.py``'s tokens, ``warmup_cosine(3e-3, 5,
  100)``), and 2 compressed steps of reduced ``mixtral-8x7b``;
* the port in 4 gloo processes (one ``torch.multiprocessing.spawn``, a
  ``file://`` rendezvous under ``tmp_path``): the step's exchange
  (``compressed_mean`` of each leaf's shard) on ``DTensor`` leaves laid
  out ``Shard`` over ``model``, ``Shard`` over ``data`` (FSDP) and
  ``Replicate``, counted by ``OpCounter``; the same
  steps from the same parameters, laid out by ``make_rules(multi_pod=True,
  fsdp=True)`` without ``pod`` on the ``data`` × ``model`` sub-mesh,
  carried on to ``test_multipod.py``'s 25-step contract; and a plain
  parameter tree on the same mesh, which the step refuses.
"""
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
STEPS = 3
CONTRACT_STEPS = 25
# fp32 on the CPU, XLA against torch (the training tests' tolerances): the loss per step,
# and the parameters after the steps, ‖port − repro‖ / ‖repro − before‖ per leaf
LOSS_ATOL = 1e-5
STEP_NORMWISE = 2e-3
#: the exchange's leaves: shape and layout on the (data, model) sub-mesh
LEAVES = {"cols": ((16, 24), "model"), "rows": ((40, 6), "data"), "rep": ((40,), None),
          "zero": ((8, 4), "model")}

REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.models.lm import LM
    from repro.distributed.compression import compressed_psum, ef_compress
    from repro.distributed.multipod import make_multipod_train_step, ef_init
    from repro.train.optim import make_optimizer, warmup_cosine

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    g, e = inp["exchange"]
    codec = {k: jax.vmap(ef_compress)(g[k], e[k]) for k in g}
    out["q"] = {k: np.asarray(c[0]) for k, c in codec.items()}
    out["scale"] = {k: np.asarray(c[1]) for k, c in codec.items()}
    out["mean"], out["new_ef"] = jax.tree.map(np.asarray, jax.vmap(
        lambda g, e: compressed_psum(g, e, "pod"), axis_name="pod")(g, e))

    def run(arch, compress, steps):
        mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"))
        m = LM(reduced(get_config(arch)).replace(train_microbatches=2))
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        opt = make_optimizer("adamw")
        step, _ = make_multipod_train_step(m, mesh, opt, microbatches=2, compress=compress,
                                           schedule=warmup_cosine(3e-3, 5, 100))
        state, ef, losses, norms = opt.init(params), ef_init(params), [], []
        with mesh:
            jstep = jax.jit(step)
            for i in range(steps):
                params, state, ef, met = jstep(params, state, ef, inp["batch"], jnp.int32(i))
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
        return losses, norms, [np.asarray(x) for x in jax.tree.leaves(params)]

    for compress in (True, False):
        out[("qwen3-32b", compress)] = run("qwen3-32b", compress, %(steps)d)
    out[("mixtral-8x7b", True)] = run("mixtral-8x7b", True, 2)
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % {"steps": STEPS}

WORKER = textwrap.dedent("""
    import logging, pickle, sys
    from datetime import timedelta
    from pathlib import Path
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.compression import compressed_mean, ef_compress, shard_of
    from repro_torch.distributed.multipod import ef_init, make_multipod_train_step
    from repro_torch.distributed.sharding import make_rules, place, strip_axis, use_rules
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.common import tree_items_sorted, tree_map_with_path
    from repro_torch.models.lm import LM, params_from_jax
    from repro_torch.train.optim import make_optimizer, warmup_cosine

    TIMEOUT = timedelta(seconds=120)
    LEAVES = %(leaves)r

    def full(tree):
        # a copy: a replicated DTensor's full tensor is its storage
        return [(x.full_tensor() if hasattr(x, "full_tensor") else x).clone()
                for _, x in tree_items_sorted(tree)]

    def exchange(inp, mesh, sub, pod):
        g, e = inp["exchange"]

        def laid_out(v, where):
            pl = [Replicate(), Replicate()]
            if where is not None:
                pl[sub.mesh_dim_names.index(where)] = Shard(1 if where == "model" else 0)
            return distribute_tensor(torch.from_numpy(v[pod]), sub, pl, src_data_rank=None)

        def whole(like, shard):
            return DTensor.from_local(shard, sub, like.placements, run_check=False,
                                      shape=like.shape, stride=like.stride()).full_tensor()

        grads = {k: laid_out(g[k], where) for k, (_, where) in LEAVES.items()}
        ef = {k: laid_out(e[k], where) for k, (_, where) in LEAVES.items()}
        out = {"q": {}, "scale": {}, "mean": {}, "new_ef": {}, "local": {}}
        with OpCounter() as counter:
            # the step's exchange of a leaf: its shard, the scale from the
            # leaf's maximum over every shard
            for k in LEAVES:
                (shard, groups), res = shard_of(grads[k]), shard_of(ef[k])[0]
                q, scale, _ = ef_compress(shard, res, groups)
                mean, new_ef = compressed_mean(shard, res, mesh["pod"], groups)
                out["q"][k], out["scale"][k] = whole(grads[k], q), scale
                out["mean"][k], out["new_ef"][k] = whole(grads[k], mean), whole(grads[k], new_ef)
                out["local"][k] = shard.numel()
        out["sent"] = counter.collectives_in("compression.compressed_mean")["all-gather"][2]
        return out

    def train(inp, arch, mesh, compress, steps, snap=None):
        cfg = reduced(get_config(arch)).replace(train_microbatches=2)
        model = LM(cfg, device="cpu")
        sub = mesh["data", "model"]
        rules = strip_axis(make_rules(multi_pod=True, fsdp=True), "pod")
        params = params_from_jax(cfg, inp["params"][arch], "cpu")
        params = tree_map_with_path(lambda _, p, s: place(p, s.axes, rules, sub), params,
                                    model.specs)
        opt = make_optimizer("adamw")
        step, _ = make_multipod_train_step(model, mesh, opt, microbatches=2, compress=compress,
                                           schedule=warmup_cosine(3e-3, 5, 100))
        state, ef, losses, norms, kept = opt.init(params), ef_init(params), [], [], None
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        with use_rules(rules, sub):
            for i in range(steps):
                params, state, ef, met = step(params, state, ef, batch, i)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
                if i + 1 == snap:
                    kept = full(params)
        layout = [tuple(map(str, x.placements)) for _, x in tree_items_sorted(ef)]
        return losses, norms, kept, full(params), full(state["m"]) + full(state["v"]), \
            full(ef), layout

    def worker(rank, world, tmp):
        torch.set_num_threads(1)
        logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
        tmp = Path(tmp)
        inp = pickle.load(open(tmp / "inputs.pkl", "rb"))
        res = {}
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))
            pod = mesh["pod"].get_local_rank()
            res["pod"] = pod
            res["exchange"] = exchange(inp, mesh, mesh["data", "model"], pod)
            for compress in (True, False):
                res[("qwen3-32b", compress)] = train(inp, "qwen3-32b", mesh, compress,
                                                     %(contract)d, snap=%(steps)d)
            res[("mixtral-8x7b", True)] = train(inp, "mixtral-8x7b", mesh, True, 2)
            cfg = reduced(get_config("qwen3-32b"))
            plain = params_from_jax(cfg, inp["params"]["qwen3-32b"], "cpu")
            step, opt = make_multipod_train_step(LM(cfg, device="cpu"), mesh, microbatches=2)
            batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
            try:
                step(plain, opt.init(plain), ef_init(plain), batch, 0)
            except ValueError as exc:
                res["plain_refused"] = str(exc)
        finally:
            dist.destroy_process_group()
        pickle.dump(res, open(tmp / f"rank{rank}.pkl", "wb"))

    if __name__ == "__main__":
        mp.spawn(worker, args=(4, sys.argv[1]), nprocs=4, join=True)
""") % {"contract": CONTRACT_STEPS, "steps": STEPS, "leaves": LEAVES}


def _inputs():
    """Parameters from ``repro``'s ``LM.init``, ``test_multipod.py``'s tokens,
    and per-pod gradients and residuals for the exchange (a zero leaf
    included)."""
    params = {}
    for arch in ("qwen3-32b", "mixtral-8x7b"):
        m = JaxLM(jax_reduced(jax_get_config(arch)))
        params[arch] = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0)))
    vocab = jax_reduced(jax_get_config("qwen3-32b")).vocab_size
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 33), 0, vocab))
    rng = np.random.default_rng(0)
    grads = {k: (0 if k == "zero" else 0.05) * rng.standard_normal((2,) + s).astype(np.float32)
             for k, (s, _) in LEAVES.items()}
    ef = {k: 1e-3 * rng.standard_normal((2,) + s).astype(np.float32)
          for k, (s, _) in LEAVES.items()}
    return {"params": params, "batch": {"tokens": toks[:, :32], "targets": toks[:, 1:]},
            "exchange": (grads, ef)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod_tp")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    (tmp / "reference.py").write_text(REFERENCE)
    (tmp / "worker.py").write_text(WORKER)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "HOME": str(tmp),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    ref = subprocess.Popen([sys.executable, str(tmp / "reference.py"), str(tmp / "inputs.pkl"),
                            str(tmp / "reference.pkl")], env=env, cwd=tmp,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp)], env=env,
                              cwd=tmp, capture_output=True, text=True, timeout=600)
        ref_out, ref_err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert port.returncode == 0, port.stderr[-4000:]
    assert ref.returncode == 0, ref_err[-4000:]
    with open(tmp / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(tmp / "inputs.pkl", "rb") as f:
        return pickle.load(f), reference, ranks


def of_update(got, want, before) -> float:
    """‖got − want‖ / ‖want − before‖: the port's distance from ``repro``'s
    parameters against the size of ``repro``'s update."""
    got, want, before = (np.asarray(x, np.float64) for x in (got, want, before))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - before), 1e-30))


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_sharded_exchange_is_the_reference_bit_for_bit(runs, leaf):
    """A shard's codes are the whole leaf's (its scale from the leaf's
    maximum over every shard); the mean and the new residual, gathered,
    are ``repro``'s ``compressed_psum`` bitwise."""
    _, ref, ranks = runs
    for res in ranks:
        ex, pod = res["exchange"], res["pod"]
        assert np.array_equal(ex["scale"][leaf].numpy(), ref["scale"][leaf][pod])
        assert ex["q"][leaf].dtype == torch.int8
        assert np.array_equal(ex["q"][leaf].numpy(), ref["q"][leaf][pod])
        assert np.array_equal(ex["mean"][leaf].numpy(), ref["mean"][leaf][pod])
        assert np.array_equal(ex["new_ef"][leaf].numpy(), ref["new_ef"][leaf][pod])


def test_sharded_exchange_sends_the_local_codes_and_one_scale_a_leaf(runs):
    _, _, ranks = runs
    for res in ranks:
        ex = res["exchange"]
        # model 2: a leaf sharded over model sends half its elements
        assert ex["local"]["cols"] == 16 * 12 and ex["local"]["rep"] == 40
        assert ex["sent"] == sum(ex["local"].values()) + 4 * len(LEAVES)


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "uncompressed"])
def test_tensor_parallel_steps_match_reference(runs, compress):
    """Losses within 1e-5, the global gradient norm within 1e-5 relative
    (the norm over every shard), parameters within 2e-3 of the update."""
    inp, ref, ranks = runs
    losses, norms, snap, _, _, _, layout = ranks[0][("qwen3-32b", compress)]
    ref_losses, ref_norms, ref_params = ref[("qwen3-32b", compress)]
    np.testing.assert_allclose(losses[:STEPS], ref_losses, rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(norms[:STEPS], ref_norms, rtol=LOSS_ATOL, atol=0)
    before = jax.tree.leaves(inp["params"]["qwen3-32b"])
    assert len(snap) == len(ref_params) == len(before)
    for got, want, b in zip(snap, ref_params, before):
        assert np.isfinite(got.numpy()).all()
        assert of_update(got.numpy(), want, b) <= STEP_NORMWISE
    # tensor parallelism ran: some ef leaves are sharded over model
    assert any(model.startswith("S(") for _, model in layout)


def test_tensor_parallel_moe_matches_reference(runs):
    inp, ref, ranks = runs
    losses, _, _, final, _, _, _ = ranks[0][("mixtral-8x7b", True)]
    ref_losses, _, ref_params = ref[("mixtral-8x7b", True)]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_ATOL)
    before = jax.tree.leaves(inp["params"]["mixtral-8x7b"])
    for got, want, b in zip(final, ref_params, before):
        assert of_update(got.numpy(), want, b) <= STEP_NORMWISE


def test_every_rank_holds_bitwise_the_same_state(runs):
    """Parameters and AdamW moments, gathered, on all four ranks; the
    ``ef`` residuals (one tree a pod, as in ``repro``) on both ranks of a
    pod."""
    _, _, ranks = runs
    for key in (("qwen3-32b", True), ("qwen3-32b", False), ("mixtral-8x7b", True)):
        losses0, _, _, final0, state0, _, _ = ranks[0][key]
        for res in ranks[1:]:
            losses, _, _, final, state, _, _ = res[key]
            assert losses == losses0, key
            assert all(torch.equal(a, b) for a, b in zip(final, final0)), key
            assert all(torch.equal(a, b) for a, b in zip(state, state0)), key
        for pod in (0, 1):
            efs = [res[key][5] for res in ranks if res["pod"] == pod]
            assert len(efs) == 2
            assert all(torch.equal(a, b) for a, b in zip(*efs)), key


def test_compressed_contract_over_25_steps(runs):
    """``test_multipod.py``'s contract with tensor parallelism."""
    _, _, ranks = runs
    lc = ranks[0][("qwen3-32b", True)][0][-1]
    lu = ranks[0][("qwen3-32b", False)][0][-1]
    assert lc < 6.25 - 0.2, f"compressed did not learn: {lc}"
    assert abs(lc - lu) < 0.15, (lc, lu)


def test_plain_state_on_a_model_dimension_is_refused(runs):
    _, _, ranks = runs
    for res in ranks:
        assert "DTensor" in res["plain_refused"]
