"""The EF-int8 pod exchange and the multipod train step against ``repro``'s.

One module-scoped run of each side, every test only reading what they wrote:

* ``repro`` in one subprocess on 4 virtual CPU devices, mesh (2, 2, 1)
  ``pod``/``data``/``model``: ``compressed_psum`` under
  ``jax.vmap(axis_name="pod")`` and ``ef_compress`` on per-pod inputs, and
  3 jitted multipod steps compressed and not (reduced ``qwen3-32b``, 2
  microbatches, batch 8 × 32 of ``test_multipod.py``'s tokens,
  ``warmup_cosine(3e-3, 5, 100)``); then reduced ``mixtral-8x7b`` (MoE) for
  2 compressed steps on a (4, 1, 1) mesh and 3 uncompressed ones on
  (4, 1, 1) and (2, 2, 1);
* the port in 4 gloo processes (one ``torch.multiprocessing.spawn``, a
  ``file://`` rendezvous under ``tmp_path``) on a (2, 2) ``pod`` × ``data``
  mesh: the same exchange and steps from the same parameters, carried on to
  ``test_multipod.py``'s 25-step contract, MoE on a (4, 1) mesh (``data`` 1:
  the router's groups are then ``repro``'s; on (2, 2) they are those of
  ``repro``'s (4, 1, 1), not its (2, 2, 1)); then rank 0 alone on a
  world-size-1 mesh: the uncompressed step against
  ``make_train_step`` and ``compressed_psum`` against ``ef_compress``.
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
MEAN_RTOL = 1e-6

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

    def run(arch, shape, compress, steps):
        mesh = jax.make_mesh(shape, ("pod", "data", "model"))
        m = LM(reduced(get_config(arch)).replace(train_microbatches=2))
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        opt = make_optimizer("adamw")
        step, _ = make_multipod_train_step(m, mesh, opt, microbatches=2, compress=compress,
                                           schedule=warmup_cosine(3e-3, 5, 100))
        state, ef, losses = opt.init(params), ef_init(params), []
        with mesh:
            jstep = jax.jit(step)
            for i in range(steps):
                params, state, ef, met = jstep(params, state, ef, inp["batch"], jnp.int32(i))
                losses.append(float(met["loss"]))
        return losses, [np.asarray(x) for x in jax.tree.leaves(params)]

    for compress in (True, False):
        out[("qwen3-32b", compress)] = run("qwen3-32b", (2, 2, 1), compress, %(steps)d)
    out[("mixtral-8x7b", True)] = run("mixtral-8x7b", (4, 1, 1), True, 2)
    for shape in ((4, 1, 1), (2, 2, 1)):
        out[("mixtral-8x7b", shape)] = run("mixtral-8x7b", shape, False, 3)
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % {"steps": STEPS}

WORKER = textwrap.dedent("""
    import pickle, sys
    from datetime import timedelta
    from pathlib import Path
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.compression import compressed_psum, ef_compress
    from repro_torch.distributed.multipod import (ef_init, local_batch,
                                                  make_multipod_train_step)
    from repro_torch.models.common import tree_items_sorted
    from repro_torch.models.lm import LM, params_from_jax
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer, warmup_cosine

    TIMEOUT = timedelta(seconds=120)

    def init(path, rank, world):
        dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                                world_size=world, timeout=TIMEOUT)

    def leaves(tree):
        return [x.clone() for _, x in tree_items_sorted(tree)]

    def train(inp, arch, mesh, compress, steps, snap=None):
        cfg = reduced(get_config(arch)).replace(train_microbatches=2)
        params = params_from_jax(cfg, inp["params"][arch], "cpu")
        opt = make_optimizer("adamw")
        step, _ = make_multipod_train_step(LM(cfg, device="cpu"), mesh, opt, microbatches=2,
                                           compress=compress,
                                           schedule=warmup_cosine(3e-3, 5, 100))
        state, ef, losses, kept = opt.init(params), ef_init(params), [], None
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        for i in range(steps):
            params, state, ef, met = step(params, state, ef, batch, i)
            losses.append(float(met["loss"]))
            if i + 1 == snap:
                kept = leaves(params)
        return losses, kept, leaves(params)

    def worker(rank, world, tmp):
        torch.set_num_threads(1)
        tmp = Path(tmp)
        inp = pickle.load(open(tmp / "inputs.pkl", "rb"))
        res = {}
        init(tmp / "rendezvous4", rank, world)
        try:
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
            pod, data = mesh["pod"].get_local_rank(), mesh["data"].get_local_rank()
            res["coords"] = (pod, data)
            g, e = inp["exchange"]
            grads = {k: torch.from_numpy(v[pod]) for k, v in g.items()}
            ef = {k: torch.from_numpy(v[pod]) for k, v in e.items()}
            res["q"] = {k: ef_compress(grads[k], ef[k])[0] for k in grads}
            res["scale"] = {k: ef_compress(grads[k], ef[k])[1] for k in grads}
            wire = {}
            for k, q in res["q"].items():
                got = [torch.empty_like(q) for _ in range(2)]
                dist.all_gather(got, q, group=mesh["pod"].get_group())
                wire[k] = torch.stack(got)
            res["wire"] = wire
            res["mean"], res["new_ef"] = compressed_psum(grads, ef, mesh["pod"])
            res["local_batch"] = local_batch(
                {"rows": torch.arange(16).reshape(16, 1)}, mesh, 2)["rows"]
            for compress in (True, False):
                res[("qwen3-32b", compress)] = train(inp, "qwen3-32b", mesh, compress,
                                                     %(contract)d, snap=%(steps)d)
            moe_mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "data"))
            res[("mixtral-8x7b", True)] = train(inp, "mixtral-8x7b", moe_mesh, True, 2)
            res[("mixtral-8x7b", (2, 2))] = train(inp, "mixtral-8x7b", mesh, False, 3)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            init(tmp / "rendezvous1", 0, 1)
            try:
                res["world1"] = world_one(inp)
            finally:
                dist.destroy_process_group()
        pickle.dump(res, open(tmp / f"rank{rank}.pkl", "wb"))

    def world_one(inp):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("pod", "data"))
        cfg = reduced(get_config("qwen3-32b")).replace(train_microbatches=2)
        model = LM(cfg, device="cpu")
        sched = warmup_cosine(3e-3, 5, 100)
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        opt = make_optimizer("adamw")
        multi, _ = make_multipod_train_step(model, mesh, opt, microbatches=2,
                                            compress=False, schedule=sched)
        single, _ = make_train_step(model, opt, microbatches=2, schedule=sched)
        p_m = params_from_jax(cfg, inp["params"]["qwen3-32b"], "cpu")
        p_s = params_from_jax(cfg, inp["params"]["qwen3-32b"], "cpu")
        s_m, s_s, ef = opt.init(p_m), opt.init(p_s), ef_init(p_m)
        losses = []
        for i in range(2):
            p_m, s_m, ef, m_m = multi(p_m, s_m, ef, batch, i)
            p_s, s_s, m_s = single(p_s, s_s, batch, i)
            losses.append((m_m["loss"].clone(), m_s["loss"].clone()))
        g, e = inp["exchange"]
        grads = {k: torch.from_numpy(v[0]) for k, v in g.items()}
        ef1 = {k: torch.from_numpy(v[0]) for k, v in e.items()}
        mean, new_ef = compressed_psum(grads, ef1, mesh["pod"])
        codec = {k: ef_compress(grads[k], ef1[k]) for k in grads}
        return {"losses": losses, "params": (leaves(p_m), leaves(p_s)),
                "opt": (leaves(s_m), leaves(s_s)), "mean": mean, "new_ef": new_ef,
                "deq": {k: q.float() * s for k, (q, s, _) in codec.items()},
                "residual": {k: r for k, (_, _, r) in codec.items()}}

    if __name__ == "__main__":
        mp.spawn(worker, args=(4, sys.argv[1]), nprocs=4, join=True)
""") % {"contract": CONTRACT_STEPS, "steps": STEPS}


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
    shapes = {"w": (16, 24), "b": (40,), "z": (7,)}
    grads = {k: (0 if k == "z" else 0.05) * rng.standard_normal((2,) + s).astype(np.float32)
             for k, s in shapes.items()}
    ef = {k: 1e-3 * rng.standard_normal((2,) + s).astype(np.float32)
          for k, s in shapes.items()}
    return {"params": params, "batch": {"tokens": toks[:, :32], "targets": toks[:, 1:]},
            "exchange": (grads, ef)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
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
                              cwd=tmp, capture_output=True, text=True, timeout=300)
        ref_out, ref_err = ref.communicate(timeout=300)
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


def test_compressed_psum_matches_reference(runs):
    _, ref, ranks = runs
    for res in ranks:
        pod, _ = res["coords"]
        for k in ("w", "b", "z"):
            assert np.array_equal(res["q"][k].numpy(), ref["q"][k][pod]), k
            assert res["q"][k].dtype == torch.int8
            assert np.array_equal(res["scale"][k].numpy(), ref["scale"][k][pod]), k
            assert np.array_equal(res["new_ef"][k].numpy(), ref["new_ef"][k][pod]), k
            np.testing.assert_allclose(res["mean"][k].numpy(), ref["mean"][k][pod],
                                       rtol=MEAN_RTOL, atol=0)
            # the wire carries every pod's int8 payload, in pod order
            assert np.array_equal(res["wire"][k].numpy(), ref["q"][k]), k


def test_local_batch_is_the_rank_slice_of_each_pod_microbatch(runs):
    _, _, ranks = runs
    for res in ranks:
        pod, data = res["coords"]
        # pod p holds rows [8p, 8p + 8): microbatch i is rows 8p + 4i + [0, 4),
        # and data rank d keeps its half of each
        want = [8 * pod + 4 * i + 2 * data + j for i in range(2) for j in range(2)]
        assert res["local_batch"][:, 0].tolist() == want


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "uncompressed"])
def test_multipod_steps_match_reference(runs, compress):
    inp, ref, ranks = runs
    losses, snap, _ = ranks[0][("qwen3-32b", compress)]
    ref_losses, ref_params = ref[("qwen3-32b", compress)]
    np.testing.assert_allclose(losses[:STEPS], ref_losses, rtol=0, atol=LOSS_ATOL)
    before = jax.tree.leaves(inp["params"]["qwen3-32b"])
    assert len(snap) == len(ref_params) == len(before)
    for got, want, b in zip(snap, ref_params, before):
        assert np.isfinite(got.numpy()).all()
        assert of_update(got.numpy(), want, b) <= STEP_NORMWISE


def test_moe_with_data_one_matches_reference(runs):
    inp, ref, ranks = runs
    losses, _, final = ranks[0][("mixtral-8x7b", True)]
    ref_losses, ref_params = ref[("mixtral-8x7b", True)]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_ATOL)
    before = jax.tree.leaves(inp["params"]["mixtral-8x7b"])
    for got, want, b in zip(final, ref_params, before):
        assert of_update(got.numpy(), want, b) <= STEP_NORMWISE


def test_moe_under_a_data_split_routes_each_rank_alone(runs):
    """On a (2, 2) mesh each port rank routes its own row of a microbatch,
    as ``repro``'s pods do on (4, 1, 1); ``repro``'s (2, 2, 1) routes a
    pod's two rows as one group, and its aux loss moves (ROADMAP §3)."""
    _, ref, ranks = runs
    port = ranks[0][("mixtral-8x7b", (2, 2))][0]
    per_row = ref[("mixtral-8x7b", (4, 1, 1))][0]
    per_pod = ref[("mixtral-8x7b", (2, 2, 1))][0]
    np.testing.assert_allclose(port, per_row, rtol=0, atol=LOSS_ATOL)
    gap = np.abs(np.subtract(per_pod, per_row))
    assert gap[0] > LOSS_ATOL, gap


def test_every_rank_holds_the_same_state(runs):
    _, _, ranks = runs
    for key in (("qwen3-32b", True), ("qwen3-32b", False), ("mixtral-8x7b", True),
                ("mixtral-8x7b", (2, 2))):
        losses0, _, final0 = ranks[0][key]
        for res in ranks[1:]:
            losses, _, final = res[key]
            assert losses == losses0, key
            assert all(torch.equal(a, b) for a, b in zip(final, final0)), key


def test_compressed_contract_over_25_steps(runs):
    """``test_multipod.py``'s contract on the port's 4-process mesh."""
    _, _, ranks = runs
    lc = ranks[0][("qwen3-32b", True)][0][-1]
    lu = ranks[0][("qwen3-32b", False)][0][-1]
    assert lc < 6.25 - 0.2, f"compressed did not learn: {lc}"
    assert abs(lc - lu) < 0.15, (lc, lu)


def test_world_size_one_uncompressed_step_is_make_train_step(runs):
    _, _, ranks = runs
    w1 = ranks[0]["world1"]
    for m, s in w1["losses"]:
        assert torch.equal(m, s)
    for tree in ("params", "opt"):
        multi, single = w1[tree]
        assert len(multi) == len(single)
        assert all(torch.equal(a, b) for a, b in zip(multi, single)), tree


def test_world_size_one_compressed_psum_is_ef_compress(runs):
    _, _, ranks = runs
    w1 = ranks[0]["world1"]
    for k in w1["deq"]:
        assert torch.equal(w1["mean"][k], w1["deq"][k]), k
        assert torch.equal(w1["new_ef"][k], w1["residual"][k]), k
