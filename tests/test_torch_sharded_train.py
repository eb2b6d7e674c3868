"""The port's sharded training program on real values.

One module fixture spawns 4 gloo processes (``torch.multiprocessing.spawn``,
a ``file://`` rendezvous under ``tmp_path``) on a (2, 2) ``data`` ×
``model`` mesh with ``make_rules()``.  Parameters come from the port's
``LM.init`` (seed 0) and are laid out by ``safe_sharding``; the batch rows
are sharded over ``data``.  Every rank then runs, under ``use_rules`` alone
(no ``implicit_replication``):

* for every reduced arch, cross stacks with their context features, one
  ``LM.loss_fn`` gradient, each leaf gathered (``full_tensor``) and held
  against the plain port's on one process: loss within 1e-5, every leaf
  within 1e-4 normwise (PR 25's gradient tolerance); for two of them again
  with remat, the backward on another thread (as autograd runs it for a
  CUDA tensor);
* one sharded train step (2 microbatches) from optimizer state made by the
  optimizer's own ``init`` on the sharded parameters, against the plain
  step over the same microbatches: a rank holds 2 of the 4 rows, and its
  microbatch ``i`` is its ``i``-th row, so the plain step takes the rows in
  the order 0, 2, 1, 3;
* reduced ``nemotron-4-340b`` and ``deepseek-v2-236b`` with 4 microbatches
  over the same 4 rows: a rank holds 2 rows, fewer than the microbatches,
  so a pass runs 2 microbatches side by side (one row each), and the step
  is held against the plain step at the same ``k``.

The tests read what rank 0 wrote; each rank also writes its final state,
to show every rank ends a step with bitwise the same parameters.
"""
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
NAMES = sorted(ARCHS)
LOSS_ATOL = 1e-5
GRAD_NORMWISE = 1e-4
STEP_NORMWISE = 2e-3
#: archs whose gradient also runs with remat, the backward on another thread
REMAT = ["deepseek-67b", "mixtral-8x7b"]
STEPS = [("deepseek-67b", "adamw", 2), ("deepseek-v2-236b", "adamw", 2),
         ("deepseek-v2-236b", "adafactor", 2), ("nemotron-4-340b", "adamw", 4),
         ("deepseek-v2-236b", "adamw", 4)]

WORKER = textwrap.dedent("""
    import logging, pickle, sys, threading
    from datetime import timedelta
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.distributed.sharding import make_rules, place, use_rules
    from repro_torch.models.common import tree_items_sorted, tree_leaves, tree_map_with_path
    from repro_torch.models.common import tree_unflatten
    from repro_torch.models.lm import LM
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer, warmup_cosine

    STEPS = %(steps)r
    REMAT = %(remat)r
    SCHED = warmup_cosine(3e-3, 5, 100)

    def inputs(cfg, rows=4):
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, 33)).astype(np.int64))
        batch = {"tokens": toks[:, :32], "targets": toks[:, 1:]}
        if cfg.encoder_layers:
            batch["enc_feats"] = torch.from_numpy(rng.standard_normal(
                (rows, cfg.encoder_context, cfg.d_model)).astype(np.float32))
        if cfg.vision_context:
            batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (rows, cfg.vision_context, cfg.d_model)).astype(np.float32))
        return batch

    def setup(arch):
        cfg = reduced(get_config(arch))
        model = LM(cfg, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(0)
        return cfg, model, model.init(gen)

    def shard(model, params, batch, rules, mesh):
        # a copy: a shard may share its tensor's storage, and the step updates in place
        sp = tree_map_with_path(lambda _, p, s: place(p.clone(), s.axes, rules, mesh), params,
                                model.specs)
        sb = {k: place(v, ("batch",) + (None,) * (v.ndim - 1), rules, mesh)
              for k, v in batch.items()}
        return sp, sb

    def full(tree):
        # a copy: a replicated DTensor's full tensor is its storage
        return [(x.full_tensor() if hasattr(x, "full_tensor") else x).clone()
                for _, x in tree_items_sorted(tree)]

    def gradients(arch, rules, mesh, rank, remat="none"):
        cfg, model, params = setup(arch)
        if remat != "none":
            model = LM(cfg.replace(remat=remat), device="cpu")
        batch = inputs(cfg)
        sp, sb = shard(model, params, batch, rules, mesh)
        live = [p.detach().requires_grad_() for p in tree_leaves(sp)]
        with use_rules(rules, mesh):
            loss, _ = model.loss_fn(tree_unflatten(sp, live), sb)
            if remat == "none":
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            else:
                # the backward (and remat's recomputation) on another thread, as
                # autograd runs it for a CUDA tensor; autograd carries the
                # caller's ATen thread-local state there (DTensor's implicit
                # replication among it), not Python's threading.local
                implicit = DTensor._op_dispatcher._allow_implicit_replication
                out = []

                def backward():
                    DTensor._op_dispatcher._allow_implicit_replication = implicit
                    out.append(torch.autograd.grad(loss, live, allow_unused=True))

                t = threading.Thread(target=backward)
                t.start()
                t.join()
                grads = out[0]
        got = [None if g is None else g.full_tensor() for g in grads]
        loss = float(loss.full_tensor())
        if rank:
            return None
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        want_loss, _ = model.loss_fn(tree_unflatten(params, live), batch)
        want = torch.autograd.grad(want_loss, live, allow_unused=True)
        paths = []
        tree_map_with_path(lambda p, _: paths.append("/".join(map(str, p))), params)
        gaps = {}
        for path, a, b in zip(paths, got, want):
            if a is None or b is None:
                gaps[path] = "unused" if a is None and b is None else "one side unused"
            else:
                gaps[path] = float((a - b).norm() / max(float(b.norm()), 1e-30))
        return {"loss": (loss, float(want_loss)), "gaps": gaps}

    def step(arch, opt_name, k, rules, mesh, rank):
        cfg, model, params = setup(arch)
        batch = inputs(cfg)
        opt = make_optimizer(opt_name)
        sp, sb = shard(model, params, batch, rules, mesh)
        state = opt.init(sp)
        placed = [(tuple(s.placements) == tuple(p.placements)) for s, p in
                  zip(tree_leaves(state.get("m", {})), tree_leaves(sp))]
        train, _ = make_train_step(model, opt, schedule=SCHED, microbatches=k)
        with use_rules(rules, mesh):
            sp, state, met = train(sp, state, sb, 0)
        out = {"params": full(sp), "loss": float(met["loss"].full_tensor()),
               "grad_norm": float(met["grad_norm"].full_tensor()), "placed": placed}
        if rank:
            return out
        # data rank r holds rows 2r and 2r + 1; with k = 2 microbatch i is each
        # rank's i-th row, rows i and i + 2 (with k = 4, row by row)
        order = [0, 2, 1, 3] if k == 2 else [0, 1, 2, 3]
        plain_batch = {kk: v[order] for kk, v in batch.items()}
        before = full(params)
        pstate = opt.init(params)
        ptrain, _ = make_train_step(model, opt, schedule=SCHED, microbatches=k)
        params, pstate, pmet = ptrain(params, pstate, plain_batch, 0)
        out.update(before=before, plain=full(params), plain_loss=float(pmet["loss"]),
                   plain_grad_norm=float(pmet["grad_norm"]))
        return out

    def worker(rank, world, tmp):
        torch.set_num_threads(1)
        logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
        tmp = Path(tmp)
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
        res = {"grads": {}, "steps": {}}
        try:
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            rules = make_rules()
            for arch in sorted(ARCHS):
                res["grads"][arch] = gradients(arch, rules, mesh, rank)
            for arch in REMAT:
                try:
                    res["grads"][(arch, "remat")] = gradients(arch, rules, mesh, rank, "full")
                except Exception as exc:   # a recomputation outside the rules fails here
                    res["grads"][(arch, "remat")] = {"error": repr(exc)}
            for arch, opt_name, k in STEPS:
                res["steps"][(arch, opt_name, k)] = step(arch, opt_name, k, rules, mesh, rank)
        finally:
            dist.destroy_process_group()
        pickle.dump(res, open(tmp / f"rank{rank}.pkl", "wb"))

    if __name__ == "__main__":
        mp.spawn(worker, args=(4, sys.argv[1]), nprocs=4, join=True)
""") % {"steps": STEPS, "remat": REMAT}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    (tmp / "worker.py").write_text(WORKER)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "HOME": str(tmp),
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp)], env=env, cwd=tmp,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def of_update(got, want, before) -> float:
    """‖got − want‖ / ‖want − before‖ of one leaf."""
    got, want, before = (np.asarray(x, np.float64) for x in (got, want, before))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - before), 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_plain(ranks, name):
    got, want = ranks[0]["grads"][name]["loss"]
    assert abs(got - want) <= LOSS_ATOL, (got, want)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_gradient_matches_plain_leaf_for_leaf(ranks, name):
    """Every leaf within 1e-4 normwise, the MoE routers included (each
    rank of the experts' split computes the whole aux loss, whose gradient
    now reaches the router and the tokens once)."""
    gaps = ranks[0]["grads"][name]["gaps"]
    bad = {p: g for p, g in gaps.items()
           if isinstance(g, str) and g != "unused" or isinstance(g, float) and g > GRAD_NORMWISE}
    assert not bad, bad
    if ARCHS[name].moe is not None:
        assert any(p.endswith("mlp/router") for p in gaps)


@pytest.mark.parametrize("name", REMAT)
def test_remat_recomputes_inside_the_sharded_program(ranks, name):
    """With remat the backward recomputes each period's forward; run on
    another thread (autograd's own for a CUDA tensor) it keeps the rules
    context, so the gradient is the plain port's."""
    res = ranks[0]["grads"][(name, "remat")]
    assert "error" not in res, res.get("error")
    got, want = res["loss"]
    assert abs(got - want) <= LOSS_ATOL
    bad = {p: g for p, g in res["gaps"].items()
           if isinstance(g, str) and g != "unused" or isinstance(g, float) and g > GRAD_NORMWISE}
    assert not bad, bad


@pytest.mark.parametrize("case", STEPS, ids=["-".join(map(str, c)) for c in STEPS])
def test_sharded_step_matches_plain_step(ranks, case):
    """Loss and global gradient norm within 1e-5 (relative for the norm),
    parameters within 2e-3 of the plain update, and the optimizer's state
    laid out like the parameters."""
    res = ranks[0]["steps"][case]
    assert abs(res["loss"] - res["plain_loss"]) <= LOSS_ATOL
    assert abs(res["grad_norm"] / res["plain_grad_norm"] - 1) <= LOSS_ATOL
    assert all(res["placed"])
    for got, want, before in zip(res["params"], res["plain"], res["before"]):
        assert np.isfinite(got.numpy()).all()
        assert of_update(got.numpy(), want.numpy(), before.numpy()) <= STEP_NORMWISE


def test_every_rank_ends_the_step_with_the_same_state(ranks):
    for case in STEPS:
        want = ranks[0]["steps"][case]
        for res in ranks[1:]:
            got = res["steps"][case]
            assert got["loss"] == want["loss"], case
            assert all(torch.equal(a, b) for a, b in zip(got["params"], want["params"])), case
