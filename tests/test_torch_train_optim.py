"""The port's optimizers, schedule, train step and loop against ``repro``'s.

AdamW and Adafactor over 5 steps from the same parameters and gradients
(numpy, from a seed) as ``repro``'s, ``clip_by_global_norm`` and
``warmup_cosine``, ``opt_state_from_jax``; remat none / full /
dots_saveable bitwise within the port; ``repro``'s microbatching contract
and its train-loop contract (loss falls over 50 steps on reduced
``qwen3-32b``), and the loop's retries.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import lm_pipeline  # noqa: E402
from repro_torch.models.common import (tree_items_sorted, tree_leaves,  # noqa: E402
                                       tree_map_with_path, tree_unflatten)
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import (UpdateInterrupted, _split_microbatches,  # noqa: E402
                                    make_train_step, train_loop)
from test_torch_train_model import one_thread  # noqa: E402,F401  (autouse)

# fp32 elementwise updates, XLA against torch: measured bitwise for AdamW
# and within 1 ulp for Adafactor's rsqrt over 5 steps
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _tree(rng):
    """Leaves of every rank the models have: a vector, a matrix, a stack."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "stack": {"k": rng.standard_normal((3, 4, 2, 6)).astype(np.float32)}}


def _to_torch(tree):
    return tree_map_with_path(lambda _, x: torch.from_numpy(np.array(x)), tree)


def _reorder(tree, like):
    """``tree`` (a JAX result, its dict keys sorted) in ``like``'s key order."""
    if isinstance(like, dict):
        return {k: _reorder(tree[k], v) for k, v in like.items()}
    return tree


def _ref_leaves(tree, like) -> list:
    """A JAX tree's leaves as numpy, in the order of ``like``'s leaves."""
    return [np.asarray(x) for x in tree_leaves(_reorder(tree, like))]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_5_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, opt = jax_optim.make_optimizer(name), optim.make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = _to_torch(params)
    st = opt.init(tp)
    sched, jsched = optim.warmup_cosine(0.05, 2, 5), jax_optim.warmup_cosine(0.05, 2, 5)
    for step in range(5):
        grads = _tree(rng)
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp, jsched(step))
        tp, st = opt.update(_to_torch(grads), st, tp, sched(step))
        for a, b in zip(tree_leaves(tp), _ref_leaves(jp, params)):
            np.testing.assert_allclose(a.numpy(), b, rtol=OPT_RTOL, atol=OPT_ATOL)
    assert int(st["count"]) == int(jst["count"]) == 5
    if name == "adamw":
        pairs = [(st["m"], jst["m"]), (st["v"], jst["v"])]
    else:
        pairs = [(st["per_param"], jst["per_param"])]
        assert set(st["per_param"]["w"]) == {"vr", "vc"}
        assert set(st["per_param"]["b"]) == {"v"}
        assert st["per_param"]["stack"]["k"]["vr"].shape == (3, 4, 2)
        assert st["per_param"]["stack"]["k"]["vc"].shape == (3, 4, 6)
    for port, ref in pairs:
        for a, b in zip(tree_leaves(port), _ref_leaves(ref, port)):
            np.testing.assert_allclose(a.numpy(), b, rtol=OPT_RTOL, atol=OPT_ATOL)


def test_updates_are_fp32_cast_back_and_in_place():
    rng = np.random.default_rng(1)
    for name in ("adamw", "adafactor"):
        opt = optim.make_optimizer(name)
        p = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).bfloat16()}
        st = opt.init(p)
        g = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).bfloat16()}
        jp = {"w": jnp.asarray(p["w"].float().numpy()).astype(jnp.bfloat16)}
        jopt = jax_optim.make_optimizer(name)
        jp2, _ = jopt.update({"w": jnp.asarray(g["w"].float().numpy()).astype(jnp.bfloat16)},
                             jopt.init(jp), jp, 0.01)
        w = p["w"]
        p2, st2 = opt.update(g, st, p, torch.tensor(0.01))
        assert p2["w"] is w and w.dtype == torch.bfloat16
        # the fp32 update rounded to bf16 once in each package
        np.testing.assert_allclose(w.float().numpy(),
                                   np.asarray(jp2["w"].astype(jnp.float32)), rtol=2 ** -8)
        assert all(x.dtype == torch.float32 for x in tree_leaves(st2) if x.ndim)


def test_adamw_slices_a_leaf_bitwise(monkeypatch):
    rng = np.random.default_rng(2)
    p0 = {"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))}
    outs = []
    for sl in (1 << 24, 4):
        monkeypatch.setattr(optim, "_SLICE", sl)
        opt = optim.adamw()
        p = {"w": p0["w"].clone()}
        st = opt.init(p)
        for _ in range(3):
            p, st = opt.update(g, st, p, torch.tensor(0.01))
        outs.append((p["w"].clone(), st["m"]["w"].clone(), st["v"]["w"].clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_update_rejects_a_non_contiguous_leaf():
    opt = optim.adamw()
    base = torch.zeros((4, 6))
    p = {"w": base.T}
    with pytest.raises(RuntimeError):
        opt.update({"w": torch.ones((6, 4))}, opt.init({"w": torch.zeros((6, 4))}), p, 0.1)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_by_global_norm_matches_reference(scale):
    rng = np.random.default_rng(3)
    grads = tree_map_with_path(lambda _, x: x * scale, _tree(rng))
    clipped, gn = optim.clip_by_global_norm(_to_torch(grads), 1.0)
    jclipped, jgn = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    for a, b in zip(tree_leaves(clipped), _ref_leaves(jclipped, grads)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9)
    if scale == 1.0:
        total = torch.sqrt(sum((x ** 2).sum() for x in tree_leaves(clipped)))
        assert float(total) == pytest.approx(1.0, rel=1e-5)


def test_global_norm_sums_leaves_in_sorted_key_order():
    g = {"z": torch.ones(2), "a": torch.full((2,), 2.0), "m": [torch.full((2,), 3.0)]}
    assert [k for k, _ in tree_items_sorted(g)] == [("a",), ("m", 0), ("z",)]
    assert [k for k, _ in tree_items_sorted(g)] == \
        [tuple(getattr(e, "key", getattr(e, "idx", None)) for e in kp)
         for kp, _ in jax.tree_util.tree_flatten_with_path(g)[0]]
    assert float(optim.global_norm(g)) == pytest.approx(np.sqrt(2 * (1 + 4 + 9)))


def test_warmup_cosine_matches_reference():
    for base, warm, total in ((1e-3, 100, 1000), (3e-3, 20, 200), (0.05, 0, 10)):
        s, js = optim.warmup_cosine(base, warm, total), jax_optim.warmup_cosine(base, warm, total)
        for step in (0, 1, warm - 1, warm, warm + 1, total // 2, total - 1, total, total + 5):
            got = s(step)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(js(step)), rel=1e-6)
    s = optim.warmup_cosine(1e-3, 100, 1000)
    assert float(s(0)) < float(s(99))
    assert float(s(100)) == pytest.approx(1e-3, rel=1e-2)
    assert float(s(999)) < 0.2 * 1e-3


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_jax_continues_the_reference(name):
    """Two ``repro`` steps, the state carried across, a third step in both."""
    jcfg = jax_reduced(jax_get_config("deepseek-v2-236b"))
    cfg = reduced(get_config("deepseek-v2-236b"))
    jm = JaxLM(jcfg)
    tree = jm.init(jax.random.PRNGKey(0))
    jopt = jax_optim.make_optimizer(name)
    jst = jopt.init(tree)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), tree) for _ in range(3)]
    update = jax.jit(jopt.update)
    for g in grads[:2]:
        tree, jst = update(g, jst, tree, 0.01)
    np_tree = jax.tree.map(np.asarray, tree)
    st = optim.opt_state_from_jax(cfg, name, jax.tree.map(np.asarray, jst), "cpu")
    params = params_from_jax(cfg, np_tree, "cpu")
    assert int(st["count"]) == 2 and st["count"].dtype == torch.int32
    tree, jst = update(grads[2], jst, tree, 0.01)
    tg = params_from_jax(cfg, jax.tree.map(np.asarray, grads[2]), "cpu")
    params, st = optim.make_optimizer(name).update(tg, st, params, torch.tensor(0.01))
    for a, b in zip(tree_leaves(params),
                    tree_leaves(params_from_jax(cfg, jax.tree.map(np.asarray, tree), "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=OPT_RTOL, atol=OPT_ATOL)
    bad = jax.tree.map(np.asarray, jst)
    key = "m" if name == "adamw" else "per_param"
    leaf = bad[key]["embed"]
    bad[key]["embed"] = leaf[:-1] if name == "adamw" else {k: v[:-1] for k, v in leaf.items()}
    with pytest.raises(ValueError, match="embed"):
        optim.opt_state_from_jax(cfg, name, bad, "cpu")


# ---------------------------------------------------------------------------
# remat, microbatches, the loop
# ---------------------------------------------------------------------------

def _model_batch(name, seed=0, b=2, s=32, **replace):
    cfg = reduced(get_config(name)).replace(**replace)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :s], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        batch["enc_feats"] = 0.1 * torch.from_numpy(
            rng.standard_normal((b, cfg.encoder_context, cfg.d_model)).astype(np.float32))
    if cfg.vision_context:
        batch["image_embeds"] = 0.1 * torch.from_numpy(
            rng.standard_normal((b, cfg.vision_context, cfg.d_model)).astype(np.float32))
    return cfg, model, params, batch


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "jamba-v0.1-52b", "whisper-large-v3"])
def test_remat_changes_no_number(name):
    """Losses and gradients with remat none, full and dots_saveable are
    bitwise equal (fp32 on the CPU)."""
    outs = []
    for remat in ("none", "full", "dots_saveable"):
        cfg, model, params, batch = _model_batch(name, remat=remat)
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, met = model.loss_fn(tree_unflatten(params, live), batch)
        outs.append([loss.detach(), met["aux"].detach()]
                    + list(torch.autograd.grad(loss, live)))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_split_microbatches_rows():
    batch = {"tokens": torch.arange(24).reshape(8, 3)}
    mbs = _split_microbatches(batch, 4)
    for i in range(4):
        assert torch.equal(mbs["tokens"][i], batch["tokens"][2 * i:2 * i + 2])
    with pytest.raises(ValueError):
        _split_microbatches(batch, 3)


def test_microbatching_equivalence():
    """k microbatches give one big batch's step (``repro``'s contract, its
    tolerances), and the port's k = 4 step matches ``repro``'s."""
    jcfg = jax_reduced(jax_get_config("deepseek-67b"))
    cfg = reduced(get_config("deepseek-67b"))
    jm = JaxLM(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :32], "targets": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = LM(cfg, device="cpu")
    outs = {}
    for k in (1, 4):
        params = params_from_jax(cfg, tree, "cpu")
        opt = optim.make_optimizer("adamw")
        step, _ = make_train_step(model, opt, microbatches=k)
        p, _, m = step(params, opt.init(params), tbatch, 0)
        outs[k] = (p, float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-5)
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)
    jopt = jax_optim.make_optimizer("adamw")
    jstep, _ = jax_make_train_step(jm, jopt, microbatches=4)
    jp, _, jmet = jax.jit(jstep)(tree, jopt.init(tree), batch, jnp.int32(0))
    assert outs[4][1] == pytest.approx(float(jmet["loss"]), rel=1e-6)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(tree_leaves(outs[4][0]), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def _pipeline_batches(cfg, batch=8, seq=64, n_shards=2):
    pipe = lm_pipeline(cfg.vocab_size, batch=batch, seq=seq, n_shards=n_shards, seed=0)
    return pipe, ({k: torch.from_numpy(v) for k, v in b.items()} for b in pipe)


def test_loss_decreases():
    cfg = reduced(get_config("qwen3-32b")).replace(train_microbatches=2)
    model = LM(cfg, device="cpu")
    pipe, batches = _pipeline_batches(cfg)
    state, hist = train_loop(model, batches, steps=50,
                             schedule=optim.warmup_cosine(3e-3, 10, 200))
    pipe.close()
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5
    assert state.step == 50
    assert [h["step"] for h in hist] == list(range(50))
    assert sum(h["retries"] for h in hist) == 0
    assert all(np.isfinite(h["grad_norm"]) and h["lr"] > 0 for h in hist)


def test_loop_retries_a_step_that_failed_before_writing():
    """A step that raises before its update is retried from untouched
    state, counted, and ends where an undisturbed run ends (bitwise)."""
    cfg = reduced(get_config("deepseek-67b"))
    runs = []
    for fail_at in (None, 1):
        model = LM(cfg, device="cpu")
        calls = {"n": 0}
        loss_fn = model.loss_fn

        def flaky(params, batch, loss_fn=loss_fn, calls=calls, fail_at=fail_at):
            calls["n"] += 1
            if fail_at is not None and calls["n"] == fail_at + 1:   # step 1's first try
                raise RuntimeError("transient")
            return loss_fn(params, batch)

        model.loss_fn = flaky
        pipe, batches = _pipeline_batches(cfg, batch=4, seq=16)
        state, hist = train_loop(model, batches, steps=3)
        pipe.close()
        runs.append((state, hist))
    (clean, hist0), (retried, hist1) = runs
    assert [h["retries"] for h in hist0] == [0, 0, 0]
    assert [h["retries"] for h in hist1] == [0, 1, 0]
    assert [h["loss"] for h in hist0] == [h["loss"] for h in hist1]
    for a, b in zip(tree_leaves(clean.params), tree_leaves(retried.params)):
        assert torch.equal(a, b)


def test_update_failure_is_not_retried(monkeypatch):
    """An update that fails after its first write leaves half-updated
    state: the loop raises at once instead of retrying from it."""
    from repro_torch.train import loop

    cfg = reduced(get_config("deepseek-67b"))
    calls = {"n": 0}
    real = optim.adamw()

    def update(grads, state, params, lr):
        calls["n"] += 1
        next(iter(tree_leaves(params))).zero_()
        raise RuntimeError("device lost mid-update")

    monkeypatch.setattr(loop, "make_optimizer",
                        lambda name: optim.Optimizer(real.init, update))
    pipe, batches = _pipeline_batches(cfg, batch=2, seq=16)
    with pytest.raises(UpdateInterrupted):
        train_loop(LM(cfg, device="cpu"), batches, steps=2, max_retries=2)
    pipe.close()
    assert calls["n"] == 1
