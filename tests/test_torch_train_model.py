"""The port's training entry points against ``repro``'s, arch by arch.

For each reduced config (b 2, s 32, fp32; weights from ``repro``'s
``LM.init`` through ``params_from_jax``, tokens and the context features
of the cross stacks from ``np.random.default_rng``): ``LM.loss_fn`` and
its gradients with the whole-sequence cross-entropy and with
``logit_chunk`` 8 against ``jax.value_and_grad`` of ``repro``'s, and one
``make_train_step`` step (AdamW, lr 1e-3) against ``repro``'s jitted
step from the same parameters and optimizer state.  This file holds six
archs; ``test_torch_train_archs.py`` the other five.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.common import tree_items_sorted, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optim import make_optimizer, opt_state_from_jax, warmup_cosine  # noqa: E402

ARCHS = ("deepseek-67b", "deepseek-v2-236b", "nemotron-4-340b", "kimi-k2-1t-a32b",
         "mixtral-8x7b", "phi3-medium-14b")
CHUNK = 8
LR = 1e-3
# fp32 on the CPU, XLA against torch (measured: loss within 9.6e-7, the
# gradients' worst leaf 1.1e-5 normwise, an SSD leaf; 6e-7 elsewhere)
LOSS_ATOL = 1e-5
GRAD_NORMWISE = 1e-4
# parameters after one AdamW step: ‖port − repro‖ / ‖repro − before‖ per
# leaf, against the update's size.  A first AdamW step is g/(|g| + eps)·lr,
# so an element whose gradient is within rounding of 0 moves by a different
# fraction of lr (measured: worst 4.7e-4, jamba's attention wv, 2 of 2048
# elements off by 2.1e-5; 2.0e-4 elsewhere)
STEP_NORMWISE = 2e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small shapes: the suite runs several
    pytest-xdist workers on the same cores, where torch's thread pools slow
    each other's small ops many times over (a 50-step loop: 2 s alone, 250 s
    beside five busy workers).  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def setup(name: str, chunk: int = 0):
    jcfg = jax_reduced(jax_get_config(name)).replace(logit_chunk=chunk)
    cfg = reduced(get_config(name)).replace(logit_chunk=chunk)
    jm = JaxLM(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :32], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        batch["enc_feats"] = (0.1 * rng.standard_normal(
            (2, cfg.encoder_context, cfg.d_model))).astype(np.float32)
    if cfg.vision_context:
        batch["image_embeds"] = (0.1 * rng.standard_normal(
            (2, cfg.vision_context, cfg.d_model))).astype(np.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jm, tree, batch, LM(cfg, device="cpu"), tbatch


def port_loss_and_grads(model, params, batch):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def check_loss_and_grads(name: str, chunk: int) -> None:
    jcfg, cfg, jm, tree, batch, tm, tbatch = setup(name, chunk)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(tree, batch)
    loss, met, grads = port_loss_and_grads(tm, params_from_jax(cfg, tree, "cpu"), tbatch)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= LOSS_ATOL
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= LOSS_ATOL
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    jleaves = jax.tree.leaves(jgrads)
    items = tree_items_sorted(grads)
    assert len(items) == len(jleaves)
    for (path, g), j in zip(items, jleaves):
        assert tuple(g.shape) == j.shape, path
        assert np.isfinite(g.numpy()).all(), path
        assert normwise(g.numpy(), j) <= GRAD_NORMWISE, path


def check_train_step(name: str) -> None:
    jcfg, cfg, jm, tree, batch, tm, tbatch = setup(name)
    jopt = jax_make_optimizer(jcfg.optimizer)
    jstate = jax.tree.map(np.asarray, jopt.init(tree))
    jstep, _ = jax_make_train_step(jm, jopt, microbatches=1,
                                   schedule=jax_warmup_cosine(LR, 0, 10))
    jp, _, jmet = jax.jit(jstep)(tree, jstate, batch, jnp.int32(0))

    params = params_from_jax(cfg, tree, "cpu")
    state = opt_state_from_jax(cfg, cfg.optimizer, jstate, "cpu")
    step, _ = make_train_step(tm, make_optimizer(cfg.optimizer), microbatches=1,
                              schedule=warmup_cosine(LR, 0, 10))
    params, state, met = step(params, state, tbatch, 0)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_ATOL
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
    assert float(met["lr"]) == float(jmet["lr"]) == pytest.approx(LR)
    assert int(state["count"]) == 1
    before = jax.tree.leaves(tree)
    for (path, p), j, b in zip(tree_items_sorted(params), jax.tree.leaves(jp), before):
        j = np.asarray(j)
        moved = np.linalg.norm(j - b)
        assert moved > 0, path
        assert np.linalg.norm(p.numpy() - j) <= STEP_NORMWISE * moved, path


@pytest.mark.parametrize("chunk", [0, CHUNK])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name, chunk):
    check_loss_and_grads(name, chunk)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    check_train_step(name)
