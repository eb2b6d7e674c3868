"""The port's checkpoints: ``repro``'s layout and contracts, and restores
across the two packages.

Round trip (fp32, bf16, a 0-d int32 count) bitwise, shape mismatch and a
missing leaf rejected, the sha256 check, ``AsyncCheckpointer``'s gc and its
host copy taken at ``save``; leaf paths and order equal to
``repro.train.checkpoint._flatten_with_paths`` on a model's parameters and
optimizer state; a checkpoint written by either package restored by the
other (fp32, bitwise); and a step from a restored state bitwise the step
from the in-memory one.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM, params_from_jax  # noqa: E402
from repro_torch.train.checkpoint import (AsyncCheckpointer, _flatten_with_paths,  # noqa: E402
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optim import make_optimizer, opt_state_from_jax  # noqa: E402
from test_torch_train_model import one_thread  # noqa: E402,F401  (autouse)


def _tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(3),
                   "h": torch.linspace(-2, 2, 6).bfloat16()},
        "opt": {"count": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "step_5", tree)
    back = restore_checkpoint(tmp_path / "step_5", tree, verify=True)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert _equal(a, b)
    manifest = json.loads((tmp_path / "step_5" / "MANIFEST.json").read_text())
    assert [e["dtype"] for e in manifest["leaves"]] == ["int32", "float32", "|V2", "float32"]
    assert not (tmp_path / "step_5" / "MANIFEST.json.tmp").exists()


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "s", tree)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path / "s", bad)
    extra = _tree()
    extra["params"]["new"] = torch.zeros(2)
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path / "s", extra)


def test_checksum_mismatch_rejected(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "s", tree)
    ent = json.loads((tmp_path / "s" / "MANIFEST.json").read_text())["leaves"][1]
    arr = np.load(tmp_path / "s" / ent["file"])
    np.save(tmp_path / "s" / ent["file"], arr + 1)
    restore_checkpoint(tmp_path / "s", tree)            # unverified: loads
    with pytest.raises(IOError):
        restore_checkpoint(tmp_path / "s", tree, verify=True)


def test_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    x = torch.zeros(3)
    for s in (1, 2, 3, 4):
        x.fill_(s)
        ck.save(s, {"x": x})
        x.fill_(-1)             # an in-place update after save changes no checkpoint
    ck.wait()
    assert latest_step(tmp_path) == 4
    kept = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir())
    assert kept == [3, 4]
    back = restore_checkpoint(tmp_path / "step_4", {"x": torch.zeros(3)})
    assert torch.equal(back["x"], torch.full((3,), 4.0))
    assert latest_step(tmp_path / "absent") is None


def _states(name, opt_name):
    jcfg = jax_reduced(jax_get_config(name))
    cfg = reduced(get_config(name))
    jm = JaxLM(jcfg)
    tree = jm.init(jax.random.PRNGKey(0))
    jtree = jax.tree.map(np.asarray, {"params": tree,
                                      "opt_state": jax_make_optimizer(opt_name).init(tree)})
    port = {"params": params_from_jax(cfg, jtree["params"], "cpu"),
            "opt_state": opt_state_from_jax(cfg, opt_name, jtree["opt_state"], "cpu")}
    return cfg, jtree, port


@pytest.mark.parametrize("name,opt_name", [("deepseek-v2-236b", "adamw"),
                                           ("whisper-large-v3", "adafactor")])
def test_leaf_paths_are_the_reference_keypaths(name, opt_name):
    _, jtree, port = _states(name, opt_name)
    jpaths, _, _ = jax_ckpt._flatten_with_paths(jtree)
    paths, _ = _flatten_with_paths(port)
    assert paths == jpaths
    assert "['params']/['segments']/[0]/['p0']/['ln1']" in paths
    assert "['opt_state']/['count']" in paths


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_cross_package_restore(tmp_path, opt_name):
    """fp32 checkpoints written by either package restore, bitwise, in the
    other."""
    _, jtree, port = _states("jamba-v0.1-52b", opt_name)
    rng = np.random.default_rng(0)
    jtree = jax.tree.map(lambda x: (x + rng.standard_normal(x.shape)).astype(x.dtype)
                         if x.ndim else x, jtree)
    jax_ckpt.save_checkpoint(tmp_path / "from_jax", jtree)
    back = restore_checkpoint(tmp_path / "from_jax", port, verify=True)
    paths, leaves = _flatten_with_paths(back)
    jpaths, jleaves, _ = jax_ckpt._flatten_with_paths(jtree)
    assert paths == jpaths
    for a, b in zip(leaves, jleaves):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)

    save_checkpoint(tmp_path / "from_port", back)
    jback = jax_ckpt.restore_checkpoint(tmp_path / "from_port", jtree, verify=True)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_step_from_restored_state_is_bitwise(tmp_path):
    cfg = reduced(get_config("deepseek-67b"))
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step, _ = make_train_step(model, opt, microbatches=1)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
        batches.append({"tokens": toks[:, :16], "targets": toks[:, 1:]})
    for i in range(2):
        params, state, _ = step(params, state, batches[i], i)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(2, {"params": params, "opt_state": state})
    ck.wait()
    back = restore_checkpoint(tmp_path / f"step_{latest_step(tmp_path)}",
                              {"params": params, "opt_state": state}, verify=True)
    for a, b in zip(tree_leaves(back), tree_leaves({"params": params, "opt_state": state})):
        assert _equal(a, b)
    p1, _, m1 = step(params, state, batches[2], 2)
    p2, _, m2 = step(back["params"], back["opt_state"], batches[2], 2)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)
