"""The port's spec layer and sharding rules against ``repro``'s, in-process.

Logical axes, parameter counts and bytes for every registered config (full
and reduced); twins of ``test_distributed.py``'s sharding cases; a sweep of
``safe_spec`` and ``param_pspecs`` over every leaf of every full config
under three rule sets on the shape-only mesh {pod 2, data 16, model 16};
``strip_axis`` / ``with_overrides``; and ``constrain``: the identity
outside a context, and called at ``repro``'s hook sites with ``repro``'s
axes (its calls counted by a wrapper on ``repro.models.{lm,moe}.constrain``
with ``jax.disable_jit``, so every scanned layer calls it, against the
port's own count inside a rules context).
"""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.lm as jax_lm  # noqa: E402
import repro.models.moe as jax_moe  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.distributed.sharding import (P, active, constrain, make_rules,  # noqa: E402
                                              param_pspecs, safe_spec, strip_axis,
                                              use_rules)
from repro_torch.models.common import axes_tree, param_bytes, param_count  # noqa: E402
from repro_torch.models.lm import LM, ParamSpec, param_specs  # noqa: E402


class FakeMesh:
    """Shape-only stand-in: safe_spec reads mesh.shape, never devices."""
    shape = {"data": 16, "model": 16, "pod": 2}


RULES = {"default": {}, "fsdp": {"fsdp": True}, "multi_pod": {"multi_pod": True}}


def _config(name: str, size: str):
    if size == "full":
        return get_config(name), jax_get_config(name)
    return reduced(get_config(name)), jax_reduced(jax_get_config(name))


def _flat(tree, path=()):
    """(path, leaf) pairs, dict keys sorted; tuples (axes, specs) are leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _spec_leaves(specs):
    return [(path, s) for path, s in _flat(specs)]


def test_list_archs_matches_reference():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", jax_list_archs())
def test_axes_count_and_bytes_match_reference(name, size):
    cfg, jcfg = _config(name, size)
    specs, jspecs = param_specs(cfg), jax_lm.LM(jcfg).specs
    assert axes_tree(specs) == jax_common.axes_tree(jspecs)
    assert [p for p, _ in _spec_leaves(specs)] == [p for p, _ in _spec_leaves(jspecs)]
    assert param_count(specs) == jax_common.param_count(jspecs)
    assert param_bytes(specs, torch.bfloat16) == jax_common.param_bytes(jspecs, jnp.bfloat16)
    assert param_bytes(specs, torch.float32) == jax_common.param_bytes(jspecs, jnp.float32)
    for (path, s), (_, js) in zip(_spec_leaves(specs), _spec_leaves(jspecs)):
        assert (s.shape, s.init, s.scale) == (js.shape, js.init, js.scale), path


def test_param_spec_needs_one_axis_per_dimension():
    assert ParamSpec((4, 8), ("embed", None)).axes == ("embed", None)
    with pytest.raises(AssertionError):
        ParamSpec((4, 8), ("embed",))


# -- twins of tests/test_distributed.py::TestShardingRules -------------------

def test_safe_spec_divisible():
    spec = safe_spec((102400, 8192), ("vocab", "embed"), make_rules(), FakeMesh())
    assert spec == P("model", None)
    assert spec == tuple(jax_sharding.P("model", None))


def test_safe_spec_rehomes_heads_to_head_dim():
    # 40 heads don't divide 16 → TP re-homes to head_dim 128
    spec = safe_spec((5120, 40, 128), ("embed", "heads", None), make_rules(), FakeMesh())
    assert spec == P(None, None, "model")


def test_safe_spec_drops_indivisible():
    spec = safe_spec((50280, 768), ("vocab", "embed"), make_rules(), FakeMesh())
    assert spec == P(None, None)  # 50280 % 16 ≠ 0, no other dim fits


def test_no_duplicate_mesh_axes():
    spec = safe_spec((16, 16), ("embed", "embed"), make_rules(fsdp=True), FakeMesh())
    flat = [s for s in spec if s is not None]
    assert len(flat) == len(set(flat))


def test_multipod_batch_axes():
    assert make_rules(multi_pod=True).rules["batch"] == ("pod", "data")


# -- the sweep ------------------------------------------------------------------

@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("name", jax_list_archs())
def test_safe_spec_and_pspecs_match_reference_on_every_leaf(name, rules):
    cfg, jcfg = _config(name, "full")
    port_rules = make_rules(**RULES[rules])
    ref_rules = jax_sharding.make_rules(**RULES[rules])
    assert port_rules.rules == ref_rules.rules
    leaves = _spec_leaves(param_specs(cfg))
    for (path, s), (_, js) in zip(leaves, _spec_leaves(jax_lm.LM(jcfg).specs)):
        got = safe_spec(s.shape, s.axes, port_rules, FakeMesh())
        want = jax_sharding.safe_spec(js.shape, js.axes, ref_rules, FakeMesh())
        assert isinstance(got, P) and got == tuple(want), (path, got, want)
    got = _flat(param_pspecs(axes_tree(param_specs(cfg)), port_rules))
    want = _flat(jax_sharding.param_pspecs(jax_common.axes_tree(jax_lm.LM(jcfg).specs),
                                           ref_rules))
    assert [(p, tuple(s)) for p, s in got] == [(p, tuple(s)) for p, s in want]


@pytest.mark.parametrize("axis", ["pod", "data", "model"])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_strip_axis_and_overrides_match_reference(rules, axis):
    port, ref = make_rules(**RULES[rules]), jax_sharding.make_rules(**RULES[rules])
    assert strip_axis(port, axis).rules == jax_sharding.strip_axis(ref, axis).rules
    kw = {"embed": "data", "batch": None, "seq": ("pod", "model")}
    assert port.with_overrides(**kw).rules == ref.with_overrides(**kw).rules
    assert port.rules == ref.rules          # overrides make a copy


# -- constrain -------------------------------------------------------------------

def test_constrain_is_the_identity_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert active() is None
    assert constrain(x, "batch", "seq", None) is x
    with use_rules(make_rules(), FakeMesh()) as calls:
        assert active()[0].rules == make_rules().rules
        assert constrain(x, "batch", "seq", None) is x      # a local shard stays
        with use_rules(None, FakeMesh()) as inner:
            assert active() is None and constrain(x, "batch") is x
        assert not inner
    assert calls == {("batch", "seq", None): 1}
    assert active() is None and constrain(x, "batch") is x


def _reference_calls(jcfg, batch, entry):
    calls = collections.Counter()
    orig = jax_sharding.constrain

    def counting(x, *axes):
        calls[axes] += 1
        return orig(x, *axes)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_lm, "constrain", counting)
    mp.setattr(jax_moe, "constrain", counting)
    try:
        m = jax_lm.LM(jcfg)
        params = m.init(jax.random.PRNGKey(0))
        with jax.disable_jit():
            if entry == "loss_fn":
                m.loss_fn(params, batch)
            else:
                m.prefill(params, {k: v for k, v in batch.items() if k != "targets"})
    finally:
        mp.undo()
    return calls


@pytest.mark.parametrize("entry", ["loss_fn", "prefill"])
@pytest.mark.parametrize("name,groups", [("qwen3-32b", 1), ("deepseek-v2-236b", 2),
                                         ("mixtral-8x7b", 1), ("whisper-large-v3", 1)])
def test_constrain_hook_sites_match_reference(name, groups, entry):
    cfg = reduced(get_config(name)).replace(moe_groups=groups)
    jcfg = jax_reduced(jax_get_config(name)).replace(moe_groups=groups)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :16], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        batch["enc_feats"] = rng.standard_normal(
            (2, cfg.encoder_context, cfg.d_model)).astype(np.float32)
    want = _reference_calls(jcfg, batch, entry)

    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad(), use_rules(make_rules(), FakeMesh()) as calls:
        if entry == "loss_fn":
            model.loss_fn(params, tbatch)
        else:
            model.prefill(params, {k: v for k, v in tbatch.items() if k != "targets"})
    assert dict(calls) == dict(want)
    if cfg.moe is not None:
        moe_sites = {("experts", None, None)} if groups == 1 else {
            ("moe_groups", None, None), ("moe_groups", None, None, None),
            (None, "experts", None, None)}
        assert moe_sites <= set(calls)
