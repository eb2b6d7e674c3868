"""The port's model registry (``models/registry.py``) and
``common.shape_structs`` against ``repro``'s.

For every registered arch × its ``cells_for`` × both production meshes
(16×16 and 2×16×16), at full size and with nothing allocated, each
parameter, optimizer-state (AdamW and Adafactor), batch and cache leaf has
``repro``'s global shape, dtype and per-device shape
(``struct.sharding.shard_shape``), so the same per-device bytes.  One
subprocess builds both sides: ``repro``'s on 512 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``), the port's as
``DTensor`` s on a fake process group of 256, then 512 ranks; the tests
read its file.

``repro``'s ``ModelBundle.cache_structs`` runs ``eval_shape`` of the
prefill on sharded structs, which this JAX refuses (its gather of the
sharded embedding raises ``DuplicateSpecError``); the script runs that
``eval_shape`` on the same structs without their shardings and attaches
``repro``'s own ``_CACHE_AXES`` through ``repro``'s ``safe_sharding``, as
``cache_structs`` does.
"""
import json
import os
import resource
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import get_bundle as jax_get_bundle  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.models.common import (shape_structs, struct_bytes,  # noqa: E402
                                       tree_items_sorted, tree_leaves)
from repro_torch.models.lm import LM, param_specs  # noqa: E402
from repro_torch.models.registry import ModelBundle, get_bundle  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
NAMES = sorted(ARCHS)

SCRIPT = textwrap.dedent("""
    import json, os, sys
    import jax
    from repro.configs import ARCHS, SHAPES, cells_for, get_config
    from repro.distributed.sharding import safe_sharding
    from repro.launch.dryrun import _rules_for
    from repro.launch.mesh import make_production_mesh
    from repro.models.registry import _CACHE_AXES, get_bundle
    from repro.train.optim import make_optimizer

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config as port_config
    from repro_torch.launch import dryrun as port_dryrun
    from repro_torch.launch.mesh import make_production_mesh as port_mesh
    from repro_torch.models.common import struct_bytes, struct_shape, tree_items_sorted
    from repro_torch.models.registry import get_bundle as port_bundle
    from repro_torch.train.optim import make_optimizer as port_optimizer

    def key(path):
        return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)

    def jdump(tree):
        return {key(p): [list(l.shape), list(l.sharding.shard_shape(l.shape)), str(l.dtype),
                         int(np.prod(l.sharding.shard_shape(l.shape))) * l.dtype.itemsize]
                for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def pdump(tree):
        return {"/".join(map(str, p)): [list(l.shape), list(struct_shape(l)),
                                        str(l.dtype).replace("torch.", ""), struct_bytes(l)]
                for p, l in tree_items_sorted(tree)}

    import numpy as np
    strip = lambda t: jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), t)

    def jax_cache(b, shape, rules, mesh, params, memo={}):
        k = (b.cfg.name, shape.name)
        if k not in memo:
            _, memo[k] = jax.eval_shape(b.model.prefill, strip(params),
                                        strip(b.prefill_batch_structs(shape, rules, mesh)))

        def attach(path, leaf):
            name = next((p.key for p in reversed(path) if hasattr(p, "key")), None)
            axes = _CACHE_AXES.get(name, (None,) * len(leaf.shape))
            if len(axes) != len(leaf.shape):
                axes = (None,) * len(leaf.shape)
            return jax.ShapeDtypeStruct(leaf.shape, leaf.dtype,
                                        sharding=safe_sharding(leaf.shape, axes, rules, mesh))
        gb = shape.global_batch
        tok = jax.ShapeDtypeStruct((gb, 1), jax.numpy.int32,
                                   sharding=safe_sharding((gb, 1), ("batch", None), rules, mesh))
        pos = jax.ShapeDtypeStruct((gb,), jax.numpy.int32,
                                   sharding=safe_sharding((gb,), ("batch",), rules, mesh))
        return jax.tree_util.tree_map_with_path(attach, memo[k]), tok, pos

    out = {"repro": {}, "port": {}}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi else 256)
        pmesh = port_mesh(multi_pod=multi, device_type="cpu")
        for name in sorted(ARCHS):
            cfg, pcfg = get_config(name), port_config(name)
            b, pb = get_bundle(cfg), port_bundle(pcfg)
            for cell in cells_for(cfg):
                shape = SHAPES[cell]
                rules = _rules_for(cfg, shape, multi_pod=multi)
                prules = port_dryrun._rules_for(pcfg, shape, multi_pod=multi)
                params, pparams = b.param_structs(rules, mesh), pb.param_structs(prules, pmesh)
                r = {"params": jdump(params)}
                p = {"params": pdump(pparams)}
                if shape.kind == "train":
                    for o in ("adamw", "adafactor"):
                        r["opt_" + o] = jdump(b.opt_state_structs(make_optimizer(o), params,
                                                                  rules, mesh))
                        p["opt_" + o] = pdump(pb.opt_state_structs(port_optimizer(o), pparams,
                                                                   prules, pmesh))
                    r["batch"] = jdump(b.train_batch_structs(shape, rules, mesh))
                    p["batch"] = pdump(pb.train_batch_structs(shape, prules, pmesh))
                elif shape.kind == "prefill":
                    r["batch"] = jdump(b.prefill_batch_structs(shape, rules, mesh))
                    p["batch"] = pdump(pb.prefill_batch_structs(shape, prules, pmesh))
                else:
                    c, t, s = jax_cache(b, shape, rules, mesh, params)
                    r.update(cache=jdump(c), tokens=jdump(t), pos=jdump(s))
                    c, t, s = pb.decode_args_structs(shape, prules, pmesh, pparams)
                    p.update(cache=pdump(c), tokens=pdump(t), pos=pdump(s))
                k = f"{name}|{cell}|{'multi' if multi else 'single'}"
                out["repro"][k], out["port"][k] = r, p
        dist.destroy_process_group()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def structs(tmp_path_factory):
    path = tmp_path_factory.mktemp("registry") / "structs.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("name", NAMES)
def test_structs_match_repro_shard_shapes(structs, name, mesh):
    """Global shape, per-device shape, dtype and per-device bytes of every
    leaf of every cell equal ``repro``'s."""
    keys = [k for k in structs["repro"] if k.startswith(name + "|") and k.endswith(mesh)]
    assert len(keys) == len([c for c in SHAPES if f"{name}|{c}|{mesh}" in structs["repro"]])
    assert keys
    for k in keys:
        want, got = structs["repro"][k], structs["port"][k]
        assert sorted(got) == sorted(want), k
        for part in want:
            assert got[part] == want[part], (k, part)


@pytest.mark.parametrize("name", NAMES)
def test_n_params_matches_repro(name):
    assert get_bundle(get_config(name)).n_params == jax_get_bundle(jax_get_config(name)).n_params


def test_shape_structs_are_meta_and_cost_nothing():
    """A full-size kimi-k2-1t-a32b bundle's parameter and Adafactor state
    structs (10¹² parameters) allocate nothing: resident memory grows by
    the structs' metadata alone."""
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    cfg = get_config("kimi-k2-1t-a32b")
    before = rss()
    b = ModelBundle(cfg=cfg, model=LM(cfg, device="meta"))
    params = b.param_structs(None, None)
    state = b.opt_state_structs(make_optimizer("adafactor"), params, None, None)
    grew = rss() - before
    leaves = tree_leaves(params) + tree_leaves(state)
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in tree_leaves(params)) == b.n_params > 10 ** 12
    assert grew < 64 << 20, grew
    specs = param_specs(cfg)
    direct = shape_structs(specs, torch.bfloat16)
    assert [tuple(x.shape) for x in tree_leaves(direct)] == [tuple(x.shape) for x in tree_leaves(params)]
    assert sum(struct_bytes(x) for x in tree_leaves(direct)) == 2 * b.n_params


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "jamba-v0.1-52b", "whisper-large-v3"])
def test_cache_structs_are_the_prefill_cache(name):
    """With no mesh, a decode cell's cache structs at capacity S are the
    leaves of the port's own prefill over S tokens (real tensors, reduced
    config): same paths, shapes and dtypes."""
    from repro_torch.configs.base import ShapeSpec

    cfg = reduced(get_config(name))
    model = LM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))}
    if cfg.encoder_layers:
        batch["enc_feats"] = torch.zeros((2, cfg.encoder_context, cfg.d_model))
    _, caches = model.prefill(params, batch)
    structs, tokens, pos = ModelBundle(cfg=cfg, model=model).decode_args_structs(
        ShapeSpec("t", 32, 2, "decode"), None, None)
    got = [(p, tuple(x.shape), x.dtype) for p, x in tree_items_sorted(structs)]
    want = [(p, tuple(x.shape), x.dtype) for p, x in tree_items_sorted(caches)]
    assert got == want
    assert tuple(tokens.shape) == (2, 1) and tuple(pos.shape) == (2,)


def test_with_depth_cuts_periods_only():
    """``with_depth`` keeps every width and cuts each segment's periods."""
    cfg = get_config("kimi-k2-1t-a32b")
    b = get_bundle(cfg)
    full = b.depth
    cut = b.with_depth([1] * len(full))
    assert cut.depth == [1] * len(full)
    for (p1, _), (p2, _) in zip(b.model.segments, cut.model.segments):
        assert p1 == p2
    got = {p: s.shape[1:] for p, s in tree_items_sorted(cut.model.specs)}
    want = {p: s.shape[1:] for p, s in tree_items_sorted(b.model.specs)}
    assert got == want
