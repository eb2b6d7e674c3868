"""Meshes and resharded restore of the port (``launch/mesh.py``,
``restore_checkpoint(shardings=)``, ``safe_spec`` / ``placements`` on a
``DeviceMesh``, ``constrain`` on a ``DTensor``), in one subprocess:

* a fake process group (``FakeStore``, backend ``"fake"``) of 256, then
  512 ranks builds ``repro``'s production meshes and a host mesh;
* a world-size-1 gloo group restores a checkpoint onto a (1, 1) mesh with
  the placements asked for (``test_train_ckpt.py::test_elastic_reshard``);
* two gloo processes (one ``torch.multiprocessing.spawn``) restore the same
  checkpoint, written without a mesh, FSDP-sharded over ``data``: every
  leaf's ``full_tensor()`` is the saved tensor bitwise; and ``constrain``
  redistributes a ``DTensor`` to its spec's placements, values unchanged.

The checks write their results to a file; the tests only read it.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")

SCRIPT = textwrap.dedent("""
    import json, sys
    from datetime import timedelta
    from pathlib import Path
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import (P, constrain, make_rules, placements,
                                                  safe_sharding, safe_spec, shardings_for,
                                                  use_rules)
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_devices
    from repro_torch.models.common import axes_tree, tree_items_sorted, tree_leaves
    from repro_torch.models.lm import LM, param_specs
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optim import make_optimizer

    TMP = Path(sys.argv[1])
    TIMEOUT = timedelta(seconds=120)

    def names(pl):
        return [repr(p) for p in pl]

    def fake_meshes(out):
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
            try:
                m = make_production_mesh(multi_pod=multi, device_type="cpu")
                out[f"production_{multi}"] = [list(m.shape), list(m.mesh_dim_names),
                                              mesh_devices(m)]
                if multi:
                    cfg = get_config("deepseek-67b")
                    shape_mesh = type("M", (), {"shape": {"pod": 2, "data": 16, "model": 16}})()
                    rules = make_rules(multi_pod=True, fsdp=True)
                    specs = [s for _, s in tree_items_sorted(param_specs(cfg))]
                    out["safe_spec_same"] = all(
                        safe_spec(s.shape, s.axes, rules, m)
                        == safe_spec(s.shape, s.axes, rules, shape_mesh) for s in specs)
                    out["spec_pod_data"] = list(safe_spec((64, 4096), ("batch", None),
                                                          rules, m))
                    out["placements_pod_data"] = names(
                        placements(P(("pod", "data"), None), m))
                    out["placements_heads"] = names(placements(
                        safe_spec((8192, 64, 128), ("embed", "heads", None), rules, m), m))
                    host = make_host_mesh(model_parallel=4, device_type="cpu")
                    out["host"] = [list(host.shape), list(host.mesh_dim_names)]
            finally:
                dist.destroy_process_group()

    def tree(cfg):
        model = LM(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        return {"params": params, "opt_state": make_optimizer("adamw").init(params)}

    def one_rank(out, ckpt, cfg):
        dist.init_process_group("gloo", init_method=f"file://{TMP / 'rendezvous1'}", rank=0,
                                world_size=1, timeout=TIMEOUT)
        try:
            mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
            like = tree(cfg)
            shardings = dict_of(mesh, like, (Replicate(), Replicate()))
            shardings["params"]["embed"] = (mesh, (Shard(1), Replicate()))
            back = restore_checkpoint(ckpt, like, shardings=shardings)
            out["one_rank_embed"] = names(back["params"]["embed"].placements)
            out["one_rank_count"] = names(back["opt_state"]["count"].placements)
            saved = restore_checkpoint(ckpt, like)
            out["one_rank_equal"] = all(
                torch.equal(a.full_tensor(), b) and a.dtype == b.dtype
                for a, b in zip(tree_leaves(back), tree_leaves(saved)))
        finally:
            dist.destroy_process_group()

    def dict_of(mesh, t, pl):
        if isinstance(t, dict):
            return {k: dict_of(mesh, v, pl) for k, v in t.items()}
        if isinstance(t, list):
            return [dict_of(mesh, v, pl) for v in t]
        return (mesh, pl)

    def two_ranks(rank, ckpt):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{TMP / 'rendezvous2'}",
                                rank=rank, world_size=2, timeout=TIMEOUT)
        out = {}
        try:
            mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
            cfg = reduced(get_config("qwen3-32b"))
            like = tree(cfg)
            rules = make_rules(fsdp=True)
            sh = shardings_for(axes_tree(param_specs(cfg)), rules, mesh)
            shardings = {"params": sh,
                         "opt_state": {"m": sh, "v": sh,
                                       "count": (mesh, (Replicate(), Replicate()))}}
            back = restore_checkpoint(ckpt, like, shardings=shardings)
            saved = restore_checkpoint(ckpt, like)
            out["embed"] = names(back["params"]["embed"].placements)
            out["embed_local"] = list(back["params"]["embed"].to_local().shape)
            out["equal"] = all(torch.equal(a.full_tensor(), b)
                               for a, b in zip(tree_leaves(back), tree_leaves(saved)))
            out["n_leaves"] = len(tree_leaves(back))
            g = torch.Generator().manual_seed(1)
            full = torch.randn(4, 6, 512, generator=g)
            x = distribute_tensor(full, mesh, (Replicate(), Replicate()))
            with use_rules(make_rules(), mesh) as calls:
                y = constrain(x, "batch", None, "vocab")
            out["constrained"] = names(y.placements)
            out["constrained_equal"] = torch.equal(y.full_tensor(), full)
            out["calls"] = [[list(k), v] for k, v in calls.items()]
            out["safe_sharding"] = names(safe_sharding((4, 6, 512), ("batch", None, "vocab"),
                                                       make_rules(), mesh)[1])
        finally:
            dist.destroy_process_group()
        (TMP / f"rank{rank}.json").write_text(json.dumps(out))

    if __name__ == "__main__":
        out = {}
        fake_meshes(out)
        ckpt = TMP / "ckpt"
        save_checkpoint(ckpt, tree(reduced(get_config("qwen3-32b"))))
        one_rank(out, ckpt, reduced(get_config("qwen3-32b")))
        mp.spawn(two_ranks, args=(ckpt,), nprocs=2, join=True)
        out["two"] = [json.loads((TMP / f"rank{r}.json").read_text()) for r in range(2)]
        (TMP / "out.json").write_text(json.dumps(out))
""")


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    (tmp / "script.py").write_text(SCRIPT)
    res = subprocess.run([sys.executable, str(tmp / "script.py"), str(tmp)],
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "HOME": str(tmp),
                              "OMP_NUM_THREADS": "1"},
                         cwd=tmp, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text())


def test_production_meshes_have_the_reference_shapes(out):
    assert out["production_False"] == [[16, 16], ["data", "model"], 256]
    assert out["production_True"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert out["host"] == [[128, 4], ["data", "model"]]


def test_safe_spec_on_a_device_mesh(out):
    assert out["safe_spec_same"]
    mesh = type("M", (), {"shape": {"pod": 2, "data": 16, "model": 16}})()
    want = jax_sharding.safe_spec((64, 4096), ("batch", None),
                                  jax_sharding.make_rules(multi_pod=True, fsdp=True), mesh)
    assert [tuple(e) if isinstance(e, list) else e for e in out["spec_pod_data"]] \
        == list(want)
    # ("pod", "data") shards one dimension over both, in the mesh's order
    assert out["placements_pod_data"] == ["Shard(dim=0)", "Shard(dim=0)", "Replicate()"]
    # 64 heads over 16: heads on model, embed on data (FSDP)
    assert out["placements_heads"] == ["Replicate()", "Shard(dim=0)", "Shard(dim=1)"]


def test_restore_places_leaves_on_a_one_by_one_mesh(out):
    assert out["one_rank_embed"] == ["Shard(dim=1)", "Replicate()"]
    assert out["one_rank_count"] == ["Replicate()", "Replicate()"]
    assert out["one_rank_equal"]


def test_resharded_restore_on_two_ranks_is_bitwise(out):
    n_params = len(jax.tree.leaves(JaxLM(jax_reduced(jax_get_config("qwen3-32b"))).specs,
                                   is_leaf=lambda x: hasattr(x, "axes")))
    for r in out["two"]:
        assert r["equal"]
        assert r["n_leaves"] == 3 * n_params + 1          # params, m, v, count
        # FSDP: embed over data; vocab over model (of size 1)
        assert r["embed"] == ["Shard(dim=1)", "Shard(dim=0)"]
        assert r["embed_local"] == [512, 32]


def test_constrain_redistributes_a_dtensor_and_keeps_its_values(out):
    for r in out["two"]:
        assert r["constrained"] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert r["constrained"] == r["safe_sharding"]
        assert r["constrained_equal"]
        assert r["calls"] == [[["batch", None, "vocab"], 1]]
