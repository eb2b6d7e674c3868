"""The port's dry run (``launch/dryrun.py``) on a fake process group.

Three subprocesses run side by side and write files the tests read:

* a fake group of 4 ranks (``FakeStore``, backend ``"fake"``) traces every
  registered arch's ``cells_for`` cells, reduced, as rank 0 of a (2, 2)
  ``data`` × ``model`` mesh, and checks on reduced deepseek-67b cut to 4
  layers and 4 microbatches that the loop-aware count (one and two
  periods, one and two microbatches, extended) equals the full trace;
* a fake group of 8 does the same cells on a (2, 2, 2) ``pod`` × ``data``
  × ``model`` mesh, traces the ``--compress-pod`` cell (the multipod step
  over ``pod`` with the sharded program inside), and a train cell whose
  ranks hold fewer rows than its microbatches (reduced deepseek-v2-236b at
  128 microbatches: 64 rows a rank, so each pass runs 2 microbatches side
  by side) beside the same cell at 64;
* the command line at full size (``mamba2-130m`` ``long_500k`` on a fake
  group of 256 ranks).

The reduced configs take one KV block of 4,096 positions (``attn_block``)
and SSD chunks of 4,096 (``ssm.chunk``): the cells' sequences then run 1
to 8 trips of each loop instead of up to 1,024, through the same code.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import cells_for  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
NAMES = sorted(ARCHS)

SCRIPT = textwrap.dedent("""
    import dataclasses, json, logging, sys, traceback
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.configs.base import cells_for
    from repro_torch.launch.dryrun import build_cell, fake_group, trace_cell

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    multi = sys.argv[2] == "multi"
    fake_group(8 if multi else 4)
    mesh = init_device_mesh("cpu", (2, 2, 2) if multi else (2, 2),
                            mesh_dim_names=("pod", "data", "model") if multi
                            else ("data", "model"))

    def small(name):
        cfg = reduced(get_config(name)).replace(attn_block=4096)
        if cfg.ssm is not None:
            cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=4096))
        return cfg

    out = {"cells": {}, "loop_aware": {}}
    for name in sorted(ARCHS):
        for cell in cells_for(get_config(name)):
            try:
                rec = trace_cell(name, cell, multi_pod=multi, cfg=small(name), mesh=mesh,
                                 loop_aware=False)
                out["cells"][f"{name}|{cell}"] = {"ok": True, "rec": rec}
            except Exception:
                out["cells"][f"{name}|{cell}"] = {"ok": False, "error": traceback.format_exc()}
    if not multi:
        cfg = small("deepseek-67b").replace(n_layers=4, train_microbatches=4)
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            out["loop_aware"][cell] = [
                trace_cell("deepseek-67b", cell, cfg=cfg, mesh=mesh, loop_aware=la)
                for la in (False, True)]
    else:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.distributed.sharding import strip_axis
        from repro_torch.launch.dryrun import _rules_for
        from repro_torch.configs.base import SHAPES
        from repro_torch.models.common import struct_local, tree_leaves
        from repro_torch.models.registry import get_bundle

        cfg = small("deepseek-67b")
        out["compress_pod"] = trace_cell("deepseek-67b", "train_4k", multi_pod=True,
                                         compress_pod=True, cfg=cfg, mesh=mesh, loop_aware=False)
        rules = strip_axis(_rules_for(cfg, SHAPES["train_4k"], multi_pod=True), "pod")
        with FakeTensorMode():
            leaves = tree_leaves(get_bundle(cfg).param_structs(rules, mesh["data", "model"],
                                                               device="cpu"))
            out["local_params"] = (sum(struct_local(x).numel() for x in leaves), len(leaves))
        out["side_by_side"] = {
            k: trace_cell("deepseek-v2-236b", "train_4k", multi_pod=True, mesh=mesh,
                          cfg=small("deepseek-v2-236b").replace(train_microbatches=k))
            for k in (128, 64)}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three subprocesses, started together: {"single": its record,
    "multi": its record, "cli": (returncode, stdout, stderr, out dir)}."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {mesh: subprocess.Popen([sys.executable, "-c", SCRIPT, str(tmp / f"{mesh}.json"),
                                     mesh], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for mesh in ("single", "multi")}
    procs["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
         "--shape", "long_500k", "--out", str(tmp / "cli")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if key == "cli":
            out[key] = (proc.returncode, stdout, stderr, tmp / "cli")
        else:
            assert proc.returncode == 0, stderr[-4000:]
            out[key] = json.loads((tmp / f"{key}.json").read_text())
    return out


def check_cells(out: dict, name: str, devices: int) -> None:
    """Every cell of ``name`` traced, as rank 0 of ``devices``, with
    ``repro``'s record keys and per-device work to show."""
    for cell in cells_for(get_config(name)):
        got = out["cells"][f"{name}|{cell}"]
        assert got["ok"], got.get("error")
        rec = got["rec"]
        assert rec["devices"] == devices and rec["kind"] in ("train", "prefill", "decode")
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
        la = rec["loop_aware"]
        assert la["flops"] > 0 and la["op_bytes"] > 0
        assert rec["collectives"]["total_bytes"] == la["collective_bytes"] > 0
        assert {"flops", "collective_bytes", "collective_by_kind", "op_bytes"} <= set(la)
        assert rec["seconds"]["trace"] > 0


@pytest.fixture(scope="module")
def traced(runs):
    return runs["single"]


@pytest.mark.parametrize("name", NAMES)
def test_every_cell_traces_on_a_2x2_mesh(traced, name):
    check_cells(traced, name, 4)


@pytest.mark.parametrize("name", NAMES)
def test_every_cell_traces_on_a_2x2x2_mesh(runs, name):
    check_cells(runs["multi"], name, 8)


def test_compress_pod_cell_traces(runs):
    """The multipod step with tensor parallelism: the sharded program's
    FLOPs (the uncompressed multi-pod cell's: the exchange has no
    product), ``ef`` laid out like the parameters among the arguments."""
    multi = runs["multi"]
    rec = multi["compress_pod"]
    plain = multi["cells"]["deepseek-67b|train_4k"]["rec"]
    assert rec["devices"] == 8 and rec["kind"] == "train"
    assert rec["loop_aware"]["flops"] == plain["loop_aware"]["flops"] > 0
    ex = rec["loop_aware"]["pod_exchange"]
    local, _ = multi["local_params"]
    assert ex["ef_bytes"] == 4 * local
    assert rec["memory"]["argument_bytes"] == plain["memory"]["argument_bytes"] + ex["ef_bytes"]


def test_compress_pod_exchange_sends_each_local_shard_in_int8(runs):
    """Two all-gathers a leaf over ``pod``: a rank sends its shard's int8
    codes and one fp32 scale (the local parameter elements + 4 bytes a
    leaf), and receives both pods'."""
    multi = runs["multi"]
    ex = multi["compress_pod"]["loop_aware"]["pod_exchange"]
    local, leaves = multi["local_params"]
    assert ex["all_gathers"] == 2 * leaves
    assert ex["sent_bytes"] == local + 4 * leaves
    assert ex["received_bytes"] == 2 * ex["sent_bytes"]


def test_fewer_rows_than_microbatches_runs_them_side_by_side(runs):
    """64 rows a rank and 128 microbatches of 2 rows: the cell traces, its
    passes running 2 microbatches side by side (one row of each a rank), at
    the per-device FLOPs of the same cell at 64 microbatches (one row of
    each a rank; routing groups of 2 rows against 4) within 1 %."""
    k128, k64 = (runs["multi"]["side_by_side"][k] for k in ("128", "64"))
    for rec in (k128, k64):
        assert rec["kind"] == "train" and rec["loop_aware"]["flops"] > 0
    assert abs(k128["loop_aware"]["flops"] / k64["loop_aware"]["flops"] - 1) < 0.01


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_loop_aware_count_equals_the_full_trace(traced, cell):
    """FLOPs, bytes written, every collective and the argument and output
    bytes extend exactly; the eager peak within 0.1 %."""
    full, la = traced["loop_aware"][cell]
    for key in ("flops", "op_bytes", "collective_bytes"):
        assert la["loop_aware"][key] == full["loop_aware"][key], key
    assert la["loop_aware"]["collective_by_kind"] == full["loop_aware"]["collective_by_kind"]
    assert la["collectives"] == full["collectives"]
    for key in ("argument_bytes", "output_bytes"):
        assert la["memory"][key] == full["memory"][key], key
    assert abs(la["memory"]["temp_bytes"] / full["memory"]["temp_bytes"] - 1) < 1e-3


def test_sharded_trace_counts_one_devices_share(traced):
    """A dense prefill's per-device FLOPs on 4 ranks: a quarter of the
    same prefill's on one device (reduced deepseek-67b: every product
    splits over rows or heads; its 2 KV heads shard with the q heads)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import reduced
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models.common import tree_map_with_path
    from repro_torch.models.lm import LM

    cfg = reduced(get_config("deepseek-67b")).replace(attn_block=4096)
    shape = SHAPES["prefill_32k"]
    model = LM(cfg, device="cpu")
    with FakeTensorMode():
        params = tree_map_with_path(lambda _, s: torch.empty(s.shape), model.specs)
        tokens = torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32)
        one = analyze(model.prefill, params, {"tokens": tokens})["flops"]
    got = traced["cells"]["deepseek-67b|prefill_32k"]["rec"]["loop_aware"]["flops"]
    assert got * 4 == one


def test_command_line_writes_the_record(runs):
    """``python -m repro_torch.launch.dryrun`` at full size, on its own
    fake group of 256 ranks, writes ``<arch>__<shape>__single.json``."""
    rc, stdout, stderr, out = runs["cli"]
    assert rc == 0, stderr[-4000:]
    assert "all 1 cells traced OK" in stdout
    rec = json.loads((out / "mamba2-130m__long_500k__single.json").read_text())
    assert rec["devices"] == 256 and rec["kind"] == "decode" and rec["seq_len"] == 524_288
    assert rec["n_params"] > 1e8 and rec["loop_aware"]["flops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
