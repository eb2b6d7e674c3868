"""Multi-pod dry run: trace every (arch × shape) cell as rank 0 of the
production mesh and count its per-device work, allocating nothing.

The counterpart of ``repro.launch.dryrun``.  ``repro`` lowers and compiles
each cell with GSPMD; the port runs rank 0's program of the same cell
eagerly on fake tensors:

  1. ``main`` starts a fake process group (``FakeStore``, backend
     ``"fake"``) of 256 or 512 ranks and the production mesh on it
     (importing this module starts nothing);
  2. parameter, optimizer, batch and cache structs come from the registry
     (``models/registry.py``) as ``DTensor`` s of fake CPU shards under a
     ``FakeTensorMode``, so every kernel wrapper takes its plain route;
  3. the step (the train step with its backward and optimizer update,
     prefill, or a decode step) runs inside ``use_rules`` under
     ``launch/op_analysis.py``'s :class:`OpCounter`, which counts rank 0's
     local ops and collectives; with ``--compress-pod`` a multi-pod train
     cell runs the multipod step as ``repro``'s does (pod by hand, the
     sharded program on the ``data`` × ``model`` sub-mesh inside, ``ef``
     laid out like the parameters) and its record adds ``pod_exchange``
     (the int8 exchange's all-gathers: bytes sent and received a device,
     and the ``ef`` bytes);
  4. one JSON per cell goes to ``results/dryrun_torch/`` (never
     ``results/dryrun/``, which ``repro``'s roofline reads), with
     ``repro``'s keys where the quantity is the same: ``memory``
     (per-device argument and output bytes from the local shapes, exact;
     ``temp_bytes`` the eager peak of the storages the trace made, which
     is not XLA's), ``loop_aware`` (op_analysis' totals), ``collectives``
     (``parse_collectives``' layout) and ``seconds`` (``trace``, in place
     of lower and compile).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--cells train_4k,...]
  python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k \
      --multi-pod --compress-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _rules_for(cfg, shape, *, multi_pod: bool):
    from repro_torch.distributed.sharding import make_rules

    fsdp = cfg.name != "mamba2-130m"
    if shape.kind == "decode":
        if shape.global_batch < 16:   # long_500k: nothing to shard on batch
            rules = make_rules(multi_pod=multi_pod, fsdp=fsdp, batch_axes=None,
                               cache_seq=("data", "model"))
        else:
            rules = make_rules(multi_pod=multi_pod, fsdp=fsdp, cache_seq="model")
    else:
        rules = make_rules(multi_pod=multi_pod, fsdp=fsdp)
    if cfg.expand_kv:
        rules = rules.with_overrides(kv_heads=None)  # replicate KV projections
    return rules


def _cell_rules(cfg, shape, *, multi_pod: bool, rules_overrides: dict | None = None):
    rules = _rules_for(cfg, shape, multi_pod=multi_pod)
    if rules_overrides:
        rules = rules.with_overrides(
            **{k: tuple(v) if isinstance(v, list) else v for k, v in rules_overrides.items()})
    return rules


def build_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None, compress_pod: bool = False,
               rules_overrides: dict | None = None, cfg=None, mesh=None,
               depth: list | None = None, microbatches: int | None = None):
    """(fn, args, mesh, rules, bundle, shape) of one cell; the args are
    structs of fake CPU shards, so call it inside a ``FakeTensorMode``.
    ``cfg`` and ``mesh`` replace the registered config and the production
    mesh (the tests trace reduced configs on small meshes).  ``depth``
    cuts the stack (``ModelBundle.with_depth``) and ``microbatches`` runs
    that many of the cell's microbatches (the batch shrinks with them)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import get_bundle
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import make_optimizer

    cfg = cfg if cfg is not None else get_config(arch_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              device_type="cpu")
    rules = _cell_rules(cfg, shape, multi_pod=multi_pod, rules_overrides=rules_overrides)
    bundle = get_bundle(cfg)
    if depth is not None:
        bundle = bundle.with_depth(depth)
    params = bundle.param_structs(rules, mesh, device="cpu")

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        k = cfg.train_microbatches
        if microbatches is not None:
            shape = dataclasses.replace(shape, global_batch=shape.global_batch // k * microbatches)
            k = microbatches
        batch = bundle.train_batch_structs(shape, rules, mesh, device="cpu")
        if compress_pod and multi_pod:
            # repro's: pod by hand, data and model the sharded program's inside
            from repro_torch.distributed.multipod import make_multipod_train_step
            from repro_torch.distributed.sharding import strip_axis
            from repro_torch.models.common import make_struct, tree_map_with_path

            inner, sub = strip_axis(rules, "pod"), mesh["data", "model"]
            params = bundle.param_structs(inner, sub, device="cpu")
            opt_state = bundle.opt_state_structs(opt, params, inner, sub, device="cpu")
            ef = tree_map_with_path(
                lambda _, p: make_struct(p.shape, torch.float32, (sub, p.placements), "cpu"),
                params)
            mp_step, _ = make_multipod_train_step(bundle.model, mesh, opt, microbatches=k)

            def fn(p, o, e, b, s):
                with use_rules(inner, sub):
                    return mp_step(p, o, e, b, s)

            return fn, (params, opt_state, ef, batch, 0), mesh, rules, bundle, shape
        opt_state = bundle.opt_state_structs(opt, params, rules, mesh, device="cpu")
        train_step, _ = make_train_step(bundle.model, opt, microbatches=k)

        def fn(p, o, b, s):
            with use_rules(rules, mesh):
                return train_step(p, o, b, s)

        args = (params, opt_state, batch, 0)
    elif shape.kind == "prefill":
        batch = bundle.prefill_batch_structs(shape, rules, mesh, device="cpu")

        def fn(p, b):
            with use_rules(rules, mesh):
                return bundle.model.prefill(p, b)

        args = (params, batch)
    else:  # decode
        caches, tokens, pos = bundle.decode_args_structs(shape, rules, mesh, params,
                                                         device="cpu")

        def fn(p, c, t, s):
            with use_rules(rules, mesh):
                return bundle.model.decode_step(p, c, t, s)

        args = (params, caches, tokens, pos)
    return fn, args, mesh, rules, bundle, shape


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _collectives(res: dict) -> dict:
    """op_analysis' census in ``parse_collectives``' layout."""
    from repro_torch.launch.op_analysis import COLLECTIVE_KINDS

    out = {k: {"count": int(res["collective_count"].get(k, 0)),
               "bytes": float(res["collective_by_kind"].get(k, 0.0))}
           for k in COLLECTIVE_KINDS}
    out["total_bytes"] = float(res["collective_bytes"])
    out["total_count"] = int(sum(res["collective_count"].values()))
    return out


def _trace(arch_name, shape_name, *, mesh, **kw) -> tuple:
    """One traced run of a cell: (op_analysis' result, argument bytes,
    output bytes, build seconds, trace seconds, counter, bundle, shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models.common import struct_bytes

    t0 = time.time()
    with FakeTensorMode():
        fn, args, mesh, rules, bundle, shape = build_cell(arch_name, shape_name, mesh=mesh, **kw)
        arg_bytes = sum(struct_bytes(x) for x in _leaves(args))
        t1 = time.time()
        with OpCounter(memory=True) as counter:
            out = fn(*args)
        out_bytes = sum(struct_bytes(x) for x in _leaves(out))
    res = counter.result()
    if kw.get("compress_pod") and kw.get("multi_pod") and shape.kind == "train":
        n, got, sent = counter.collectives_in("compression.compressed_mean").get(
            "all-gather", (0, 0.0, 0.0))
        # the int8 codes and one fp32 scale a leaf; the ef tree is args[2]
        res["pod_exchange"] = {"all_gathers": n, "sent_bytes": sent, "received_bytes": got,
                               "ef_bytes": sum(struct_bytes(x) for x in _leaves(args[2]))}
    return (res, arg_bytes, out_bytes, t1 - t0, time.time() - t1, counter, bundle, shape)


def _flat(d: dict, prefix=()) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _extend(base: dict, probes: list, counts: list) -> dict:
    """``base`` (every count at 1) plus, per variable, (count − 1) × its
    probe's increment (the probe has that count at 2): the cost of a stack
    whose layers repeat, as ``hlo_analysis`` multiplies a loop body by its
    trip count."""
    fb = _flat(base)
    keys = set(fb).union(*(_flat(p) for p in probes))
    out = {}
    for k in keys:
        v = fb.get(k, 0)
        for probe, n in zip(probes, counts):
            v += (n - 1) * (_flat(probe).get(k, 0) - fb.get(k, 0))
        out[k] = v
    return _nest(out)


def side_by_side(cfg, shape, mesh, *, multi_pod: bool, rules_overrides=None) -> int:
    """Microbatches a pass of a train cell's step runs side by side
    (``train.loop``: a rank holding fewer rows than microbatches runs k/p
    of them in each of its p passes); 1 for other cells."""
    from repro_torch.distributed.sharding import _axis_size, mesh_shape, safe_spec
    from repro_torch.train.loop import passes

    if shape.kind != "train":
        return 1
    rules = _cell_rules(cfg, shape, multi_pod=multi_pod, rules_overrides=rules_overrides)
    gb = shape.global_batch
    entry = safe_spec((gb, shape.seq_len), ("batch", None), rules, mesh)[0]
    k = cfg.train_microbatches
    return k // passes(gb // _axis_size(mesh_shape(mesh), entry), k)


def trace_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               overrides: dict | None = None, compress_pod: bool = False,
               rules_overrides: dict | None = None, cfg=None, mesh=None,
               top: int = 0, loop_aware: bool = True) -> dict:
    """Trace one cell on fake tensors (see the module docstring): the
    record ``run_cell`` writes, without ``tag`` and ``overrides``.

    ``loop_aware`` (the default) traces the stack at one period per
    segment (and one encoder layer) and at two periods in each in turn,
    and for a train cell at one and two passes of its step (g and 2g
    microbatches, :func:`side_by_side`), then extends every count linearly
    to the full depth and passes: per-device FLOPs,
    bytes and collectives are exactly linear in them, so this equals the
    full trace (the tests check it on a reduced stack) at the cost of a
    few periods.  ``temp_bytes`` extends the same way, which holds while
    the peak grows by one period's live bytes a period.  Argument and
    output bytes come from the full cell's structs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.models.common import struct_bytes
    from repro_torch.models.registry import get_bundle

    t0 = time.time()
    if mesh is None:   # a DeviceMesh is made of real tensors
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    kw = dict(multi_pod=multi_pod, overrides=overrides, compress_pod=compress_pod,
              rules_overrides=rules_overrides, cfg=cfg)
    if not loop_aware:
        res, arg_bytes, out_bytes, _, t_trace, counter, bundle, shape = _trace(
            arch_name, shape_name, mesh=mesh, **kw)
    else:
        full_cfg = cfg if cfg is not None else get_config(arch_name)
        if overrides:
            full_cfg = full_cfg.replace(**overrides)
        depth = get_bundle(full_cfg).depth
        runs = {}

        def run(d, k):
            if (tuple(d), k) not in runs:
                r = _trace(arch_name, shape_name, mesh=mesh, depth=list(d), microbatches=k,
                           **kw)
                r[0].update(argument_bytes=r[1], output_bytes=r[2])
                runs[(tuple(d), k)] = r
            return runs[(tuple(d), k)]

        ones = [1] * len(depth)
        bumps = [ones[:i] + [2] + ones[i + 1:] for i in range(len(depth))]
        k = full_cfg.train_microbatches
        g = side_by_side(full_cfg, SHAPES[shape_name], mesh, multi_pod=multi_pod,
                         rules_overrides=rules_overrides)
        ks = [g, 2 * g] if SHAPES[shape_name].kind == "train" else [None]
        per_k = [_extend(run(ones, kk)[0], [run(b, kk)[0] for b in bumps], depth) for kk in ks]
        res = per_k[0] if len(ks) == 1 else _extend(per_k[0], [per_k[1]], [k // g])
        counter = run(ones, ks[0])[5]
        t_trace = sum(r[4] for r in runs.values())
        with FakeTensorMode():
            _, args, _, _, bundle, shape = build_cell(arch_name, shape_name, mesh=mesh, **kw)
            arg_bytes = sum(struct_bytes(x) for x in _leaves(args))
        if res.pop("argument_bytes") != arg_bytes:     # the counts are linear in depth
            raise AssertionError(f"{arch_name} {shape_name}: argument bytes do not extend "
                                 "linearly with depth")
        out_bytes = res.pop("output_bytes")
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "devices": int(mesh.size()),
        "n_params": int(bundle.n_params),
        "model_flops_dense": float(bundle.cfg.n_params_dense_estimate),
        "model_flops_active": float(bundle.cfg.n_params_active_estimate),
        "tokens": int(shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)),
        "kind": shape.kind,
        "seq_len": int(shape.seq_len),
        "global_batch": int(shape.global_batch),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(res.pop("peak_bytes")),
        },
        "collectives": _collectives(res),
        "loop_aware": res,
        "seconds": {"build": time.time() - t0 - t_trace, "trace": t_trace},
    }
    if top:
        rec["top_flops"] = [list(r) for r in counter.top_contributors(top, "flops")]
    return rec


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Path = RESULTS, overrides: dict | None = None,
             tag: str = "", compress_pod: bool = False,
             rules_overrides: dict | None = None) -> dict:
    rec = trace_cell(arch_name, shape_name, multi_pod=multi_pod, overrides=overrides,
                     compress_pod=compress_pod, rules_overrides=rules_overrides, top=10)
    rec.update(tag=tag, overrides=overrides or {})
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = ("multi" if multi_pod else "single") + (f"_{tag}" if tag else "")
    fp = out_dir / f"{arch_name}__{shape_name}__{suffix}.json"
    fp.write_text(json.dumps(rec, indent=1))
    mem = rec["memory"]
    print(f"[dryrun] {arch_name:24s} {shape_name:12s} {suffix:12s} "
          f"trace {rec['seconds']['trace']:6.1f}s  arg/dev {mem['argument_bytes'] / 1e9:7.2f} GB  "
          f"temp/dev {mem['temp_bytes'] / 1e9:7.2f} GB  "
          f"flops/dev {rec['loop_aware']['flops']:.3e}  "
          f"coll {rec['collectives']['total_bytes'] / 1e6:8.1f} MB", flush=True)
    return rec


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (the
    one before it, if any, destroyed)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main() -> None:
    import logging

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import cells_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cells", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--overrides", default="", help="JSON dict of ArchConfig overrides")
    ap.add_argument("--rules-overrides", default="",
                    help="JSON dict of sharding-rule overrides")
    ap.add_argument("--compress-pod", action="store_true",
                    help="EF-int8 compressed pod-axis gradient exchange")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args()

    # DTensor warns of a CPU mesh's all-to-all fallback (op_analysis counts
    # it as the all-to-all) and of sequential all-reduces
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    overrides = json.loads(args.overrides) if args.overrides else None
    rules_overrides = json.loads(args.rules_overrides) if args.rules_overrides else None
    out_dir = Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    todo: list[tuple[str, str]] = []
    if args.all:
        only = set(args.cells.split(",")) if args.cells else None
        for name in sorted(ARCHS):
            for cell in cells_for(get_config(name)):
                if only is None or cell in only:
                    todo.append((name, cell))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    failures = []
    for mp in meshes:
        fake_group(512 if mp else 256)
        for arch, cell in todo:
            try:
                run_cell(arch, cell, multi_pod=mp, out_dir=out_dir, overrides=overrides,
                         tag=args.tag, compress_pod=args.compress_pod,
                         rules_overrides=rules_overrides)
            except Exception as e:
                failures.append((arch, cell, mp, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(todo) * len(meshes)} cells traced OK")


if __name__ == "__main__":
    main()
