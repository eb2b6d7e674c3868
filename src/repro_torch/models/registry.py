"""Model bundles: config → LM + sharding plumbing + input structs.

The counterpart of ``repro.models.registry``.  Everything the dry run needs
per architecture, with **zero allocation**: parameter, optimizer, batch and
cache trees come out as structs (:func:`.common.make_struct`): meta
tensors with no mesh, and with one ``DTensor`` s whose local tensors are
one device's shards on ``meta`` (or, with ``device="cpu"`` under a
``FakeTensorMode``, fake CPU tensors), laid out by ``safe_sharding``.
Leaf for leaf, the global shapes and dtypes are ``repro``'s
``ShapeDtypeStruct`` s and the local shapes its ``shard_shape`` s.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingRules, safe_sharding

from .common import (CACHE_SEQ_KEYS, axes_tree, cache_leaf_key, make_struct, param_count,
                     tree_map_with_path)
from .lm import ENCODER_LAYER, LM, _layer_specs, _stack_specs

# cache-leaf logical axes by key name (leading dim is the stacked layer axis)
_CACHE_AXES = {
    "k": ("layers", "batch", "cache_seq", None, None),
    "v": ("layers", "batch", "cache_seq", None, None),
    "ck": ("layers", "batch", "ctx_seq", "kv_heads", None),
    "cv": ("layers", "batch", "ctx_seq", "kv_heads", None),
    "c_kv": ("layers", "batch", "cache_seq", None),
    "k_rope": ("layers", "batch", "cache_seq", None),
    "conv": ("layers", "batch", None, "ssm_inner"),
    "ssm": ("layers", "batch", "ssm_heads", None, None),
}

#: the sequence length of the short prefill whose cache tree gives every
#: leaf's layout (a sequence leaf's axis 2 is then set to the cell's)
_PROBE_SEQ = 8


@dataclass
class ModelBundle:
    cfg: ArchConfig
    model: LM
    _layout: tuple = field(default=None, repr=False, compare=False)

    def _struct(self, shape, dtype, axes, rules, mesh, device):
        sh = None if mesh is None else safe_sharding(tuple(shape), tuple(axes), rules, mesh)
        return make_struct(shape, dtype, sh, device)

    # -- parameter trees -----------------------------------------------------
    def param_structs(self, rules: ShardingRules, mesh, device="meta"):
        dt = self.model.param_dtype
        return tree_map_with_path(
            lambda _, s: self._struct(s.shape, dt, s.axes, rules, mesh, device),
            self.model.specs)

    def opt_state_structs(self, opt, params_struct, rules: ShardingRules, mesh,
                          device="meta"):
        """The optimizer's own ``init`` over meta parameters, then shardings
        re-attached from the parameter logical axes (factored moments drop
        the matching dim), as ``repro`` does after ``eval_shape``."""
        meta = tree_map_with_path(
            lambda _, p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
            params_struct)
        st = opt.init(meta)
        ax = axes_tree(self.model.specs)

        def attach(leaf, axes):
            return self._struct(leaf.shape, leaf.dtype, axes, rules, mesh, device)

        def walk(st_node, ax_node):
            if isinstance(st_node, dict):
                out = {}
                for k, v in st_node.items():
                    if k == "count":
                        out[k] = attach(v, ())
                    elif k in ("m", "v", "per_param"):
                        out[k] = walk(v, ax_node)
                    elif k == "vr":
                        out[k] = attach(v, ax_node[:-1])
                    elif k == "vc":
                        out[k] = attach(v, ax_node[:-2] + ax_node[-1:])
                    else:
                        out[k] = walk(v, ax_node[k] if isinstance(ax_node, dict) else ax_node)
                return out
            if isinstance(st_node, (list, tuple)):
                return type(st_node)(walk(v, ax_node[i]) for i, v in enumerate(st_node))
            if isinstance(st_node, torch.Tensor):
                axes = ax_node if isinstance(ax_node, tuple) else ()
                if len(axes) != st_node.ndim:
                    axes = (None,) * st_node.ndim
                return attach(st_node, axes)
            return st_node

        return walk(st, ax)

    # -- batch structs --------------------------------------------------------
    def _batch_extras(self, gb: int, rules, mesh, dtype=torch.bfloat16, device="meta") -> dict:
        cfg = self.cfg
        out = {}
        if cfg.encoder_layers:
            out["enc_feats"] = self._struct((gb, cfg.encoder_context, cfg.d_model), dtype,
                                            ("batch", None, None), rules, mesh, device)
        if cfg.vision_context:
            out["image_embeds"] = self._struct((gb, cfg.vision_context, cfg.d_model), dtype,
                                               ("batch", None, None), rules, mesh, device)
        return out

    def train_batch_structs(self, shape: ShapeSpec, rules: ShardingRules, mesh,
                            device="meta"):
        gb, s = shape.global_batch, shape.seq_len
        batch = {k: self._struct((gb, s), torch.int32, ("batch", None), rules, mesh, device)
                 for k in ("tokens", "targets")}
        batch.update(self._batch_extras(gb, rules, mesh, device=device))
        return batch

    def prefill_batch_structs(self, shape: ShapeSpec, rules, mesh, device="meta"):
        gb, s = shape.global_batch, shape.seq_len
        batch = {"tokens": self._struct((gb, s), torch.int32, ("batch", None), rules, mesh,
                                        device)}
        batch.update(self._batch_extras(gb, rules, mesh, device=device))
        return batch

    def cache_layout(self) -> tuple:
        """(path, shape, dtype) of every leaf of a prefill cache of one row
        and :data:`_PROBE_SEQ` positions, from the port's own ``prefill``
        traced on fake tensors at one period per segment (a leaf's leading
        axis then set to its segment's periods); cached per bundle."""
        if self._layout is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            cfg = self.cfg
            probe = self.with_depth([1] * len(self.depth)).model
            periods = [n for _, n in self.model.segments]
            with FakeTensorMode():
                params = tree_map_with_path(
                    lambda _, s: torch.empty(s.shape, dtype=self.model.param_dtype),
                    probe.specs)
                batch = {"tokens": torch.zeros((1, _PROBE_SEQ), dtype=torch.int32)}
                if cfg.encoder_layers:
                    batch["enc_feats"] = torch.zeros((1, cfg.encoder_context, cfg.d_model),
                                                     dtype=torch.bfloat16)
                if cfg.vision_context:
                    batch["image_embeds"] = torch.zeros((1, cfg.vision_context, cfg.d_model),
                                                        dtype=torch.bfloat16)
                _, caches = probe.prefill(params, batch)
                layout = []
                tree_map_with_path(
                    lambda path, x: layout.append(
                        (path, (periods[path[0]],) + tuple(x.shape[1:]), x.dtype)), caches)
            self._layout = (caches, layout)
        return self._layout

    def cache_structs(self, shape: ShapeSpec, rules: ShardingRules, mesh, params_struct=None,
                      device="meta"):
        """Decode-cell caches of capacity ``shape.seq_len``: the leaves of
        :meth:`cache_layout` with the batch set to the cell's and a sequence
        leaf's axis 2 to ``seq_len`` (``repro`` runs ``eval_shape`` of the
        whole prefill; a traced prefill of 524,288 positions would take
        ~1,000 attention blocks a layer)."""
        caches, layout = self.cache_layout()
        it = iter(layout)

        def attach(path, _):
            p, shp, dtype = next(it)
            key = cache_leaf_key(p)
            shp = (shp[0], shape.global_batch) + shp[2:]
            if key in CACHE_SEQ_KEYS:
                shp = shp[:2] + (shape.seq_len,) + shp[3:]
            axes = _CACHE_AXES.get(key, (None,) * len(shp))
            if len(axes) != len(shp):
                axes = (None,) * len(shp)
            return self._struct(shp, dtype, axes, rules, mesh, device)

        return tree_map_with_path(attach, caches)

    def decode_args_structs(self, shape: ShapeSpec, rules, mesh, params_struct=None,
                            device="meta"):
        gb = shape.global_batch
        tokens = self._struct((gb, 1), torch.int32, ("batch", None), rules, mesh, device)
        pos = self._struct((gb,), torch.int32, ("batch",), rules, mesh, device)
        caches = self.cache_structs(shape, rules, mesh, params_struct, device)
        return caches, tokens, pos

    # -- misc ----------------------------------------------------------------
    @property
    def n_params(self) -> int:
        return param_count(self.model.specs)

    @property
    def depth(self) -> list:
        """Periods of each segment, then the encoder's layers (if any)."""
        out = [n for _, n in self.model.segments]
        return out + ([self.cfg.encoder_layers] if self.cfg.encoder_layers else [])

    def with_depth(self, depth: list) -> "ModelBundle":
        """This bundle cut to ``depth`` (as :attr:`depth`): the same widths,
        with segment ``s`` holding ``depth[s]`` periods (what the dry run's
        loop-aware count traces)."""
        cfg = self.cfg
        model = LM(cfg, device="meta")
        segs = [(period, n) for (period, _), n in zip(model.segments, depth)]
        model.segments = segs
        model.specs = dict(model.specs)
        model.specs["segments"] = [
            _stack_specs({f"p{j}": _layer_specs(cfg, ls) for j, ls in enumerate(period)}, n)
            for period, n in segs]
        if cfg.encoder_layers:
            model.specs["encoder"] = dict(model.specs["encoder"])
            model.specs["encoder"]["layers"] = _stack_specs(
                {"p0": _layer_specs(cfg, ENCODER_LAYER)}, depth[len(segs)])
        return ModelBundle(cfg=cfg, model=model)


@functools.lru_cache(maxsize=64)
def _bundle_cached(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(cfg=cfg, model=LM(cfg, device="meta"))


def get_bundle(cfg: ArchConfig) -> ModelBundle:
    return _bundle_cached(cfg)
