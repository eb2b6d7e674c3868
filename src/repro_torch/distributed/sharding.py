"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP + pod axis) over a
``torch.distributed`` device mesh.

The counterpart of ``repro.distributed.sharding``.  Models annotate
parameters and activations with *logical* axis names ("embed", "heads",
"ff", "vocab", "experts", "batch", …).  A :class:`ShardingRules` maps
logical names → mesh dimension names, and :func:`safe_spec` turns a shape's
logical axes into a :class:`P` (``repro``'s ``PartitionSpec``, entry for
entry) that tiles the mesh evenly.  :func:`placements` reads a spec as
``DTensor`` placements (``Shard(dim)`` / ``Replicate()`` per mesh
dimension).

``constrain`` is the activation hook threaded through the model code.
Outside a :func:`use_rules` context it returns its input and costs one
thread-local read, so serving and training are unchanged by it.  Inside a
context it redistributes a ``DTensor`` to the spec's placements, leaves a
plain tensor (a rank's local shard) as it is, and counts its calls by
axes signature in the context's counter.  It never changes a value.

A mesh is a ``DeviceMesh`` (its ``mesh_dim_names`` and sizes) or any object
whose ``shape`` maps dimension names to sizes.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Union

Axis = Union[str, tuple, None]

_ctx = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dimension, each a mesh
    dimension name, a tuple of them, or None (replicated).  A tuple, so it
    compares equal to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    rules: dict[str, Axis]

    def spec_for(self, axes: tuple) -> P:
        return P(*(self.rules.get(a) if a is not None else None for a in axes))

    def with_overrides(self, **kw: Axis) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)


def make_rules(
    *,
    multi_pod: bool = False,
    fsdp: bool = False,
    batch_axes: Axis = "auto",
    cache_seq: Axis = "model",
    sequence_parallel: bool = False,
) -> ShardingRules:
    """Baseline mapping (``repro``'s table).

    - ``pod``: pure data parallelism (cross-pod traffic = the gradient
      exchange)
    - ``data``: DP (+FSDP parameter sharding when ``fsdp``)
    - ``model``: TP for heads / ff / vocab / ssm_inner; EP's ff dim
    - ``experts`` shard over ``data`` (expert parallelism over the DP axis)
    """
    batch = (("pod", "data") if multi_pod else "data") if batch_axes == "auto" else batch_axes
    return ShardingRules(
        {
            "batch": batch,
            "seq": "model" if sequence_parallel else None,
            "embed": "data" if fsdp else None,
            "vocab": "model",
            "heads": "model",
            "kv_heads": "model",
            "ff": "model",
            "experts": "data",
            "ssm_inner": "model",
            "ssm_heads": "model",
            "layers": None,
            "cache_seq": cache_seq,
            "ctx_seq": None,
            "moe_groups": ("pod", "data") if multi_pod else "data",
        }
    )


def strip_axis(rules: ShardingRules, axis: str) -> ShardingRules:
    """Remove mesh dimension ``axis`` from every mapping (a dimension a
    region handles by hand, as the multipod step does with ``pod``)."""
    out = {}
    for k, v in rules.rules.items():
        if v == axis:
            out[k] = None
        elif isinstance(v, tuple):
            rest = tuple(a for a in v if a != axis)
            out[k] = rest if len(rest) > 1 else (rest[0] if rest else None)
        else:
            out[k] = v
    return ShardingRules(out)


@contextmanager
def use_rules(rules: Optional[ShardingRules], mesh):
    """Activate ``rules`` on ``mesh`` for :func:`constrain` on this thread;
    yields the context's call counter (axes signature → calls).  With
    either argument None, ``constrain`` stays the identity inside."""
    prev = getattr(_ctx, "state", None)
    calls: Counter = Counter()
    _ctx.state = (rules, mesh, calls) if rules is not None and mesh is not None else None
    try:
        yield calls
    finally:
        _ctx.state = prev


def active() -> Optional[tuple]:
    """(rules, mesh) of this thread's context, or None."""
    st = getattr(_ctx, "state", None)
    return None if st is None else st[:2]


def mesh_shape(mesh) -> dict:
    """Dimension name → size: a ``DeviceMesh``'s, or ``mesh.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def _axis_size(shape: dict, entry: Axis) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(shape[a] for a in names)


def safe_spec(shape: tuple, axes: tuple, rules: ShardingRules, mesh) -> P:
    """Divisibility-safe spec.

    When a logical mapping doesn't divide its dimension (e.g. 40 heads on a
    16-way model axis), the mapping is *re-homed* to the last unmapped
    dimension that does divide (typically head_dim) and otherwise dropped —
    values are unaffected, only layout.  A mesh dimension is used once.
    """
    sizes = mesh_shape(mesh)
    entries = [rules.rules.get(a) if a is not None else None for a in axes]
    for i, e in enumerate(entries):
        if e is None:
            continue
        if shape[i] % _axis_size(sizes, e) == 0:
            continue
        entries[i] = None
        for j in reversed(range(len(entries))):
            if entries[j] is None and axes[j] is None and shape[j] % _axis_size(sizes, e) == 0:
                entries[j] = e
                break
    seen: set = set()
    for i, e in enumerate(entries):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        if any(n in seen for n in names):
            entries[i] = None
        else:
            seen.update(names)
    return P(*entries)


def placements(spec: P, mesh) -> tuple:
    """``spec`` as ``DTensor`` placements on ``mesh`` (a ``DeviceMesh``):
    per mesh dimension ``Shard(d)`` when entry ``d`` names it, else
    ``Replicate()``.  A tuple entry shards its tensor dimension over each
    of its mesh dimensions, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, e in enumerate(spec):
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


def safe_sharding(shape, axes, rules: ShardingRules, mesh) -> tuple:
    """(mesh, placements) of :func:`safe_spec` — what ``distribute_tensor``
    takes."""
    return mesh, placements(safe_spec(tuple(shape), tuple(axes), rules, mesh), mesh)


def constrain(x, *axes: Optional[str]):
    """Annotate activation ``x`` with logical axes (the identity outside a
    context; see the module docstring)."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    rules, mesh, calls = st
    calls[axes] += 1
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(safe_spec(tuple(x.shape), axes, rules, mesh),
                                               mesh))
    return x


def _map_axes(fn, tree):
    """``fn`` over the leaves of an axes tree (dicts and lists of tuples)."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    return fn(tree)


def param_pspecs(axes_tree, rules: ShardingRules):
    """Map a logical-axes tree (tuples at leaves) → :class:`P` tree."""
    return _map_axes(rules.spec_for, axes_tree)


def shardings_for(specs_axes_tree, rules: ShardingRules, mesh):
    """Map a logical-axes tree → tree of (mesh, placements)."""
    return _map_axes(lambda axes: (mesh, placements(rules.spec_for(axes), mesh)),
                     specs_axes_tree)
