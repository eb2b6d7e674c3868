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

Traced as a sharded program (``DTensor`` s inside a context, as the dry run
does), a body ``DTensor`` cannot shard runs on each rank's shards through
:func:`local_region` (``local_map`` with placements from logical axes),
with :func:`all_reduce_over` for the sums it must share; on plain tensors
a region is the body itself.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Union

import torch

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
    either argument None, ``constrain`` stays the identity inside.

    On a ``DeviceMesh`` the context is a sharded program's: a plain tensor
    that meets a ``DTensor`` there (a RoPE table, positions, a zero to
    start a sum: the same on every rank) is taken as replicated, as
    ``implicit_replication`` takes it; the setting before the context is
    restored after it, so contexts nest."""
    prev = getattr(_ctx, "state", None)
    calls: Counter = Counter()
    _ctx.state = (rules, mesh, calls) if rules is not None and mesh is not None else None
    dispatcher = None
    if _ctx.state is not None and getattr(mesh, "mesh_dim_names", None) is not None:
        from torch.distributed.tensor import DTensor

        dispatcher = DTensor._op_dispatcher
        implicit = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield calls
    finally:
        _ctx.state = prev
        if dispatcher is not None:
            dispatcher._allow_implicit_replication = implicit


def in_context(fn):
    """``fn`` run inside this thread's rules context as it is now, on
    whichever thread calls it: remat recomputes a forward during the
    backward pass, which autograd runs on its own thread for a CUDA tensor,
    where this thread's context is not active.  ``fn`` itself outside a
    context."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return fn

    def run(*args, **kwargs):
        prev = getattr(_ctx, "state", None)
        _ctx.state = st
        try:
            return fn(*args, **kwargs)
        finally:
            _ctx.state = prev

    return run


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
    return _dedupe(P(*entries))


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


def place(x, axes, rules: ShardingRules, mesh):
    """``x``, which every rank holds whole, as a ``DTensor`` laid out by
    :func:`safe_sharding` of its logical ``axes``: each rank keeps its own
    shard, and nothing crosses the group.  The shard may share ``x``'s
    storage (an update in place then writes ``x``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, *safe_sharding(x.shape, axes, rules, mesh), src_data_rank=None)


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


def zeros_placed(p, drop: Optional[int] = None):
    """fp32 zeros shaped like ``p``, without dimension ``drop`` if given
    (a factored moment); for a ``DTensor`` laid out like it, a shard along
    ``drop`` replicated and a shard past it one dimension down."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.common import contiguous_strides, local_shape

    shape = tuple(p.shape)
    if drop is not None:
        drop %= len(shape)
        shape = shape[:drop] + shape[drop + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    pl = tuple(p.placements)
    if drop is not None:
        pl = tuple(Replicate() if q.is_shard(drop) else Shard(q.dim - 1)
                   if q.is_shard() and q.dim > drop else q for q in pl)
    mesh = p.device_mesh
    local = torch.zeros(local_shape(shape, tuple(mesh.shape), pl), dtype=torch.float32,
                        device=p.to_local().device)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


#: a ``local_region`` argument spec: the ``DTensor`` keeps its placements
KEEP = "keep"


def strict_entries(shapes_axes, rules: ShardingRules, mesh) -> dict:
    """Logical name → mesh entry for the names of ``shapes_axes`` (pairs of
    a shape and its logical axes): a name's rule where it divides every
    dimension that bears the name, else None (replicated).  Unlike
    :func:`safe_spec` nothing is re-homed: a local function sees whole
    heads, rows and experts."""
    sizes = mesh_shape(mesh)
    out: dict = {}
    for shape, axes in shapes_axes:
        for n, a in zip(shape, axes):
            if a is None:
                continue
            e = out.get(a, rules.rules.get(a))
            if e is not None and n % _axis_size(sizes, e):
                e = None
            out[a] = e
    return out


def local_region(fn, in_axes, out_axes, plain=None):
    """``fn`` over one rank's shards when a sharded program is traced and an
    argument is a ``DTensor``; ``fn`` itself otherwise (one thread-local
    read on plain tensors).

    ``in_axes`` has one entry per positional argument: a tuple of logical
    axes, :data:`KEEP` (a ``DTensor`` keeps its placements), the index of
    another argument (take its placements), or None (not a tensor); names
    map through :func:`strict_entries`.  ``out_axes`` has one entry per
    output: logical axes, a tuple of placements as is, or a function of
    the inputs' placements (a list) giving them.  Plain tensor arguments
    are taken as replicated.  Runs under
    ``torch.distributed.tensor.experimental.local_map`` (:func:`run_local`);
    keyword arguments pass through.  With no ``DTensor`` argument ``plain``
    (default ``fn``) runs instead."""
    plain = fn if plain is None else plain

    def run(*args, **kwargs):
        st = getattr(_ctx, "state", None)
        if st is None:
            return plain(*args, **kwargs)
        from torch.distributed.tensor import DTensor

        if not any(isinstance(a, DTensor) for a in args):
            return plain(*args, **kwargs)
        rules, mesh, _ = st
        named = [(tuple(a.shape), ax) for a, ax in zip(args, in_axes)
                 if isinstance(ax, tuple) and isinstance(a, torch.Tensor)]
        entries = strict_entries(named, rules, mesh)

        def pl(axes):
            spec = P(*(entries.get(a) if a is not None else None for a in axes))
            return placements(_dedupe(spec), mesh)

        ins, targs = [], []
        for a, ax in zip(args, in_axes):
            a = as_dtensor(a, mesh)
            if not isinstance(a, torch.Tensor):
                ins.append(None)
            elif isinstance(ax, int):
                ins.append(args[ax].placements)
            else:
                ins.append(a.placements if ax == KEEP else pl(ax))
            targs.append(a)
        outs = tuple(None if o is None else o(ins) if callable(o)
                     else tuple(o) if o and not isinstance(o[0], (str, type(None), tuple))
                     else pl(o) for o in out_axes)
        return run_local(fn, mesh, ins, outs, *targs, **kwargs)

    return run


def as_dtensor(a, mesh):
    """A plain tensor as a ``DTensor`` replicated on ``mesh``; anything
    else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
        return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return a


def run_local(fn, mesh, ins, outs, *args, **kwargs):
    """``fn`` on the local shards of ``args`` laid out as ``ins`` (one
    placements tuple per argument, None for a non-tensor), its outputs
    taken as laid out by ``outs``.  An input's gradient is a partial sum
    over each mesh dimension it is replicated on while the work is split
    there (each rank used it for its part of the work)."""
    from torch.distributed.tensor.experimental import local_map

    split = [False] * mesh.ndim
    for p in list(ins) + list(outs):
        if p is not None:
            split = [sp or not q.is_replicate() for sp, q in zip(split, p)]
    # one entry per output (a single output's placements, too, in a tuple);
    # a function of no output returns None, a leaf of no placements
    wrapped = local_map(fn, out_placements=tuple(outs) or (None,),
                        in_placements=tuple(ins), in_grad_placements=tuple(
                            None if p is None else _grad_layout(p, split) for p in ins),
                        redistribute_inputs=True, device_mesh=mesh)
    return wrapped(*args, **kwargs)


def _grad_layout(pl: tuple, split: list) -> tuple:
    """The gradient of an input laid out as ``pl``: partial sums over each
    mesh dimension it is replicated on while the work is split there (each
    rank used it for its part), else its own layout."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate() and sp else p for p, sp in zip(pl, split))


def _dedupe(spec: P) -> P:
    """``spec`` with a mesh dimension named twice kept at its first entry."""
    seen: set = set()
    out = []
    for e in spec:
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        if any(n in seen for n in names):
            out.append(None)
        else:
            seen.update(names)
            out.append(e)
    return P(*out)


def all_reduce_over(t, op: str, entry):
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh dimensions of
    ``entry`` of this thread's sharded program, one native functional
    all-reduce per dimension; ``t`` itself for None.  The result is the
    same on every rank, so a sum's gradient is the result's own (what each
    rank's replicated use of it gives); a max carries none."""
    if entry is None:
        return t
    _, mesh = active()
    names = entry if isinstance(entry, tuple) else (entry,)
    groups = tuple(mesh.get_group(name).group_name for name in names)
    if op == "sum" and t.requires_grad:
        return _SumReplicated.apply(t, groups)
    return _all_reduce(t.detach() if op == "max" else t, op, groups)


def _all_reduce(t, op: str, groups):
    for group in groups:
        t = torch.ops._c10d_functional.wait_tensor(
            torch.ops._c10d_functional.all_reduce(t, op, group))
    return t


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        return _all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def once_over(t, *entries):
    """``t``, a value every rank of a local region computes whole from
    inputs the region takes as replicated, with its gradient divided by the
    ranks along the mesh dimensions of ``entries`` (the region's split):
    the inputs' gradients are partial sums over those ranks (:func:`run_local`),
    so the value's own gradient is then counted once.  The value is
    unchanged."""
    n = math.prod(mesh_coords(active()[1], e)[1] for e in entries)
    return t if n == 1 or not t.requires_grad else _ScaleGrad.apply(t, 1.0 / n)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def mesh_coords(mesh, entry) -> tuple:
    """(this rank's index, count) along the mesh dimensions of ``entry`` (a
    name or a tuple of names, major first); (0, 1) for None."""
    if entry is None:
        return 0, 1
    idx, n = 0, 1
    for name in (entry if isinstance(entry, tuple) else (entry,)):
        size = mesh_shape(mesh)[name]
        idx = idx * size + mesh.get_local_rank(name)
        n *= size
    return idx, n


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
