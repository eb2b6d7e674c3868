"""Shared model machinery: parameter specs, cache-leaf taxonomy, norms,
RoPE, projections.

PyTorch counterparts of ``repro.models.common``; layouts are the JAX
package's (weights ``(d, H, hd)`` / ``(H, hd, d)`` / ``(d, d_ff)``), so the
two packages' tensors compare leaf by leaf.

Parameters are built from a **spec tree** (nested dicts and lists with
:class:`ParamSpec` leaves): ``LM.init`` materializes it, and
:func:`axes_tree` gives the logical axis names that
``repro_torch.distributed.sharding`` maps onto a device mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import active as _active

# ---------------------------------------------------------------------------
# cache-leaf taxonomy: what each entry of a serving cache tree *is*.  The
# model creates these entries and the serve layer slices/concats/stores them.
# ---------------------------------------------------------------------------

#: entries whose trailing-from-batch axis is the document/sequence axis
CACHE_SEQ_KEYS = ("k", "v", "c_kv", "k_rope")
#: entries holding running state (SSD conv/ssm; kept only at segment end)
CACHE_STATE_KEYS = ("conv", "ssm")
#: entries constant across the document (cross-attention context K/V)
CACHE_CONST_KEYS = ("ck", "cv")


def cache_leaf_key(path) -> Optional[str]:
    """Innermost dict key of a cache-tree leaf path ("k", "ssm", …).

    ``path`` is the sequence of keys and list indices leading to the leaf;
    list indices are ints and are skipped.
    """
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return None


def tree_map_with_path(fn, tree, *rest, path=()):
    """Map ``fn(path, leaf, *other_leaves)`` over nested dicts/lists/tuples.

    The other trees must share ``tree``'s structure; ``path`` holds the
    dict keys and list indices leading to each leaf.
    """
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  path=path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure holding ``leaves``, given in :func:`tree_leaves`
    order."""
    it = iter(leaves)
    return tree_map_with_path(lambda _, x: next(it), tree)


def tree_items_sorted(tree, path=()) -> list:
    """(path, leaf) pairs in ``jax.tree_util``'s flatten order: dict keys
    sorted, lists and tuples in order (:func:`tree_leaves` keeps a dict's
    insertion order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items_sorted(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items_sorted(v, path + (i,))]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | small_normal
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_map(fn: Callable[[ParamSpec], object], tree):
    """``fn`` over every :class:`ParamSpec` leaf, keeping the tree."""
    return tree_map_with_path(lambda _, s: fn(s), tree)


def axes_tree(specs):
    """The spec tree with each leaf's logical axes (a tuple) in its place."""
    return spec_map(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def local_shape(shape, mesh_sizes, placements) -> tuple:
    """One device's shape of a tensor of global ``shape`` laid out by
    ``placements`` (one per mesh dimension, of sizes ``mesh_sizes``):
    ``Shard(d)`` divides dimension ``d``, evenly (``safe_spec`` makes
    every layout even)."""
    out = list(shape)
    for n, pl in zip(mesh_sizes, placements):
        d = getattr(pl, "dim", None)
        if d is not None and pl.is_shard():
            if out[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split "
                                 f"into {n}")
            out[d] //= n
    return tuple(out)


def make_struct(shape, dtype: torch.dtype, sharding=None, device="meta"):
    """A zero-allocation tensor of global ``shape``: with ``sharding`` None
    a tensor on ``device`` (``meta`` by default), else a ``DTensor`` whose
    local tensor is one device's shard on ``device``, laid out by
    ``sharding = (mesh, placements)``.  Under a ``FakeTensorMode``,
    ``device="cpu"`` makes fake CPU tensors."""
    shape = tuple(int(n) for n in shape)
    if sharding is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    mesh, pl = sharding
    local = torch.empty(local_shape(shape, tuple(mesh.shape), pl), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def shape_structs(specs, dtype: torch.dtype, sharding_fn=None, device="meta"):
    """The spec tree as zero-allocation tensors (``repro``'s
    ``ShapeDtypeStruct`` tree): meta tensors, or with ``sharding_fn(axes) ->
    (mesh, placements)`` ``DTensor`` s of meta (or, under a
    ``FakeTensorMode``, fake) local shards (see :func:`make_struct`)."""
    def mk(s: ParamSpec):
        return make_struct(s.shape, dtype,
                           sharding_fn(s.axes) if sharding_fn is not None else None, device)

    return spec_map(mk, specs)


def struct_local(x):
    """One device's part of a struct: a ``DTensor``'s local tensor, or the
    tensor itself."""
    return x._local_tensor if hasattr(x, "_local_tensor") else x


def struct_shape(x) -> tuple:
    """One device's shape of a struct (``shard_shape`` in ``repro``)."""
    return tuple(struct_local(x).shape)


def struct_bytes(x) -> int:
    """One device's bytes of a struct."""
    loc = struct_local(x)
    return loc.numel() * loc.element_size()


def param_bytes(specs, dtype: torch.dtype) -> int:
    return param_count(specs) * dtype.itemsize


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """Normalize in fp32, cast back to x's dtype, *then* scale (the JAX
    order: the product rounds in the working dtype)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if _active() is not None:     # a sharded scale (FSDP) is gathered first
        scale = _whole_dim(scale, scale.ndim - 1)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def activation_fn(name: str):
    """The feed-forward activation ``name`` (``repro.models.common``'s):
    ``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation."""
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    if name == "silu":
        return F.silu
    raise KeyError(name)  # swiglu handled structurally (gate ⊙ up)


def rope_angles(positions, head_dim: int, theta: float, scaling=None):
    """(…pos…) → cos/sin of shape (…pos…, head_dim/2), fp32.  ``scaling``
    (a ``configs.base.RopeScaling``) gives YaRN's frequencies and scales
    cos/sin by its :func:`yarn_rope_gain`."""
    half = head_dim // 2
    if scaling is None:
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=positions.device) / half))
    else:
        freqs = yarn_inv_freq(head_dim, theta, scaling, positions.device)
    ang = positions.float()[..., None] * freqs
    if scaling is None:
        return torch.cos(ang), torch.sin(ang)
    gain = yarn_rope_gain(scaling)
    return torch.cos(ang) * gain, torch.sin(ang) * gain


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1·mscale·ln(factor) + 1 (1 for a
    factor ≤ 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(head_dim: int, theta: float, s, device=None):
    """DeepSeek-V2's YaRN inverse frequencies (head_dim/2,), fp32, as its
    published modelling code computes them: dimensions below the
    ``beta_fast`` correction keep theta's, those past the ``beta_slow`` one
    take theirs over ``s.factor``, with a linear ramp between
    (``yarn_find_correction_range``, ``yarn_linear_ramp_mask``)."""
    def corr(rot):
        return (head_dim * math.log(s.original_max_position_embeddings / (rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr(s.beta_fast)), 0)
    high = min(math.ceil(corr(s.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    extra, inter = 1.0 / base, 1.0 / (s.factor * base)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def yarn_rope_gain(s) -> float:
    """The factor on YaRN's cos/sin: mscale(factor, mscale) /
    mscale(factor, mscale_all_dim) (1 for DeepSeek-V2, whose two agree)."""
    return yarn_mscale(s.factor, s.mscale) / yarn_mscale(s.factor, s.mscale_all_dim)


def yarn_softmax_gain(s) -> float:
    """The factor on the attention softmax's scale: mscale(factor,
    mscale_all_dim)² where the config gives ``mscale_all_dim``, else 1 (and
    1 without ``s``)."""
    if s is None or not s.mscale_all_dim:
        return 1.0
    return yarn_mscale(s.factor, s.mscale_all_dim) ** 2


def apply_rope(x, cos, sin):
    """Half-split rotation.  x (..., S, H, D); cos/sin (..., S, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense(x, w):
    """(…, d) @ (d, e) → (…, e), in the promoted dtype of the two (as
    ``jnp.einsum`` promotes: bf16 features by fp32 weights give fp32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if _active() is not None:
        return _dense_sharded(x, w)
    return torch.matmul(x, w)


def proj_heads(x, w):
    """(…, d) @ (d, H, k) → (…, H, k) — per-head input projection."""
    d, h, k = w.shape
    if _active() is None:
        return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))
    return dense(x, _whole_dim(w, 2).reshape(d, h * k)).unflatten(-1, (h, k))


def proj_out(x, w):
    """(…, H, k) @ (H, k, d) → (…, d) — attention output projection."""
    h, k, d = w.shape
    if _active() is None:
        return torch.matmul(x.flatten(-2), w.reshape(h * k, d))
    return dense(_whole_dim(x, x.ndim - 1).flatten(-2), _whole_dim(w, 1).reshape(h * k, d))


def _dense_sharded(x, w):
    """``x @ w`` in a sharded program, on each rank's shards, mesh
    dimension by mesh dimension: rows of ``x`` sharded on its first
    dimension stay so (``w`` gathered there: FSDP); a contraction sharded
    on both sides stays so and sums (row parallel); ``w``'s output columns
    sharded stay so (column parallel); anything else is gathered.  Other
    leading dimensions of ``x`` are gathered, so the product's rows never
    take a strided layout, in the backward pass neither."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import as_dtensor, run_local

    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return torch.matmul(x, w)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last = x.ndim - 1
    xs, ws, outs = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_shard(0) and last > 0:
            xs.append(xp), ws.append(Replicate()), outs.append(Shard(0))
        elif xp.is_shard(last) and wp.is_shard(0):
            xs.append(xp), ws.append(wp), outs.append(Partial())
        elif wp.is_shard(1):
            xs.append(Replicate()), ws.append(wp), outs.append(Shard(last))
        else:
            xs.append(Replicate()), ws.append(Replicate()), outs.append(Replicate())
    return run_local(torch.matmul, mesh, [tuple(xs), tuple(ws)], [tuple(outs)], x, w)


def _whole_dim(w, dim: int):
    """In a sharded program, ``w`` with dimension ``dim`` gathered where it
    is sharded: a per-head width sharded (heads that do not divide the
    mesh re-home to it) would merge with the heads into a strided layout
    that no product takes."""
    pl = getattr(w, "placements", None)
    if pl is None or not any(p.is_shard(dim) for p in pl):
        return w
    from torch.distributed.tensor import Replicate

    return w.redistribute(w.device_mesh, [Replicate() if p.is_shard(dim) else p for p in pl])
