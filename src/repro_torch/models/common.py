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


def rope_angles(positions, head_dim: int, theta: float):
    """(…pos…) → cos/sin of shape (…pos…, head_dim/2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Half-split rotation.  x (..., S, H, D); cos/sin (..., S, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense(x, w):
    """(…, d) @ (d, e) → (…, e)."""
    return torch.matmul(x, w)


def proj_heads(x, w):
    """(…, d) @ (d, H, k) → (…, H, k) — per-head input projection."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def proj_out(x, w):
    """(…, H, k) @ (H, k, d) → (…, d) — attention output projection."""
    h, k, d = w.shape
    return torch.matmul(x.flatten(-2), w.reshape(h * k, d))
