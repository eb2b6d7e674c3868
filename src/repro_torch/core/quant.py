"""Blockwise symmetric int8 quantization for stored cache trees.

The precision rung of segment residency (see ``repro.core.quant`` for the
full account): only floating SEQ leaves quantize; a scale block is one
seq-bucket chunk × head (``(d0, d1, chunk, head)``; headless leaves scale
per chunk); scales are symmetric, ``q = round(x / (max|x| / 127))``, and
zero-safe (an all-zero block gets scale ``1/127``).  Reconstruction error
is bounded by ``scale/2`` elementwise.

The int8 codes equal the JAX package's bit for bit: fp32 cast, ``amax`` per
block, ``scale = amax/127`` in fp32, fp32 division, round half to even
(``torch.round``, as ``jnp.round``), clamp to ±127.

Leaf numbering follows ``jax.tree_util`` order, which visits dict keys
*sorted*, whatever their insertion order: ``QuantMeta.scales`` is keyed by
that flat index, and snapshot files name their scale arrays
``qscale_{index}``, so a manifest written by either package carries each
scale under the other's index too.  The dequant side goes through the
``kernels/quant_kv`` kernel on a CUDA tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.quant_kv import ops as quant_ops
from repro_torch.models.common import CACHE_SEQ_KEYS, cache_leaf_key

#: store-level precision settings: "auto" lets the cost model arbitrate
#: per segment, "fp32" pins everything lossless, "int8" quantizes every
#: admitted segment
PRECISIONS = ("auto", "fp32", "int8")


def resolve_precision(precision: str = "auto") -> str:
    """A store's precision setting, validated (default ``"auto"``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown segment precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    return precision


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (the JAX package's dtype names)."""
    return str(dtype).removeprefix("torch.")


@dataclass
class QuantMeta:
    """Sidecar for a quantized cache tree: which flat leaves are int8
    (keys are ``jax.tree_util``-order leaf indices as strings), their
    per-block fp32 scales, and the dtype names to restore on dequant."""
    block: int
    scales: dict[str, Any]    # flat leaf index -> fp32 scale tensor
    dtypes: dict[str, str]    # flat leaf index -> original dtype name

    def nbytes(self) -> int:
        """Scale bytes, counted into the segment's resident bytes."""
        return sum(s.numel() * s.element_size() for s in self.scales.values())

    def manifest(self) -> dict:
        """JSON-serializable part (scales travel as npz arrays)."""
        return {"block": self.block, "dtypes": dict(self.dtypes)}


def sorted_leaves_with_path(tree, path=()) -> list:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order: lists and tuples
    in order, dict keys sorted, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in sorted_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in sorted_leaves_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _map_sorted(fn, tree, path=(), counter=None):
    """Rebuild ``tree`` (keeping its own dict order) with each leaf mapped
    by ``fn(index, path, leaf)``, ``index`` counted in jax order."""
    if counter is None:
        order = {p: j for j, (p, _) in enumerate(sorted_leaves_with_path(tree))}
        return _map_sorted(fn, tree, path, order)
    if isinstance(tree, dict):
        return {k: _map_sorted(fn, v, path + (k,), counter)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_sorted(fn, v, path + (i,), counter)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(counter[path], path, tree)


def quantize_leaf(x: torch.Tensor, block: int):
    """One SEQ leaf (document axis at 2) → ``(q int8, scales fp32)``.

    The seq extent is chunked into ``block``-row groups (padded up to the
    chunk grid).  Rank-5+ leaves ``(d0, d1, seq, heads, ...)`` get one
    scale per (d0, d1, chunk, head); lower ranks one per (d0, d1, chunk).
    """
    xf = x.float()
    s = xf.shape[2]
    nb = max(1, -(-s // block))
    padded = nb * block
    if padded != s:
        pad = [0, 0] * (xf.ndim - 3) + [0, padded - s]
        xf = torch.nn.functional.pad(xf, pad)
    pre, post = tuple(xf.shape[:2]), tuple(xf.shape[3:])
    xr = xf.reshape(pre + (nb, block) + post)
    if len(post) >= 2:
        # reduce the within-chunk axis and everything past the head axis
        red = (3,) + tuple(range(5, xr.ndim))
    else:
        red = tuple(range(3, xr.ndim))
    amax = xr.abs().amax(dim=red)
    # zero-safe symmetric scale: an all-zero block quantizes to zeros and
    # reconstructs exactly instead of dividing by zero
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    sexp = scale
    for ax in red:
        sexp = sexp.unsqueeze(ax)
    q = torch.clamp(torch.round(xr / sexp), -127, 127).to(torch.int8)
    q = q.reshape(pre + (padded,) + post)
    if padded != s:
        q = q[:, :, :s].contiguous()
    return q, scale


def dequantize_leaf(q, scale, *, block: int, dtype):
    """Inverse of :func:`quantize_leaf`, through the kernel layer."""
    return quant_ops.dequantize_leaf(q, scale, block=block, dtype=dtype)


def _quantizable(path, x) -> bool:
    return (cache_leaf_key(path) in CACHE_SEQ_KEYS
            and x.ndim >= 3 and x.is_floating_point())


def quantize_tree(caches, *, block: int):
    """Quantize a stored cache tree → ``(qtree, QuantMeta)``.

    Floating SEQ leaves become int8 in place of their values (same tree
    structure and shapes); state/constant leaves pass through untouched
    and are absent from the meta.
    """
    scales, dtypes = {}, {}

    def f(j, path, x):
        if not _quantizable(path, x):
            return x
        q, s = quantize_leaf(x, block)
        scales[str(j)] = s
        dtypes[str(j)] = dtype_name(x.dtype)
        return q

    qtree = _map_sorted(f, caches)
    return qtree, QuantMeta(block=block, scales=scales, dtypes=dtypes)


def dequantize_tree(qtree, meta: QuantMeta):
    """Reconstruct model-precision caches from a quantized tree.

    The quantized leaves go to the kernel layer together, one call (one
    launch on the card) per output dtype and per ``MAX_LEAVES`` leaves: a
    stored segment's k and v make one."""
    flat = sorted_leaves_with_path(qtree)
    by_dtype: dict[str, list[int]] = {}
    for key in meta.scales:
        by_dtype.setdefault(meta.dtypes[key], []).append(int(key))
    out = {}
    for dtype, js in by_dtype.items():
        js.sort()
        for i in range(0, len(js), quant_ops.MAX_LEAVES):
            part = js[i:i + quant_ops.MAX_LEAVES]
            res = quant_ops.dequantize_leaves([(flat[j][1], meta.scales[str(j)]) for j in part],
                                              block=meta.block, dtype=dtype)
            out.update(zip(part, res))
    order = {path: j for j, (path, _) in enumerate(flat)}
    return _map_sorted(lambda j, path, x: out.get(j, x), qtree, (), order)
