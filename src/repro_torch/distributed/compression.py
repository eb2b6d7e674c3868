"""Int8 compression with error feedback, and the wire payload format.

The counterpart of ``repro.distributed.compression``.  ``quantize_int8``
is per-tensor symmetric int8 (zero-safe: the scale comes from ``amax``
itself, so ``|x - deq| <= scale/2`` holds and clipping never engages),
with the JAX package's arithmetic: fp32 cast, ``scale = amax/127`` in
fp32, fp32 division, round half to even, clamp to ±127, so the codes are
``repro``'s bit for bit.  ``ef_compress`` carries the quantization
residual to the next step (error feedback, Seide et al. 2014).

``compressed_psum`` is the EF-int8 mean over a process group (the pod
dimension of the multipod train step): each rank's int8 payload and its
one fp32 scale are all-gathered, and every rank sums the dequantized
payloads in rank order.

The sharded segment store rides this module for its wire payloads:
``pack_arrays``/``unpack_arrays`` turn a named-array dict (a segment's
``leaf_*`` arrays plus ``qscale_*`` sidecars, numpy) into one
``np.savez_compressed`` (zlib DEFLATE) byte string — the snapshot entry
format, reused as the transfer format, the same bytes ``repro`` writes.
"""
from __future__ import annotations

import io

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import zeros_placed
from repro_torch.models.common import tree_leaves, tree_map_with_path, tree_unflatten


def quantize_int8(x: torch.Tensor, max_over=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q int8, scale fp32 0-d).

    ``x`` may be one shard of a tensor split over the process groups
    ``max_over``: ``amax`` is then the whole tensor's (a maximum over the
    groups, exact in any order), so the shard's codes are the whole
    tensor's."""
    xf = x.float()
    amax = xf.abs().max()
    for group in max_over:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, ef: torch.Tensor, max_over=()):
    """Error-feedback int8: quantize (g + residual), carry new residual
    (``max_over`` as in :func:`quantize_int8`)."""
    corrected = g.float() + ef
    q, scale = quantize_int8(corrected, max_over)
    deq = dequantize_int8(q, scale)
    return q, scale, corrected - deq


def ef_state_like(grads):
    """fp32 zeros shaped like every leaf of a dict/list/tuple tree (a
    ``DTensor`` leaf's laid out like it)."""
    return tree_map_with_path(lambda _, g: zeros_placed(g), grads)


#: elements per slice of the mean's fp64 sum (128 MiB of fp64)
_SLICE = 1 << 24


def _process_group(group):
    """A ``ProcessGroup``, or the group of a one-dimensional ``DeviceMesh``."""
    return group.get_group() if hasattr(group, "get_group") else group


def compressed_mean(g: torch.Tensor, ef: torch.Tensor, group, max_over=()):
    """One leaf of :func:`compressed_psum`: (the mean over ``group`` of
    every rank's dequantized ``ef_compress(g, ef, max_over)``, in ``g``'s
    dtype; this rank's new residual).  With ``max_over``, ``g`` and ``ef``
    are one shard of a leaf split over those groups, and only the shard's
    codes and the scale cross ``group``.

    The sum runs in rank order with ``repro``'s rounding (XLA's fp32 dot):
    the first term ``scale_0 · q_0`` rounded to fp32, then each further
    term added with one rounding, as a fused multiply-add (exact in fp64,
    ``scale_i · q_i`` having at most 32 significant bits), in slices of
    ``_SLICE`` elements; then the division by n.  At n = 1 the mean is
    ``dequantize_int8(q, scale)`` bit for bit.  Temporaries are freed
    before it returns.
    """
    pg = _process_group(group)
    q, scale, new_ef = ef_compress(g, ef, max_over)
    n = dist.get_world_size(pg)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=pg)              # int8 on the wire
    dist.all_gather(scales, scale, group=pg)      # one fp32 each
    del q
    acc = scales[0] * qs[0].float()
    flat = acc.view(-1)
    for i in range(1, n):
        qi, si = qs[i].view(-1), scales[i].double()
        for lo in range(0, flat.numel(), _SLICE):
            sl = slice(lo, lo + _SLICE)
            flat[sl] = (flat[sl].double() + si * qi[sl].double()).float()
    del qs
    return acc.div_(n).to(g.dtype), new_ef


def shard_of(x: torch.Tensor) -> tuple:
    """(``x``'s local shard, the process groups of its mesh's dimensions
    larger than 1): a ``DTensor``'s shard is its storage (a write in place
    writes the ``DTensor``); a plain tensor is its own shard, over none."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x, ()
    mesh = x.device_mesh
    loc = x.to_local()
    loc = loc.wait() if hasattr(loc, "wait") else loc
    return loc, tuple(mesh.get_group(i) for i in range(mesh.ndim) if mesh.size(i) > 1)


def compressed_psum(grads, ef_state, group):
    """EF-int8 all-reduce over ``group`` (mean), leaf by leaf:
    ``(mean_tree, new_ef_tree)``, as ``repro``'s over a mesh axis.

    ``group`` is a ``ProcessGroup`` or one dimension of a ``DeviceMesh``
    (``mesh["pod"]``).  The wire carries the int8 payload and one fp32
    scale per leaf: 1 byte/element against 8 for a ring fp32 all-reduce.
    """
    pairs: list = []
    tree_map_with_path(lambda _, g, e: pairs.append(compressed_mean(g, e, group)),
                       grads, ef_state)
    return (tree_unflatten(grads, [m for m, _ in pairs]),
            tree_unflatten(grads, [e for _, e in pairs]))


def compressed_bytes(grads) -> int:
    """Wire bytes with compression (int8 payload + one fp32 scale each)."""
    return sum(x.numel() + 4 for x in tree_leaves(grads))


def raw_bytes(grads) -> int:
    """Wire bytes of the same tree in fp32."""
    return sum(x.numel() * 4 for x in tree_leaves(grads))


# -- segment wire payloads ---------------------------------------------------

def pack_arrays(arrays: dict) -> bytes:
    """Serialize a named numpy-array payload into one compressed byte
    string (``np.savez_compressed``): int8 leaves compress on top of their
    dtype shrink; zero-length tails and 0-d arrays are kept exactly."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def unpack_arrays(data: bytes):
    """Inverse of :func:`pack_arrays`: an ``NpzFile`` (mapping with
    ``.files``), the handle the snapshot loader consumes."""
    return np.load(io.BytesIO(data))
