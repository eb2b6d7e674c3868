"""Int8 compression with error feedback, and the wire payload format.

The counterpart of ``repro.distributed.compression``.  ``quantize_int8``
is per-tensor symmetric int8 (zero-safe: the scale comes from ``amax``
itself, so ``|x - deq| <= scale/2`` holds and clipping never engages),
with the JAX package's arithmetic: fp32 cast, ``scale = amax/127`` in
fp32, fp32 division, round half to even, clamp to ±127, so the codes are
``repro``'s bit for bit.  ``ef_compress`` carries the quantization
residual to the next step (error feedback, Seide et al. 2014).

``repro``'s ``compressed_psum`` (an all-gather over a mesh axis inside the
train step) belongs to training on a device mesh and is not here.

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

from repro_torch.models.common import tree_leaves, tree_map_with_path


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q int8, scale fp32 0-d)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, ef: torch.Tensor):
    """Error-feedback int8: quantize (g + residual), carry new residual."""
    corrected = g.float() + ef
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale)
    return q, scale, corrected - deq


def ef_state_like(grads):
    """fp32 zeros shaped like every leaf of a dict/list/tuple tree."""
    return tree_map_with_path(
        lambda _, g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


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
