"""Decode-pack buffers reused per shape.

A pack is every row's cache side by side along the batch axis, padded to
one bucketed capacity along the sequence axis of the SEQ leaves.  The
decode step writes its K/V into the pack in place, and a CUDA graph of the
step bakes the pack's addresses in (``models/graphs.py``), so a pack that
is built again into the same buffer replays the graph captured over it.
:class:`PackPool` keeps the buffers of dissolved packs under their key
(batch signature, rows, capacity) and hands one back for the next pack of
that key.

A buffer holds whatever its last pack left past each row's own capacity:
finite K/V that no step reads (the decode kernel stops each row at its own
``pos``, and the plain versions mask those positions out of every sum).  A
new buffer starts as zeros.  The pool's bytes, in packs and free, stay
within ``bound`` as long as the packs alive at once fit in it: a new buffer
first drops free ones, the least recently used key first.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any

import torch

from repro_torch.models.common import tree_leaves, tree_map_with_path

from .kv_cache import SEQ_KEYS, _leaf_key


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class PackPool:
    """Buffers of dissolved packs, by key, least recently used first.

    ``bound`` is in bytes; ``nbytes`` counts every buffer the pool made and
    has not dropped, in a pack or free.
    """

    def __init__(self, bound: int) -> None:
        self.bound = bound
        self.nbytes = 0
        self._free: OrderedDict = OrderedDict()

    def take(self, key, rows: list, cap: int) -> tuple[Any, bool]:
        """A pack of ``rows`` (caches with one row each) at capacity ``cap``
        under ``key``, in a free buffer when the key has one; returns (pack,
        whether a buffer was reused)."""
        free = self._free.get(key)
        if free:
            buf = free.pop()
            if not free:
                del self._free[key]
            reused = True
        else:
            n = len(rows)
            shapes: list = []
            tree_map_with_path(lambda path, x: shapes.append(
                (_padded(path, x, n, cap), x.element_size())), rows[0])
            self._shrink(self.bound - sum(math.prod(sh) * e for sh, e in shapes))
            buf = tree_map_with_path(
                lambda path, x: torch.zeros(_padded(path, x, n, cap), dtype=x.dtype,
                                            device=x.device), rows[0])
            self.nbytes += _nbytes(buf)
            reused = False
        for i, row in enumerate(rows):
            tree_map_with_path(lambda path, b, x, i=i: _fill(path, b, x, i), buf, row)
        return buf, reused

    def give(self, key, buf) -> None:
        """Take back the buffer of a dissolved pack."""
        self._free.setdefault(key, []).append(buf)
        self._free.move_to_end(key)
        self._shrink(self.bound)

    def _shrink(self, limit: int) -> None:
        """Drop free buffers, least recently used key first, until the pool
        holds at most ``limit`` bytes or nothing free."""
        while self.nbytes > limit and self._free:
            key, free = next(iter(self._free.items()))
            self.nbytes -= _nbytes(free.pop())
            if not free:
                del self._free[key]


def _padded(path, x, rows: int, cap: int) -> tuple:
    """The pack's shape of a one-row cache leaf ``x``."""
    shape = list(x.shape)
    shape[1] = rows
    if _leaf_key(path) in SEQ_KEYS:
        shape[2] = cap
    return tuple(shape)


def _fill(path, buf, x, i: int):
    """Row ``i`` of the pack ``buf`` from the one-row cache leaf ``x``."""
    if _leaf_key(path) in SEQ_KEYS:
        buf[:, i:i + 1, :x.shape[2]].copy_(x)
    else:
        buf[:, i:i + 1].copy_(x)
    return buf
