"""Delta updates: edit-rebuild planning (reuse-prefix + rebuild-suffix).

A framework-free copy of the serving half of ``repro.core.planner``
(``token_divergence``, ``EditPlan``, ``plan_edit``); the analytics planner
waits for ROADMAP.md §1 item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .cost import CostModel
from .descriptors import DescriptorIndex, covered_size


def token_divergence(old_ids, new_ids) -> int:
    """Length of the common prefix of two token sequences.

    The first divergence point bounds KV reuse exactly: position ``i``'s
    cached KV depends on *all* tokens ``[0, i]``, so a stored segment
    ``[lo, hi)`` built for the old document is valid for the edited one
    iff ``hi ≤ divergence``.
    """
    old = np.asarray(old_ids).ravel()
    new = np.asarray(new_ids).ravel()
    n = int(min(old.size, new.size))
    if n == 0:
        return 0
    neq = old[:n] != new[:n]
    i = int(np.argmax(neq))
    return n if not neq[i] else i


@dataclass
class EditPlan:
    """Reuse-prefix + rebuild-suffix plan for one document edit.

    ``reuse`` lists the stored segments that survive the edit (every
    descriptor strictly before the divergence point), ``orphans`` the ids
    valid only for the old content.  ``action`` is the cost model's call:
    ``"scratch"`` means the reuse path is priced above a clean rebuild, in
    which case callers skip the rekey and every segment orphans.
    """

    divergence: int             # first differing token index
    length: int                 # tokens of the edited document to build
    reuse: list                 # [(seg_id, Range)], rng.hi <= divergence
    orphans: list               # seg ids invalidated by the edit
    reused_tokens: int          # covered_size of the reuse ranges
    rebuild_tokens: int         # length - reused_tokens (priced extent)
    edit_cost_s: float
    scratch_cost_s: float
    action: str                 # "edit" | "scratch"

    @property
    def rebuild_frac(self) -> float:
        return self.rebuild_tokens / self.length if self.length else 0.0


def plan_edit(old_ids, new_ids, index: DescriptorIndex, cost: CostModel,
              segment_bytes: dict, *, length: Optional[int] = None) -> EditPlan:
    """Price serving an edited document against its stored segments
    (``cost.edit_rebuild_s`` against a from-scratch ``F(n)``)."""
    new = np.asarray(new_ids).ravel()
    n_total = int(new.size) if length is None else int(length)
    div = min(token_divergence(old_ids, new), n_total)
    reuse: list = []
    orphans: list = []
    for sid, rng in index.items():
        if rng.hi <= div:
            reuse.append((sid, rng))
        else:
            orphans.append(sid)
    reused = covered_size([rng for _, rng in reuse])
    reuse_nbytes = sum(segment_bytes.get(sid, 0) for sid, _ in reuse)
    edit_cost = cost.edit_rebuild_s(n_total, reused, reuse_nbytes,
                                    k_segments=max(len(reuse), 1))
    scratch_cost = cost.fetch_points(n_total)
    action = "edit" if reuse and edit_cost < scratch_cost else "scratch"
    if action == "scratch":
        orphans = orphans + [sid for sid, _ in reuse]
        reuse, reused = [], 0
    return EditPlan(divergence=div, length=n_total, reuse=reuse,
                    orphans=orphans, reused_tokens=reused,
                    rebuild_tokens=n_total - reused,
                    edit_cost_s=edit_cost, scratch_cost_s=scratch_cost,
                    action=action)
