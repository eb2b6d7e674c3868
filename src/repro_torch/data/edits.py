"""Token-level edit scripts for the delta-update path.

Edits are the serving-side analogue of the paper's add/delete deltas: a
document mutates in place (a line inserted, a span deleted, a token
replaced) and the store should keep every KV segment strictly before the
first divergence point.  These helpers produce the edited token sequences
of the launch driver's ``--edit-every`` traffic mode.

A copy of ``repro.data.edits`` (numpy only): both packages make the same
edits from the same generator state.
"""
from __future__ import annotations

import numpy as np

EDIT_KINDS = ("insert", "delete", "replace")


def apply_edit(doc: np.ndarray, kind: str, offset: int, length: int,
               tokens=None) -> np.ndarray:
    """Apply one edit to a token sequence; returns a new int32 array.

    ``insert`` places ``tokens`` (or ``length`` zeros) before ``offset``;
    ``delete`` removes ``doc[offset:offset+length]``; ``replace``
    overwrites that span with ``tokens`` (or with each token + 1, which is
    guaranteed to differ).  ``offset`` is clamped into ``[0, len(doc)]``
    so randomized scripts never index out of range.
    """
    doc = np.asarray(doc, np.int32)
    offset = int(np.clip(offset, 0, len(doc)))
    length = max(int(length), 0)
    if kind == "insert":
        ins = (np.asarray(tokens, np.int32) if tokens is not None
               else np.zeros(length, np.int32))
        return np.concatenate([doc[:offset], ins, doc[offset:]])
    if kind == "delete":
        return np.concatenate([doc[:offset], doc[offset + length:]])
    if kind == "replace":
        span = doc[offset:offset + length]
        rep = (np.asarray(tokens, np.int32) if tokens is not None
               else (span + 1))
        return np.concatenate([doc[:offset], rep[:len(span)],
                               doc[offset + len(span):]])
    raise ValueError(f"unknown edit kind {kind!r}")


def random_edit(rng: np.random.Generator, doc: np.ndarray, vocab: int, *,
                kinds=EDIT_KINDS, max_span: int = 16,
                min_offset: int = 0):
    """One random edit: returns ``(edited_doc, kind, offset, length)``.

    ``min_offset`` keeps edits away from the document head when a traffic
    generator wants a reusable prefix to exist at all; spans are 1..
    ``max_span`` tokens.  Replacement tokens are drawn fresh from the
    vocabulary, so a "replace" genuinely diverges with probability
    ``1 - 1/vocab`` per token (the driver retries via content keys).
    """
    doc = np.asarray(doc, np.int32)
    kind = str(rng.choice(list(kinds)))
    hi = max(len(doc), min_offset + 1)
    offset = int(rng.integers(min_offset, hi))
    length = int(rng.integers(1, max_span + 1))
    if kind == "delete":
        tokens = None
    else:
        tokens = rng.integers(0, vocab, size=length).astype(np.int32)
    return apply_edit(doc, kind, offset, length, tokens), kind, offset, length
