"""Session helpers.  Only the content key is ported so far; the batched
``SessionManager`` waits for ROADMAP.md §1 item 4."""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def doc_key(doc_tokens: np.ndarray, extras: Optional[dict] = None) -> str:
    """Content-derived document id: identical documents share segments.

    ``extras`` (encoder features / image embeddings, as numpy arrays)
    condition the KV a prefill produces, so they are part of document
    identity.  sha256, so the id is identical across processes and hosts
    (and equal to ``repro.serve.session.doc_key`` for the same inputs).
    """
    h = hashlib.sha256(np.ascontiguousarray(doc_tokens, np.int32).tobytes())
    for k in sorted(extras or {}):
        h.update(k.encode())
        h.update(np.ascontiguousarray(extras[k]).tobytes())
    return h.hexdigest()[:12]
