"""Deterministic synthetic token streams for LM training (a copy of
``repro.data.tokens``: the same batch for the same address, bit for bit).

A Zipfian unigram mixture with a planted bigram structure — enough signal
that a tiny LM's loss visibly drops (integration tests assert this), fully
seeded, and addressable by (shard, step) so any host can regenerate any
batch: that's what makes the pipeline checkpointable and hedgeable.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab_size
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self.p = p / p.sum()
        rng = np.random.default_rng((seed, 7))
        self.shift = int(rng.integers(1, max(vocab_size - 1, 2)))

    def batch(self, shard: int, step: int, batch: int, seq: int) -> dict:
        """Batch for (shard, step) — pure function of the address."""
        rng = np.random.default_rng((self.seed, shard, step))
        base = rng.choice(self.vocab, size=(batch, seq + 1), p=self.p)
        # planted structure: with prob .5 the next token is prev+shift —
        # chained sequentially so the bigram holds on the *emitted* stream
        follow = rng.random((batch, seq)) < 0.5
        toks = base.copy()
        for i in range(seq):
            toks[:, i + 1] = np.where(
                follow[:, i], (toks[:, i] + self.shift) % self.vocab, base[:, i + 1]
            )
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
