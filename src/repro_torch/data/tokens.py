"""Synthetic token pipeline for LM training/serving drivers.

Deterministic Zipf-distributed token streams with simple bigram
structure (so the loss is learnable), shardable across data-parallel
hosts.  Matches the interface a real pipeline would expose: an iterator
of {tokens, targets} batches plus ``input_specs``-compatible shapes.

A copy of the JAX package's ``data/tokens.py``: the batches are numpy
arrays, equal byte for byte for the same seed and shard.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, shard: tuple[int, int] = (0, 1)):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.shard_id, self.num_shards = shard
        self._rng = np.random.default_rng((seed, self.shard_id))
        # Zipf-ish unigram distribution over a capped effective vocab.
        eff = min(vocab_size, 50_000)
        ranks = np.arange(1, eff + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()
        self._eff = eff

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch // self.num_shards
        base = self._rng.choice(self._eff, size=(b, self.seq + 1),
                                p=self._p).astype(np.int32)
        # Bigram structure: with prob .5 next token = f(prev).
        nxt = (base[:, :-1] * 31 + 7) % self._eff
        mix = self._rng.random((b, self.seq)) < 0.5
        tokens = base[:, :-1]
        targets = np.where(mix, nxt, base[:, 1:]).astype(np.int32)
        return {"tokens": tokens, "targets": targets}


def batches(vocab_size: int, batch: int, seq_len: int, steps: int,
            seed: int = 0):
    it = TokenStream(vocab_size, batch, seq_len, seed)
    for _ in range(steps):
        yield next(it)
