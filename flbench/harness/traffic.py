"""Traffic: the token stream of the FL rounds, drawn from the seed.

``synthetic_batch`` is a frozen copy of the program's
``launch/train.py::synthetic_batch`` (the next-token-predictable
stream: each row ``base + step * position mod vocab``), drawing the
same numbers from the same numpy generator."""
from __future__ import annotations

import numpy as np


def synthetic_batch(rng: np.random.Generator, n_pods: int, b_local: int,
                    seq: int, vocab: int):
    """-> (inputs, labels), numpy int64 arrays of (n_pods, b_local, seq)."""
    base = rng.integers(0, vocab, size=(n_pods, b_local, 1))
    step = rng.integers(1, 7, size=(n_pods, b_local, 1))
    seqs = (base + step * np.arange(seq + 1)) % vocab
    return seqs[..., :-1], seqs[..., 1:]


def batch_pool(traffic: dict, vocab: int, seed: int) -> list:
    """``traffic["batch_pool"]`` distinct batches for the seed; rounds
    take them in turn.  Every seed gets the same sizes."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    return [synthetic_batch(rng, traffic["pods"], traffic["rows_per_pod"],
                            traffic["seq"], vocab)
            for _ in range(traffic["batch_pool"])]


def round_tokens(traffic: dict) -> int:
    return traffic["pods"] * traffic["rows_per_pod"] * traffic["seq"]
