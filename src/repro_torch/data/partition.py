"""Client data partitioning for FL (paper §V-B).

Non-IID partitions follow a Dirichlet sampler with concentration
``alpha`` (smaller alpha => stronger heterogeneity), the standard FL
benchmark protocol; IID is uniform random splitting.

A copy of the JAX package's ``data/partition.py`` with the same numpy
rng stream, so a seed gives the same client index sets.
"""
from __future__ import annotations

import numpy as np

from .synthetic import Dataset


def iid_partition(ds: Dataset, n_clients: int, rng: np.random.Generator
                  ) -> list[np.ndarray]:
    idx = rng.permutation(len(ds))
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def dirichlet_partition(ds: Dataset, n_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_size: int = 2) -> list[np.ndarray]:
    """Label-distribution-skew partition: p_k ~ Dir(alpha) per class."""
    for _ in range(100):
        parts: list[list[int]] = [[] for _ in range(n_clients)]
        for k in range(ds.num_classes):
            kidx = np.flatnonzero(ds.y == k)
            rng.shuffle(kidx)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(kidx)).astype(int)[:-1]
            for i, sl in enumerate(np.split(kidx, cuts)):
                parts[i].extend(sl.tolist())
        sizes = [len(p) for p in parts]
        if min(sizes) >= min_size:
            return [np.sort(np.asarray(p)) for p in parts]
    raise RuntimeError("dirichlet partition failed to satisfy min_size")


def partition(ds: Dataset, n_clients: int, dist: str,
              seed: int = 0) -> list[np.ndarray]:
    """dist in {"iid", "dir0.1", "dir0.5", "dir1.0", ...}."""
    rng = np.random.default_rng(seed)
    if dist == "iid":
        return iid_partition(ds, n_clients, rng)
    if dist.startswith("dir"):
        return dirichlet_partition(ds, n_clients, float(dist[3:]), rng)
    raise ValueError(dist)
