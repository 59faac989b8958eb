"""Overlay graph generation (paper §II-B, §V-A).

The tracker samples a fresh overlay ``G^r`` every round: a random graph
with *minimum* degree ``m`` and heterogeneous neighbor counts above ``m``
(§V-A).  Regenerating per round prevents long-lived neighbor
relationships that could amplify cross-round linkage (§III-E).
"""
from __future__ import annotations

import numpy as np


def random_overlay(
    n: int,
    min_degree: int,
    extra_edge_frac: float = 0.1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sample a connected overlay with minimum degree ``min_degree``.

    Construction: a random ``m``-regular backbone (configuration-model
    style with retry) plus a fraction of extra random edges so neighbor
    counts are heterogeneous above ``m``.  Returns a dense symmetric bool
    adjacency matrix with zero diagonal.

    ``rng`` must be the caller's threaded generator: a constant-seed
    fallback here would hand every un-threaded caller the SAME overlay
    while looking random (swarmlint RNG004).
    """
    if rng is None:
        raise ValueError(
            "random_overlay requires a threaded np.random.Generator; "
            "pass the round's rng (e.g. default_rng(cfg.seed))")
    m = min_degree
    if m >= n:
        raise ValueError(f"min_degree {m} must be < n {n}")
    adj = _regular_backbone(n, m, rng)
    # Heterogeneous extras: add ~extra_edge_frac * n * m / 2 random edges.
    n_extra = int(extra_edge_frac * n * m / 2)
    if n_extra > 0:
        us = rng.integers(0, n, size=4 * n_extra)
        vs = rng.integers(0, n, size=4 * n_extra)
        keep = us != vs
        us, vs = us[keep][:n_extra], vs[keep][:n_extra]
        adj[us, vs] = True
        adj[vs, us] = True
    # Ensure connectivity (rare for m >= 3; repair by linking components).
    adj = _ensure_connected(adj, rng)
    np.fill_diagonal(adj, False)
    return adj


def _regular_backbone(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """Near-m-regular random graph via stub matching with local repair."""
    if (n * m) % 2 == 1:
        m_eff = m + 1  # need even stub count; overshoot keeps min degree
    else:
        m_eff = m
    for _ in range(50):
        stubs = np.repeat(np.arange(n), m_eff)
        rng.shuffle(stubs)
        a, b = stubs[0::2], stubs[1::2]
        ok = a != b
        adj = np.zeros((n, n), dtype=bool)
        adj[a[ok], b[ok]] = True
        adj[b[ok], a[ok]] = True
        deg = adj.sum(1)
        if (deg >= m).all():
            return adj
        # Repair: connect deficient nodes to random others.
        for v in np.flatnonzero(deg < m):
            need = int(m - adj[v].sum())
            if need <= 0:
                continue
            cands = np.flatnonzero(~adj[v])
            cands = cands[cands != v]
            pick = rng.choice(cands, size=min(need, cands.size), replace=False)
            adj[v, pick] = True
            adj[pick, v] = True
        if (adj.sum(1) >= m).all():
            return adj
    raise RuntimeError("failed to build overlay backbone")


def _ensure_connected(adj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = adj.shape[0]
    comp = _components(adj)
    n_comp = comp.max() + 1
    while n_comp > 1:
        # Link a random node of component 0 with one of another component.
        a = rng.choice(np.flatnonzero(comp == 0))
        b = rng.choice(np.flatnonzero(comp != 0))
        adj[a, b] = adj[b, a] = True
        comp = _components(adj)
        n_comp = comp.max() + 1
    return adj


def _components(adj: np.ndarray) -> np.ndarray:
    """Connected-component labels via BFS over the bool adjacency."""
    n = adj.shape[0]
    comp = np.full(n, -1, dtype=np.int64)
    cur = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        frontier = np.zeros(n, dtype=bool)
        frontier[s] = True
        comp[s] = cur
        while frontier.any():
            nxt = (adj[frontier].any(0)) & (comp < 0)
            comp[nxt] = cur
            frontier = nxt
        cur += 1
    return comp


def neighbors(adj: np.ndarray, v: int) -> np.ndarray:
    return np.flatnonzero(adj[v])


def average_degree(adj: np.ndarray) -> float:
    return float(adj.sum(1).mean())
