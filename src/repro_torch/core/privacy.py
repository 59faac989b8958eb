"""Unlinkability bounds (paper §IV-A/B) and empirical posterior checks.

Implements every closed-form bound in the analysis:

* Eq. (1)  per-transfer cap:          O_u/B_u <= kappa_u / k
* spray mean mu_u and its Chernoff lower tail
* lag lead probability p_lead = (T_lag - 1) / (2 T_lag)
* Eq. (2)  high-probability mixing bound
* Eq. (3)  alliance-filtering bound (collusion, recognition phi)
* Eq. (4)  high-probability collusion bound
* Eq. (5)  repeated-observation union bound

Empirical counterparts read the simulator's transfer log, which records
(B_u, O_u) at every send, so tests can assert the caps transfer-by-
transfer (tests/test_privacy_bounds.py uses hypothesis sweeps).
"""
from __future__ import annotations

import numpy as np

from .trace import TransferTrace


# ----------------------------------------------------------------------
# Closed-form bounds
# ----------------------------------------------------------------------

def per_transfer_cap(kappa: int, k_gate: int) -> float:
    """Eq. (1): posterior cap kappa_u / k for any honest-sender transfer."""
    if k_gate <= 0:
        return 1.0
    return min(1.0, kappa / k_gate)


def spray_mean(sigma: int, n: int) -> float:
    """Near-regular approximation mu_u ~= sigma (paper §IV-A).

    Each of the other sources sprays sigma copies uniformly over its
    ~n-1-m non-neighbors; summing over ~n-1-m eligible sources whose
    non-neighborhood contains u gives mu_u -> sigma as n grows."""
    return float(sigma) if n > 1 else 0.0


def spray_mean_adj(sigma: int, adj: np.ndarray, u: int) -> float:
    """Exact mu_u given the overlay adjacency."""
    n = adj.shape[0]
    mu = 0.0
    for v in range(n):
        if v == u or adj[v, u]:
            continue  # u must be a NON-neighbor of the source v
        denom = n - 1 - int(adj[v].sum())
        if denom > 0:
            mu += sigma / denom
    return mu


def chernoff_lower_tail(mu: float, eps: float) -> float:
    """Pr[Z <= (1-eps) mu] <= exp(-eps^2 mu / 2)  (Poisson-binomial)."""
    if mu <= 0:
        return 1.0
    return float(np.exp(-eps * eps * mu / 2.0))


def lead_probability(t_lag: int) -> float:
    """p_lead = Pr[l_v < l_u] = (T_lag - 1) / (2 T_lag) for iid uniform."""
    if t_lag <= 1:
        return 0.0
    return (t_lag - 1) / (2.0 * t_lag)


def lag_mass_mean(m: float, t_lag: int, q: float) -> float:
    """E[Z_T(u)] >= m * p_lead * q  (availability factor q in (0,1])."""
    return m * lead_probability(t_lag) * q


def high_prob_posterior_bound(
    kappa: int, mu_u: float, m: float, t_lag: int, q: float, eps: float,
) -> tuple[float, float]:
    """Eq. (2): (bound, eta).  With prob >= 1 - eta,
    O_u/B_u <= kappa / (kappa + (1-eps)(mu_u + m (T_lag-1)/(2 T_lag) q))."""
    zt = lag_mass_mean(m, t_lag, q)
    eta = chernoff_lower_tail(mu_u, eps) + chernoff_lower_tail(zt, eps)
    denom = kappa + (1.0 - eps) * (mu_u + zt)
    return kappa / denom if denom > 0 else 1.0, min(eta, 1.0)


def alliance_filter_bound(
    kappa: int, k_gate: int, x_u: float, rho_u: float, phi: float,
) -> float:
    """Eq. (3): theta_u^AF <= min{kappa/k, kappa/(kappa + (1-phi rho) X_u)}."""
    x_eff = (1.0 - phi * rho_u) * x_u
    cap = per_transfer_cap(kappa, k_gate)
    mixed = kappa / (kappa + x_eff) if (kappa + x_eff) > 0 else 1.0
    return min(cap, mixed)


def collusion_high_prob_bound(
    kappa: int, k_gate: int, sigma: int, m: float, t_lag: int, q: float,
    rho_u: float, phi: float, eps: float,
) -> tuple[float, float]:
    """Eq. (4): high-probability version of the alliance-filtered bound."""
    zt = lag_mass_mean(m, t_lag, q)
    eta = chernoff_lower_tail(float(sigma), eps) + chernoff_lower_tail(zt, eps)
    x = (1.0 - phi * rho_u) * (1.0 - eps) * (sigma + zt)
    cap = per_transfer_cap(kappa, k_gate)
    mixed = kappa / (kappa + x) if (kappa + x) > 0 else 1.0
    return min(cap, mixed), min(eta, 1.0)


def repeated_observation_bound(
    s_u: int, kappa: int, k_gate: int, x_u: float, rho_u: float, phi: float,
) -> float:
    """Eq. (5): union bound over s_u observations from the same sender."""
    per = alliance_filter_bound(kappa, k_gate, x_u, rho_u, phi)
    return min(1.0, s_u * per)


def unlinkability_level(kappa: int, k_gate: int) -> float:
    """P >= k / kappa (§II-D / §IV-A)."""
    return k_gate / max(kappa, 1)


# ----------------------------------------------------------------------
# Empirical accounting from a simulated round
# ----------------------------------------------------------------------

def empirical_posteriors(log, warmup_only: bool = True) -> np.ndarray:
    """Per-transfer empirical O_u/B_u for honest-sender transfers.

    ``log`` is a :class:`~repro.core.trace.TransferTrace` (legacy log
    dicts are coerced at the boundary).
    """
    tr = TransferTrace.from_log(log)
    view = tr.warmup() if warmup_only else tr
    b = np.maximum(view.b_size.astype(np.float64), 1.0)
    return view.o_size.astype(np.float64) / b


def check_eq1(log, kappa: int, k_gate: int) -> bool:
    """Every gated warm-up transfer satisfies O_u/B_u <= kappa/k_gate."""
    post = empirical_posteriors(log, warmup_only=True)
    return bool((post <= per_transfer_cap(kappa, k_gate) + 1e-12).all())
