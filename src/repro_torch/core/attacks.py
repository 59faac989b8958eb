"""Observation-only attribution attacks and the ASR metric (paper §IV-C).

All strategies fit Adversary A (honest-but-curious, possibly colluding):
they read only protocol-visible signals — sender round pseudonyms, piece
indices (mapped to *descriptor ids*, never owner identities), and
arrival order — from warm-up transfers observed by corrupted receivers,
i.e. from a :class:`~repro.core.trace.TransferTrace` masked with
:meth:`~repro.core.trace.TransferTrace.observed_by`.

For each observed sender pseudonym the attacker outputs a descriptor
guess ("this sender is the source of that update").  A guess is correct
when the descriptor is the sender's own update.  Per-observer ASR is the
fraction of its observed senders attributed correctly; the paper's
conservative summary is the **maximum ASR over receivers** (and over
coalition members), which we report alongside the mean.

Descriptor ids: under homogeneous update sizes every update has K
chunks, so piece (c) belongs to descriptor ``c // K``.  The attacker
knows the descriptor partition (public torrent metadata) but not the
descriptor -> client mapping — attributing that mapping is exactly the
attack.

Implementations
---------------
The three single-round scorers are **vectorized** over the trace
columns (grouped ``np.unique`` / ``np.lexsort`` statistics instead of a
Python loop per observation) and reproduce the historical
per-observation reference implementations decision-for-decision; the
references are kept (``*_reference``) for the equivalence tests and the
``benchmarks/bench_attacks.py`` speedup baseline.

Cross-round adversary: :func:`persistent_neighbor_linkage` is the first
attack that exploits §III-E session persistence — an observer that stays
adjacent to the same physical sender across rounds
(``SwarmSession.pair_exposure()``) pools its per-round observations:
round-invariant evidence features (count share, earliness) of the
provisional per-round winners form a cross-round profile that re-ranks
noisy rounds, so accuracy grows with exposure instead of resetting at
every round boundary.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .trace import TransferTrace


@dataclass
class AttackReport:
    asr_per_observer: dict           # observer -> accuracy
    max_asr: float
    mean_asr: float
    n_decisions: int
    any_correct_rate: float = 0.0    # for coalitions


def _as_trace(log, K: int | None = None) -> TransferTrace:
    return TransferTrace.from_log(log, K=K)


def _observations(log, observers: np.ndarray, K: int):
    """Warm-up transfers visible to the coalition, in arrival order
    (stable slot sort, preserving within-slot log order).

    Gathers only the four observation columns (observer-membership via
    an O(1)-lookup table, not a sorted ``isin``) — this boundary is
    shared by the vectorized and reference scorers, so it must stay off
    the critical path of both.
    """
    tr = _as_trace(log, K)
    observers = np.asarray(observers, np.int64).ravel()
    rcv_all = tr.receiver
    mx = int(rcv_all.max(initial=-1))
    lut = np.zeros(mx + 2, dtype=bool)
    lut[observers[(observers >= 0) & (observers <= mx)]] = True
    mask = (tr.phase == 1) & lut[rcv_all]
    slots = tr.slot[mask]
    order = np.argsort(slots, kind="stable")
    return (slots[order], tr.sender[mask][order].astype(np.int64),
            rcv_all[mask][order].astype(np.int64),
            (tr.chunk[mask] // tr.K)[order])


def _empty_report() -> AttackReport:
    return AttackReport({}, 0.0, 0.0, 0)


def _report(g_obs: np.ndarray, g_snd: np.ndarray, g: np.ndarray,
            correct: np.ndarray | None = None,
            obs_stream: np.ndarray | None = None) -> AttackReport:
    """Score a batch of (observer, sender) -> descriptor guesses.

    ``obs_stream`` (the observer key of every raw observation, in
    arrival order) fixes the observer ordering used for the mean-ASR
    reduction to first-appearance order — bit-identical to the
    reference scorers' dict-insertion-order ``np.mean``.
    """
    if len(g) == 0:
        return _empty_report()
    if correct is None:
        correct = g == g_snd   # descriptor id == owner index in-round
    g_obs = np.asarray(g_obs, np.int64)
    ou, inv = np.unique(g_obs, return_inverse=True)
    tot = np.bincount(inv)
    cor = np.bincount(inv, weights=correct.astype(np.float64))
    vals = cor / tot
    if obs_stream is not None:
        su, sf = np.unique(np.asarray(obs_stream, np.int64),
                           return_index=True)
        stream_order = su[np.argsort(sf)]       # first-appearance order
        stream_order = stream_order[np.isin(stream_order, ou)]
        pos = np.searchsorted(ou, stream_order)
        vals = vals[pos]
        ou = ou[pos]
    asr = {int(o): float(v) for o, v in zip(ou, vals)}
    return AttackReport(asr, float(vals.max()), float(vals.mean()),
                        int(tot.sum()),
                        any_correct_rate=float(bool(correct.any())))


def _obs_key(rcv: np.ndarray, pooled: bool) -> np.ndarray:
    """Observer key per observation: the receiver, or one virtual
    pooled observer (-1) modeling coalition evidence (§IV-B)."""
    if pooled:
        return np.full(len(rcv), -1, dtype=np.int64)
    return rcv.astype(np.int64)


# ----------------------------------------------------------------------
# (1) Sequential Greedy: first chunk from each sender is labeled its own.
# ----------------------------------------------------------------------

def sequential_greedy(log, observers, K: int,
                      pooled: bool = False) -> AttackReport:
    slots, snd, rcv, desc = _observations(log, observers, K)
    if len(snd) == 0:
        return _empty_report()
    obs = _obs_key(rcv, pooled)
    pk = (obs + 1) * (int(snd.max()) + 2) + snd
    _, first = np.unique(pk, return_index=True)   # first occurrence
    return _report(obs[first], snd[first], desc[first], obs_stream=obs)


# ----------------------------------------------------------------------
# (2) Amount Greedy: most frequent descriptor among a sender's
#     transfers, earliest-first tiebreak.
# ----------------------------------------------------------------------

def amount_greedy(log, observers, K: int,
                  pooled: bool = False) -> AttackReport:
    slots, snd, rcv, desc = _observations(log, observers, K)
    if len(snd) == 0:
        return _empty_report()
    obs = _obs_key(rcv, pooled)
    pk = (obs + 1) * (int(snd.max()) + 2) + snd
    dk = pk * (int(desc.max()) + 2) + desc
    _, first, cnt = np.unique(dk, return_index=True, return_counts=True)
    u_pk = pk[first]
    # best candidate per pair: max count, earliest first-appearance
    order = np.lexsort((first, -cnt, u_pk))
    lead = np.ones(order.size, dtype=bool)
    lead[1:] = u_pk[order][1:] != u_pk[order][:-1]
    sel = first[order[lead]]
    return _report(obs[sel], snd[sel], desc[sel], obs_stream=obs)


# ----------------------------------------------------------------------
# (3) Clustering: temporal + frequency feature matching.
# ----------------------------------------------------------------------

def clustering(log, observers, K: int,
               pooled: bool = False) -> AttackReport:
    """Match sender pseudonyms to descriptors on a joint score combining
    (i) frequency of each descriptor among the sender's transfers and
    (ii) earliness (inverse arrival rank) — then take the best match per
    sender (greedy assignment, senders ordered by confidence; a
    descriptor is used once per observer)."""
    slots, snd, rcv, desc = _observations(log, observers, K)
    if len(snd) == 0:
        return _empty_report()
    obs = _obs_key(rcv, pooled)
    n_obs = max(len(snd), 1)
    pk = (obs + 1) * (int(snd.max()) + 2) + snd
    dk = pk * (int(desc.max()) + 2) + desc
    _, first, cnt = np.unique(dk, return_index=True, return_counts=True)
    u_pk, u_obs, u_snd, u_desc = pk[first], obs[first], snd[first], \
        desc[first]
    score = cnt + (1.0 - first / n_obs)
    # Candidate lists per pair in confidence order (score desc, ties by
    # first appearance — the reference's insertion-order stable sort).
    o1 = np.lexsort((first, -score, u_pk))
    pk1, desc1, score1 = u_pk[o1], u_desc[o1], score[o1]
    starts = np.flatnonzero(np.r_[True, pk1[1:] != pk1[:-1]])
    ends = np.r_[starts[1:], pk1.size]
    top = score1[starts]
    pair_obs, pair_snd = u_obs[o1][starts], u_snd[o1][starts]
    # Pair confidence order per observer: top score desc, ties by pair
    # first appearance (reference inserts pairs in observation order).
    o2 = np.lexsort((first, u_pk))
    pk2 = u_pk[o2]
    s2 = np.flatnonzero(np.r_[True, pk2[1:] != pk2[:-1]])
    pair_first = first[o2][s2]        # min first index per pair

    g_obs_l, g_snd_l, g_l = [], [], []
    for ob in np.unique(pair_obs):
        pidx = np.flatnonzero(pair_obs == ob)
        order = pidx[np.lexsort((pair_first[pidx], -top[pidx]))]
        used: set[int] = set()
        for p in order:
            pick = -1
            for j in range(starts[p], ends[p]):
                d = int(desc1[j])
                if d not in used:
                    pick = d
                    break
            if pick < 0:
                pick = int(desc1[starts[p]])
            used.add(pick)
            g_obs_l.append(int(ob))
            g_snd_l.append(int(pair_snd[p]))
            g_l.append(pick)
    return _report(np.asarray(g_obs_l, np.int64),
                   np.asarray(g_snd_l, np.int64),
                   np.asarray(g_l, np.int64), obs_stream=obs)


# ----------------------------------------------------------------------
# Timing side-channel: continuous-time attribution (repro.net traces)
# ----------------------------------------------------------------------

def timing_attribution(log, observers, K: int | None = None,
                       pooled: bool = False) -> AttackReport:
    """Attribute senders by transfer *instants* — the network-layer
    timing side-channel the event engine's trace exposes.

    The slot world hands an adversary only stage indices; the
    continuous-time trace (``t_start``/``t_end``, stamped by
    ``RoundSimulator(time_engine="event")``) leaks strictly more: flows
    pipeline chunks serially, so within a directive cycle the wire
    order of a sender's transfers is visible in their start instants,
    and a sender's *release instant* (its earliest observed activity —
    the lag expiry §III-B randomizes) is measurable to sub-slot
    precision.  This attacker exploits both: per observed sender it
    (i) estimates the release instant as ``min t_start``, then
    (ii) attributes the sender to the descriptor of the transfer
    nearest that release — the continuous-time sharpening of Sequential
    Greedy (UnlinkableDFL's network-layer observer model).

    Without the warm-up stack the first bytes a sender emits are its
    own chunks and the attack attributes near-perfectly; the full stack
    (spray fills buffers *before* release, cover-set gating holds owner
    chunks back, randomized lags decorrelate release order from data
    order) drives it back toward the 1/m guessing floor — the
    acceptance pair in ``tests/test_timing_attacks.py``.

    ``AttackReport.asr_per_observer`` keys and ASR semantics match the
    other scorers; inferred release instants are a deliberate protocol
    observable here, not ground truth.
    """
    tr = _as_trace(log, K)
    observers = np.asarray(observers, np.int64).ravel()
    rcv_all = tr.receiver
    mx = int(rcv_all.max(initial=-1))
    lut = np.zeros(mx + 2, dtype=bool)
    lut[observers[(observers >= 0) & (observers <= mx)]] = True
    mask = (tr.phase == 1) & lut[rcv_all]
    if not mask.any():
        return _empty_report()
    t0 = tr.t_start[mask]
    order = np.argsort(t0, kind="stable")       # arrival instants
    snd = tr.sender[mask][order].astype(np.int64)
    rcv = rcv_all[mask][order].astype(np.int64)
    desc = (tr.chunk[mask] // tr.K)[order]
    obs = _obs_key(rcv, pooled)
    # Earliest-instant observation per (observer, sender): with the
    # rows in t_start order, the first occurrence of each pair is the
    # transfer nearest the sender's inferred release.
    pk = (obs + 1) * (int(snd.max()) + 2) + snd
    _, first = np.unique(pk, return_index=True)
    return _report(obs[first], snd[first], desc[first], obs_stream=obs)


def release_instants(log, observers, K: int | None = None) -> dict:
    """Inferred per-sender release instants (seconds): the side-channel
    artifact itself — ``min t_start`` over each sender's observed
    warm-up transfers.  Under randomized lags these spread over
    ``~lag_slots`` directive cycles; without lags they collapse onto
    the first cycle (tested as the channel's existence proof)."""
    tr = _as_trace(log, K)
    observers = np.asarray(observers, np.int64).ravel()
    mask = (tr.phase == 1) & np.isin(tr.receiver, observers)
    snd = tr.sender[mask].astype(np.int64)
    ts = tr.t_start[mask]
    if snd.size == 0:
        return {}
    us, inv = np.unique(snd, return_inverse=True)
    rel = np.full(us.size, np.inf)
    np.minimum.at(rel, inv, ts)
    return {int(s): float(r) for s, r in zip(us, rel)}


# ----------------------------------------------------------------------
# Cross-round adversary: persistent-neighbor linkage (§III-E sessions)
# ----------------------------------------------------------------------

def persistent_neighbor_linkage(
    trace, observers, K: int | None = None, *,
    min_rounds: int = 3,
    exposure: np.ndarray | None = None,
    pooled: bool = False,
    vote_anchor: float = 4.0,
) -> AttackReport:
    """Cross-round linkage over a session trace (global peer ids).

    The first adversary that exploits §III-E session persistence.  An
    observer links the per-round pseudonyms of a *physically persistent*
    neighbor (same network-layer identity across rounds — feed
    ``SwarmSession.pair_exposure()`` as ``exposure`` to restrict to
    pairs with at least ``min_rounds`` co-resident rounds, the pairs the
    session-layer follow-up flags as linkable).  Each observed round it
    casts a vote: the sequential-greedy-anchored best descriptor for the
    sender (first-seen descriptor; count share + earliness break
    degenerate ties — ``vote_anchor`` scales the first-seen term).
    Votes then aggregate per (observer, sender) pair by **majority**
    into one sender-level attribution, so accuracy *amplifies* with
    exposure whenever the per-round rule is better than a coin flip —
    which is exactly the regime the paper's full defense stack avoids:
    with per-round ASR pushed to the 1/m guessing floor the majority
    vote de-amplifies instead, i.e. the single-round defenses also
    protect the multi-round session (tested in
    ``tests/test_cross_round_attacks.py``).

    One decision per linked pair; per-observer ASR is the fraction of
    its linked senders whose majority vote is correct.  Grading uses
    each round's ground-truth descriptor -> owner mapping (descriptors
    are re-keyed per round torrent); like every ASR metric here, ground
    truth is touched only to *grade* guesses.
    """
    tr = _as_trace(trace, K)
    view = tr.warmup().observed_by(np.asarray(observers))
    if len(view) == 0:
        return _empty_report()
    order = np.lexsort((view.slot, view.round))
    rnd = view.round[order].astype(np.int64)
    snd = view.sender[order].astype(np.int64)
    rcv = view.receiver[order].astype(np.int64)
    desc = view.desc()[order]
    obs = _obs_key(rcv, pooled)
    if exposure is not None:
        # Pair persistence is a property of the physical (receiver,
        # sender) edge, so the filter applies in pooled mode too — the
        # coalition pools evidence, but only over linkable pairs.
        keep = np.asarray(exposure)[rcv, snd] >= min_rounds
        if not keep.any():
            return _empty_report()
        rnd, snd, obs, desc = rnd[keep], snd[keep], obs[keep], desc[keep]

    base_s = int(snd.max()) + 2
    base_r = int(rnd.max()) + 2
    base_d = int(desc.max()) + 2
    pk = (obs + 1) * base_s + snd                 # (observer, sender)
    pr = pk * base_r + rnd                        # (o, s, round)
    prd = pr * base_d + desc                      # (o, s, round, desc)

    _, first, cnt = np.unique(prd, return_index=True, return_counts=True)
    c_pr, c_pk = pr[first], pk[first]
    c_obs, c_snd, c_rnd, c_desc = obs[first], snd[first], rnd[first], \
        desc[first]
    # per-(o,s,r) observation totals
    upr, pr_inv = np.unique(pr, return_inverse=True)
    tot = np.bincount(pr_inv)[np.searchsorted(upr, c_pr)].astype(
        np.float64)
    # earliness: first-appearance rank within the (o,s,r) group
    o2 = np.lexsort((first, c_pr))
    grp_lead = np.r_[True, c_pr[o2][1:] != c_pr[o2][:-1]]
    grp_id = np.cumsum(grp_lead) - 1
    pos = np.arange(o2.size) - np.flatnonzero(grp_lead)[grp_id]
    rank = np.empty(o2.size, np.int64)
    rank[o2] = pos
    early = 1.0 - rank / np.maximum(tot, 1.0)
    frac = cnt / np.maximum(tot, 1.0)
    score = vote_anchor * (rank == 0) + frac + early

    # one vote per (o, s, round): the top-scored candidate
    ow = np.lexsort((first, -score, c_pr))
    win = ow[np.r_[True, c_pr[ow][1:] != c_pr[ow][:-1]]]

    grade = tr.desc_owner_lookup()
    vote_ok = grade(c_rnd[win], c_desc[win]) == c_snd[win]

    # majority aggregation per (observer, sender) pair
    w_pk, w_obs, w_snd = c_pk[win], c_obs[win], c_snd[win]
    w_rnd, w_desc = c_rnd[win], c_desc[win]
    o3 = np.lexsort((w_rnd, w_pk))
    p_lead = np.r_[True, w_pk[o3][1:] != w_pk[o3][:-1]]
    p_id = np.cumsum(p_lead) - 1
    n_votes = np.bincount(p_id)
    n_ok = np.bincount(p_id, weights=vote_ok[o3].astype(np.float64))
    linked = n_votes >= min_rounds
    if not linked.any():
        return _empty_report()
    starts = np.flatnonzero(p_lead)
    last = np.r_[starts[1:], o3.size] - 1          # latest-round vote
    g_obs = w_obs[o3][starts][linked]
    g_snd = w_snd[o3][starts][linked]
    g = w_desc[o3][last][linked]   # representative guess: latest round
    correct = (n_ok > 0.5 * n_votes)[linked]       # strict majority
    return _report(g_obs, g_snd, g, correct=correct, obs_stream=obs)


# ----------------------------------------------------------------------
# Reference per-observation implementations (kept for equivalence tests
# and the BENCH_attacks vectorization baseline — see module docstring)
# ----------------------------------------------------------------------

def _score_reference(guesses: dict) -> tuple[dict, float, float, int]:
    per_obs_total: dict[int, int] = {}
    per_obs_correct: dict[int, int] = {}
    for (o, s), g in guesses.items():
        per_obs_total[o] = per_obs_total.get(o, 0) + 1
        if g == s:
            per_obs_correct[o] = per_obs_correct.get(o, 0) + 1
    asr = {o: per_obs_correct.get(o, 0) / t
           for o, t in per_obs_total.items()}
    if not asr:
        return {}, 0.0, 0.0, 0
    vals = np.array(list(asr.values()))
    return asr, float(vals.max()), float(vals.mean()), \
        int(sum(per_obs_total.values()))


def _any_correct_reference(guesses: dict) -> float:
    if not guesses:
        return 0.0
    return float(any(g == s for (_, s), g in guesses.items()))


def sequential_greedy_reference(log, observers, K: int,
                                pooled: bool = False) -> AttackReport:
    slots, snd, rcv, desc = _observations(log, observers, K)
    guesses: dict = {}
    seen: set = set()
    for i in range(len(snd)):
        key = (int(rcv[i]) if not pooled else -1, int(snd[i]))
        if key in seen:
            continue
        seen.add(key)
        guesses[key] = int(desc[i])
    asr, mx, mean, nd = _score_reference(guesses)
    return AttackReport(asr, mx, mean, nd,
                        any_correct_rate=_any_correct_reference(guesses))


def amount_greedy_reference(log, observers, K: int,
                            pooled: bool = False) -> AttackReport:
    slots, snd, rcv, desc = _observations(log, observers, K)
    counts: dict = {}
    first_seen: dict = {}
    for i in range(len(snd)):
        key = (int(rcv[i]) if not pooled else -1, int(snd[i]))
        c = counts.setdefault(key, {})
        d = int(desc[i])
        c[d] = c.get(d, 0) + 1
        first_seen.setdefault((key, d), i)
    guesses = {}
    for key, c in counts.items():
        best = min(c.items(),
                   key=lambda kv: (-kv[1], first_seen[(key, kv[0])]))
        guesses[key] = best[0]
    asr, mx, mean, nd = _score_reference(guesses)
    return AttackReport(asr, mx, mean, nd,
                        any_correct_rate=_any_correct_reference(guesses))


def clustering_reference(log, observers, K: int,
                         pooled: bool = False) -> AttackReport:
    slots, snd, rcv, desc = _observations(log, observers, K)
    guesses: dict = {}
    feats: dict = {}
    for i in range(len(snd)):
        key = (int(rcv[i]) if not pooled else -1, int(snd[i]))
        f = feats.setdefault(key, {})
        d = int(desc[i])
        if d not in f:
            f[d] = [0, i]
        f[d][0] += 1
    n_obs = max(len(snd), 1)
    by_observer: dict = {}
    for (o, s), f in feats.items():
        scored = [(d, c + (1.0 - r / n_obs)) for d, (c, r) in f.items()]
        scored.sort(key=lambda kv: -kv[1])
        by_observer.setdefault(o, []).append((s, scored))
    for o, senders in by_observer.items():
        senders.sort(key=lambda it: -(it[1][0][1] if it[1] else 0.0))
        used: set = set()
        for s, scored in senders:
            pick = None
            for d, sc in scored:
                if d not in used:
                    pick = d
                    break
            if pick is None and scored:
                pick = scored[0][0]
            if pick is not None:
                used.add(pick)
                guesses[(o, s)] = pick
    asr, mx, mean, nd = _score_reference(guesses)
    return AttackReport(asr, mx, mean, nd,
                        any_correct_rate=_any_correct_reference(guesses))


ATTACKS = {
    "sequence": sequential_greedy,
    "count": amount_greedy,
    "cluster": clustering,
}

ATTACKS_REFERENCE = {
    "sequence": sequential_greedy_reference,
    "count": amount_greedy_reference,
    "cluster": clustering_reference,
}


def run_all_attacks(log, observers, K: int, pooled: bool = False):
    return {name: fn(log, observers, K, pooled)
            for name, fn in ATTACKS.items()}


def random_guess_baseline(avg_degree: float) -> float:
    """Neighborhood-level random guessing ~ 1/m (paper §V-D)."""
    return 1.0 / max(avg_degree, 1.0)
