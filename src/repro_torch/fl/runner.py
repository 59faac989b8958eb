"""FL experiment runner: CFL vs GossipDFL vs FLTorrent (paper §V-B).

FLTorrent rounds run the *real* dissemination pipeline on a persistent
:class:`~repro_torch.core.session.SwarmSession`: local updates are
chunked at 256 KiB granularity, a full spray/warm-up/BT round is
simulated over the session's overlay and broadband capacities, and
each client FedAvgs over its own reconstructable set.  With deadlines
set generously (the paper's learning setup) all updates reconstruct and
all clients agree — asserted at runtime.

Partial participation (§III-E): with ``churn_rate > 0`` clients leave at
round boundaries and rejoin ``rejoin_after`` rounds later.  A client
absent in round r holds *stale* params; at its rejoin boundary it
re-downloads the current model before training (never trains from the
stale base).  Clients that drop mid-round miss that round's aggregate
and catch up the same way.

Port of the JAX package's ``fl/runner.py``.  The host side (datasets,
partitions, the numpy rng that orders every client's batches, the
swarm session) is the reference's, stream for stream; the models,
local training, evaluation and aggregation run in torch on ``device``,
the GPU unless the caller names the CPU (:func:`repro_torch.resolve_device`;
no GPU and no device raises), and the session gets the same device.
The run computes in true f32 (:func:`~repro_torch.fl.models_small.true_f32`).
``params0`` (a numpy pytree, as ``jax.tree_util.tree_map(np.asarray,
...)`` gives) starts the run from given weights; without it the model
is initialised from ``torch.Generator().manual_seed(cfg.seed)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (ChurnAwareSpray, ChurnModel, SwarmConfig,
                              SwarmSession)
from repro_torch.core.aggregation import fedavg_pytree, per_client_aggregates
from repro_torch.core.chunking import chunk_count, flatten_update
from repro_torch.core.overlay import random_overlay
from repro_torch.data.partition import partition
from repro_torch.data.synthetic import make_synthetic
from repro_torch.interop import params_from_numpy

from . import baselines
from .client import LocalSpec, apply_aggregate, compute_update, make_local_train
from .models_small import MODELS, accuracy, true_f32


@dataclass
class FLConfig:
    dataset: str = "synth-mnist"
    model: str = "mlp"
    dist: str = "dir0.5"
    n_clients: int = 20
    rounds: int = 20
    local: LocalSpec = field(default_factory=LocalSpec)
    n_train: int = 8000
    n_test: int = 2000
    seed: int = 0
    min_degree: int = 5
    # FLTorrent dissemination knobs (defaults = paper defaults)
    swarm_overrides: dict = field(default_factory=dict)
    # Cross-round churn (§III-E): per-boundary Bernoulli leave
    # probability; leavers rejoin ``rejoin_after`` rounds later.  0 =
    # the historical full-participation loop, bit-identical.
    churn_rate: float = 0.0
    rejoin_after: int = 2
    # Rejoin-delay law: "fixed" (historical) or "geometric" (mean
    # rejoin_after, heterogeneous absences).
    rejoin_dist: str = "fixed"
    # Spray budgeting under churn: "full" re-sprays sigma fresh tunnels
    # per source every round (historical); "churn_aware" re-sprays only
    # coverage lost to churn (ChurnAwareSpray; needs churn_rate > 0).
    spray_budget: str = "full"


@dataclass
class FLResult:
    accuracy: list            # per-round test accuracy
    agreement: bool = True    # FLTorrent: all clients agreed every round
    reconstruct_frac: float = 1.0
    # Churn diagnostics (fltorrent with churn_rate > 0):
    participation: list | None = None  # per-round active fraction
    rejoin_rounds: list | None = None  # rounds where a client re-synced
    stale_seen: bool = False   # some catch-up client really held stale params
    caught_up: bool = True     # every active client trained from current params


@dataclass
class _Setup:
    """What both runners build before their first round."""
    weights: np.ndarray
    apply_fn: object
    params0: object
    local_train: object
    nprng: np.random.Generator
    xs: list                  # each client's samples on the device
    ys: list
    test_x: torch.Tensor      # the test set on the device
    test_y: torch.Tensor


def setup_run(cfg: FLConfig, device: torch.device, params0=None) -> _Setup:
    """Dataset, partition, model, trainer and numpy rng of a run, in the
    reference's order; every client's data and the test set staged on
    ``device`` once."""
    train, test = make_synthetic(cfg.dataset, cfg.n_train, cfg.n_test,
                                 seed=cfg.seed)
    parts = partition(train, cfg.n_clients, cfg.dist, seed=cfg.seed)
    weights = np.array([len(p) for p in parts], np.float64)

    init_fn, apply_fn = MODELS[cfg.model]
    if params0 is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params0 = init_fn(gen, train.x.shape[1:], train.num_classes,
                          device)
    else:
        params0 = params_from_numpy(params0, device)
    return _Setup(
        weights=weights,
        apply_fn=apply_fn, params0=params0,
        local_train=make_local_train(apply_fn, cfg.local),
        nprng=np.random.default_rng(cfg.seed),
        xs=[torch.from_numpy(train.x[p]).to(device) for p in parts],
        ys=[torch.from_numpy(train.y[p]).to(device) for p in parts],
        test_x=torch.from_numpy(test.x).to(device),
        test_y=torch.from_numpy(test.y).to(device))


def make_session(cfg: FLConfig, k_chunks: int, device, **session_kw):
    """The persistent swarm both runners disseminate on."""
    scfg = SwarmConfig(
        n=cfg.n_clients, chunks_per_update=k_chunks,
        min_degree=cfg.min_degree, seed=cfg.seed, **cfg.swarm_overrides)
    if cfg.spray_budget not in ("full", "churn_aware"):
        raise ValueError(f"unknown spray_budget {cfg.spray_budget!r}")
    return SwarmSession(
        scfg,
        churn=ChurnModel(leave_prob=cfg.churn_rate, join_rate=0.0,
                         rejoin_after=cfg.rejoin_after,
                         rejoin_dist=cfg.rejoin_dist),
        spray_policy=(ChurnAwareSpray()
                      if cfg.spray_budget == "churn_aware" else None),
        device=device, **session_kw)


def run_experiment(method: str, cfg: FLConfig, *, device=None,
                   params0=None) -> FLResult:
    """method in {"cfl", "gossip", "fltorrent"}; on ``device`` (the GPU
    unless the caller names the CPU)."""
    dev = resolve_device(device)
    with true_f32():
        return _run(method, cfg, setup_run(cfg, dev, params0), dev)


def _run(method: str, cfg: FLConfig, st: _Setup, dev) -> FLResult:
    weights, apply_fn = st.weights, st.apply_fn
    params0, local_train, nprng = st.params0, st.local_train, st.nprng

    accs: list[float] = []
    agreement = True
    recon_fracs: list[float] = []

    if method == "cfl":
        params = params0
        for _ in range(cfg.rounds):
            updates = []
            for v in range(cfg.n_clients):
                out = local_train(params, st.xs[v], st.ys[v], nprng)
                updates.append(compute_update(params, out))
            agg = baselines.fedavg_server(updates, weights)
            params = apply_aggregate(params, agg)
            accs.append(accuracy(apply_fn, params, st.test_x, st.test_y))
        return FLResult(accs)

    if method == "gossip":
        client_params = [params0 for _ in range(cfg.n_clients)]
        for r in range(cfg.rounds):
            outs = []
            for v in range(cfg.n_clients):
                outs.append(local_train(client_params[v], st.xs[v], st.ys[v],
                                        nprng))
            adj = random_overlay(cfg.n_clients, cfg.min_degree,
                                 rng=np.random.default_rng((cfg.seed, r)))
            w = baselines.metropolis_weights(adj)
            client_params = baselines.gossip_mix(outs, w)
            # Evaluate what clients actually hold: each its own
            # partially-mixed model (see baselines.gossip_eval for why
            # the mean-model metric is a phantom exact FedAvg).
            accs.append(baselines.gossip_eval(
                apply_fn, client_params, st.test_x, st.test_y))
        return FLResult(accs)

    if method == "fltorrent":
        params = params0   # current global model (active clients agree)
        flat0, _ = flatten_update(params0)
        upd_bytes = flat0.numel() * 4
        k_chunks = max(2, chunk_count(upd_bytes, 256 * 1024))
        # Persistent swarm: the session carries population, overlay and
        # capacities across rounds; round_seed keeps the historical
        # seed*1000+r per-round streams, so churn_rate=0 reproduces the
        # old per-round simulate_round loop bit-identically.
        session = make_session(cfg, k_chunks, dev)
        # Per-client held model: a reference to some past global params.
        # Clients absent in a round keep a stale reference and re-sync
        # at their rejoin boundary.
        client_params = [params0] * cfg.n_clients
        in_sync = np.ones(cfg.n_clients, dtype=bool)
        participation: list[float] = []
        rejoin_rounds: list[int] = []
        stale_seen = False
        caught_up = True
        for r in range(cfg.rounds):
            ids = session.begin_round()
            # Rejoin-at-round-boundary (§III-E): a returning client
            # re-downloads the CURRENT model before training.
            catchup = ids[~in_sync[ids]]
            if catchup.size:
                cur, _ = flatten_update(params)
            for v in catchup:
                held, _ = flatten_update(client_params[v])
                stale_seen |= not torch.equal(held, cur)
                client_params[v] = params
                in_sync[v] = True
                rejoin_rounds.append(r)
            participation.append(ids.size / cfg.n_clients)
            updates = []
            for v in ids:
                caught_up &= client_params[v] is params
                out = local_train(params, st.xs[v], st.ys[v], nprng)
                updates.append(compute_update(params, out))
            # Real dissemination round at the true chunk count over the
            # active sub-swarm (local index i <-> global client ids[i]).
            rec = session.run_round()
            res = rec.result
            recon = res.reconstructable           # (n_act, n_act) bool
            recon_fracs.append(float(recon.mean()))
            w_act = weights[ids]
            surv = np.flatnonzero(res.active)
            ref = int(surv[0]) if surv.size else 0
            # Every client aggregates over its own A_v^r.  In the common
            # full-dissemination case every row of ``recon`` is the same
            # set, so all n aggregates are *definitionally* identical:
            # compute the FedAvg once instead of n pytree reductions.
            if not bool((recon == recon[ref]).all()):
                agreement &= _rows_agree(updates, w_act, recon, surv, ref)
            agg = fedavg_pytree(updates, w_act, recon[ref])
            params = apply_aggregate(params, agg)
            # Clients active at the deadline applied this aggregate;
            # everyone else (absent or dropped mid-round) is now stale.
            in_sync[:] = False
            got = ids[res.active]
            for v in got:
                client_params[v] = params
            in_sync[got] = True
            accs.append(accuracy(apply_fn, params, st.test_x, st.test_y))
        return FLResult(accs, agreement=agreement,
                        reconstruct_frac=float(np.mean(recon_fracs)),
                        participation=participation,
                        rejoin_rounds=rejoin_rounds,
                        stale_seen=stale_seen, caught_up=caught_up)

    raise ValueError(method)


def _rows_agree(updates, w_act, recon, surv, ref) -> bool:
    """Rows of ``recon`` differ: check the survivors' aggregates agree on
    the flat vectors with ONE (n, n) x (n, D) product, not n pytree
    FedAvgs."""
    flats = torch.stack([flatten_update(u)[0] for u in updates])
    per_cl = per_client_aggregates(flats, w_act, recon)
    return bool(torch.allclose(per_cl[surv], per_cl[ref][None],
                               atol=1e-6))
