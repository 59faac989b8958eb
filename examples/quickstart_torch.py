"""Quickstart on the PyTorch port: one privacy-hardened FLTorrent
dissemination round.

The torch counterpart of ``examples/quickstart.py``: a 30-client swarm
with the paper's defaults (spray R=0.2, T_lag=3, cover-set gating,
GreedyFastestFirst) through ``repro_torch.core``, the three
observation-only attribution attacks, and the Eq. (1) bound on every
warm-up transfer.  The round's schedule is the host numpy copy of the
JAX package's, so it prints what ``examples/quickstart.py`` prints, byte
for byte.

    PYTHONPATH=src python examples/quickstart_torch.py   # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import SwarmConfig, simulate_round
from repro_torch.core.attacks import random_guess_baseline, run_all_attacks
from repro_torch.core.privacy import check_eq1, per_transfer_cap

N_CLIENTS = 30
CHUNKS = 64
S_MAX = 20_000
SEED = 0
OBSERVERS = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a GPU")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = SwarmConfig(n=N_CLIENTS, chunks_per_update=CHUNKS, s_max=S_MAX,
                      seed=SEED)
    print(f"swarm: n={cfg.n}, K={cfg.chunks_per_update} chunks/update, "
          f"k_gate={cfg.k_gate}, k_term={cfg.k_term}, "
          f"spray sigma={cfg.spray_copies}")

    res = simulate_round(cfg, device=device)
    m = res.metrics
    print(f"\nround: warm-up {m.t_warm}s + BT {m.t_round - m.t_warm}s "
          f"= {m.t_round}s  (warm-up share {m.warmup_share:.1%}, "
          f"utilization {m.warmup_utilization:.1%})")
    print(f"all updates reconstructable: {bool(res.reconstructable.all())}")

    cap = per_transfer_cap(cfg.owner_throttle, cfg.k_gate)
    print(f"\nEq.(1) cap kappa/k = {cap:.3f}; "
          f"holds on every warm-up transfer: {check_eq1(res.log, cfg.owner_throttle, cfg.k_gate)}")

    observers = np.arange(OBSERVERS)
    reports = run_all_attacks(res.log, observers, cfg.chunks_per_update)
    guess = random_guess_baseline(cfg.min_degree)
    print(f"\nattribution attacks ({OBSERVERS} observers, 1/m guess = "
          f"{guess:.2f}):")
    for name, rep in reports.items():
        print(f"  {name:10s} max ASR = {rep.max_asr:.3f}  "
              f"mean = {rep.mean_asr:.3f}")


if __name__ == "__main__":
    main()
