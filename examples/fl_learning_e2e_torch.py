"""End-to-end FL driver on the PyTorch port (the paper's kind of
experiment, §V-B): train CFL vs GossipDFL vs FLTorrent on a synthetic
non-IID dataset and show that FLTorrent's trajectory is CFL's (exact
FedAvg over a real chunked/swarmed dissemination round) while Gossip
attenuates; then cross-round churn (§III-E) on the persistent
``SwarmSession`` the fltorrent path runs on.

The torch counterpart of ``examples/fl_learning_e2e.py``, through
``repro_torch.fl.runner.run_experiment(method, cfg, device=)``.  Its
models start from the port's own seeded init, so its accuracies are
not the JAX example's; the table and lines are printed the same way.

    PYTHONPATH=src python examples/fl_learning_e2e_torch.py   # GPU
    PYTHONPATH=src python examples/fl_learning_e2e_torch.py --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.fl.client import LocalSpec
from repro_torch.fl.runner import FLConfig, run_experiment

METHODS = ("cfl", "gossip", "fltorrent")
N_CLIENTS = 10
ROUNDS = 8
N_TRAIN = 3000
N_TEST = 800
CHURN_RATE = 0.25


def _config(**kw) -> FLConfig:
    return FLConfig(dataset="synth-cifar", model="mlp", dist="dir0.1",
                    n_clients=N_CLIENTS, rounds=ROUNDS,
                    local=LocalSpec(epochs=1, batch_size=32, lr=0.03),
                    n_train=N_TRAIN, n_test=N_TEST, seed=0, min_degree=5,
                    **kw)


def main(argv=None):
    """Returns the three methods' results and the churn run's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a GPU")
    device = str(resolve_device(ap.parse_args(argv).device))

    cfg = _config()
    print(f"training 3 methods, {cfg.rounds} rounds, Dirichlet(0.1) "
          f"non-IID ...")
    results = {m: run_experiment(m, cfg, device=device) for m in METHODS}
    print(f"\n{'round':>6}" + "".join(f"{m:>12}" for m in results))
    for r in range(cfg.rounds):
        print(f"{r:6d}" + "".join(f"{res.accuracy[r]:12.3f}"
                                  for res in results.values()))
    flt = results["fltorrent"]
    print(f"\nFLTorrent: clients agreed on every aggregate: "
          f"{flt.agreement}; reconstruction rate {flt.reconstruct_frac:.0%}")

    # -- cross-round churn (§III-E): same pipeline, persistent swarm --
    ch = run_experiment("fltorrent",
                        _config(churn_rate=CHURN_RATE, rejoin_after=1),
                        device=device)
    print(f"\nFLTorrent with churn_rate={CHURN_RATE} (leave/rejoin at "
          f"round boundaries):")
    print(f"  per-round participation: "
          f"{[round(p, 2) for p in ch.participation]}")
    print(f"  rejoin catch-ups at rounds {sorted(set(ch.rejoin_rounds))} "
          f"(stale params re-synced: {ch.stale_seen and ch.caught_up})")
    print(f"  final accuracy {ch.accuracy[-1]:.3f} vs no-churn "
          f"{flt.accuracy[-1]:.3f}; agreement {ch.agreement}")
    return results, ch


if __name__ == "__main__":
    main()
