"""Your own scheduling policy AND your own adversary on the PyTorch
port, in ~20 lines each: the two halves of the §III-C / §IV-C contract.

The torch counterpart of ``examples/custom_policy.py``: the same
``EagerMirror`` policy, registered in the port's registry
(``repro_torch.core.register_policy``), over the visibility-scoped
:class:`SlotView`, and the same ``latecomer_adversary`` over the typed
:class:`TransferTrace`, in a single round (``simulate_round``) and in a
churny ``SwarmSession``.  Its schedules are the host numpy copies of
the JAX package's, so it prints what ``examples/custom_policy.py``
prints, byte for byte.

    PYTHONPATH=src python examples/custom_policy_torch.py   # GPU
    PYTHONPATH=src python examples/custom_policy_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (ChurnModel, SchedulerPolicy, SwarmConfig,
                              SwarmSession, register_policy, simulate_round)
from repro_torch.core.attacks import sequential_greedy

N_CLIENTS = 24
CHUNKS = 16
MIN_DEGREE = 5
S_MAX = 5000
SEED = 0
SESSION_ROUNDS = 4
OBSERVERS = 6


# ----------------------------------------------------------------------
# 1. A policy in ~20 lines: receivers request everything the
#    neighborhood union advertises from random neighbors (a greedier
#    cousin of the §III-C.6 distributed mode — same visibility tier).
# ----------------------------------------------------------------------

@register_policy
class EagerMirror(SchedulerPolicy):
    """Request every advertised missing chunk from a random neighbor."""

    name = "eager_mirror"
    visibility = "neighborhood"        # may NOT read the supply matrix

    def schedule(self, view):
        cand, union = view.availability_union()
        snd, rcv, chk = [], [], []
        for v in np.flatnonzero(view.receivers_open()):
            ids = np.flatnonzero(union[v])[:int(view.down[v])]
            if ids.size == 0:
                continue
            tgt = view.rng.choice(np.flatnonzero(view.adj[v]),
                                  size=ids.size)
            ok = view.resolve_requests(tgt, cand[ids])  # may miss!
            snd.append(tgt[ok])
            rcv.append(np.full(int(ok.sum()), v, np.int64))
            chk.append(cand[ids[ok]])
        if not snd:
            return view.empty()
        snd, rcv, chk = map(np.concatenate, (snd, rcv, chk))
        # uplink budgets are the policy's duty: keep each sender's
        # first up[u] grants (grouped rank over the sorted senders)
        o = np.argsort(snd, kind="stable")
        rank = np.arange(o.size) - np.searchsorted(snd[o], snd[o])
        keep = np.zeros(o.size, bool)
        keep[o] = rank < view.up[snd[o]]
        return snd[keep], rcv[keep], chk[keep]


# ----------------------------------------------------------------------
# 2. An adversary in ~20 lines: guesses each sender's LAST descriptor
#    (a deliberately bad strategy — late transfers are well mixed).
# ----------------------------------------------------------------------

def latecomer_adversary(trace, observers):
    """ASR of attributing each sender to its last-seen descriptor."""
    view = trace.warmup().observed_by(observers)
    order = np.argsort(view.slot, kind="stable")
    snd, desc = view.sender[order], view.desc()[order]
    guesses = {}
    for s, d in zip(snd.tolist(), desc.tolist()):
        guesses[s] = d                       # later rows overwrite
    if not guesses:
        return 0.0
    return float(np.mean([g == s for s, g in guesses.items()]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a GPU")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = SwarmConfig(n=N_CLIENTS, chunks_per_update=CHUNKS,
                      min_degree=MIN_DEGREE, s_max=S_MAX, seed=SEED,
                      scheduler="eager_mirror")
    res = simulate_round(cfg, device=device)
    m = res.metrics
    print(f"eager_mirror (by name):     t_warm={m.t_warm} "
          f"util={m.warmup_utilization:.2f}")

    # the same policy as an INSTANCE, unchanged in a churny session
    ses = SwarmSession(cfg.replace(scheduler=EagerMirror()),
                       churn=ChurnModel(leave_prob=0.2, rejoin_after=1),
                       device=device)
    ses.run(SESSION_ROUNDS)
    print(f"eager_mirror (instance, {SESSION_ROUNDS}-round churn session): "
          f"participation={ses.participation().round(2).tolist()}")

    obs = np.arange(OBSERVERS)
    asr_late = latecomer_adversary(res.log, obs)
    asr_seq = sequential_greedy(res.log, obs, cfg.chunks_per_update)
    print(f"latecomer ASR={asr_late:.3f} vs sequential greedy "
          f"mean ASR={asr_seq.mean_asr:.3f} (first beats last: early "
          f"transfers carry the owner signal the defenses scrub)")


if __name__ == "__main__":
    main()
