"""LLM-scale dissemination stress test (paper §V-E) on the PyTorch
port: swarm a 7B-class bf16 update over datacenter links with and
without unlinkability hardening, and show the int8 chunk-compression
wire format of the torrent collective.

The torch counterpart of ``examples/llm_dissemination.py``.  The swarm
rounds are the host numpy copies of the JAX package's, so their lines
are the JAX example's, byte for byte.  The compression runs
``repro_torch.kernels.ops.quantize`` and ``ops.dequantize`` with
``impl="cuda"``: the ``chunk_quantize`` and ``chunk_dequantize`` kernels
on the card, their plain versions for CPU tensors.

    PYTHONPATH=src python examples/llm_dissemination_torch.py   # GPU
    PYTHONPATH=src python examples/llm_dissemination_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import SwarmConfig, simulate_round
from repro_torch.core.capacities import DATACENTER
from repro_torch.kernels import ops

UPDATE_BYTES = 7e9 * 2          # a 7B-parameter bf16 update
CHUNK_BYTES = 4 * 2**20         # 4 MiB pieces
N_PEERS = 24
MIN_DEGREE = 10
S_MAX = 10**7
SEED = 0
WIRE_SHAPE = (16, 65536)        # the compressed rows
WIRE_STD = 0.02


def main(argv=None):
    """Returns the compression's byte ratio and max relative error."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    device = resolve_device(ap.parse_args(argv).device)

    # --- swarm-level: 7B bf16 update, 4 MiB pieces, 24 peers ---
    K = int(-(-UPDATE_BYTES // CHUNK_BYTES))
    common = dict(n=N_PEERS, chunks_per_update=K, chunk_bytes=CHUNK_BYTES,
                  s_max=S_MAX, seed=SEED, min_degree=MIN_DEGREE)
    base = simulate_round(
        SwarmConfig(**common, enable_gating=False, enable_preround=False,
                    enable_timelag=False, enable_nonowner_first=False,
                    warmup_threshold_pct=0.0),
        link_model=DATACENTER, bt_mode="fluid", device=device).metrics
    full = simulate_round(SwarmConfig(**common), link_model=DATACENTER,
                          bt_mode="fluid", device=device).metrics
    ovh = (full.t_round - base.t_round) / base.t_round
    print(f"7B update, {K} pieces, {N_PEERS} peers @ 7-10 Gbps:")
    print(f"  BitTorrent-only round: {base.t_round}s")
    print(f"  FLTorrent (hardened):  {full.t_round}s  ({ovh:+.1%})")

    # --- chunk-level: int8 wire compression (the dissemination
    #     collective quantizes ONCE at source, hops carry int8) ---
    # jax.random's stream cannot be reproduced in torch, so x comes from
    # a torch.Generator: the same numbers on the CPU and on the card.
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(WIRE_SHAPE, generator=gen) * WIRE_STD).to(device)
    q, scales = ops.quantize(x, impl="cuda")       # chunk_quantize
    deq = ops.dequantize(q, scales, impl="cuda")   # chunk_dequantize
    rel = float((deq - x).abs().max() / x.abs().max())
    nbytes = [t.numel() * t.element_size() for t in (x, q, scales)]
    ratio = nbytes[0] / (nbytes[1] + nbytes[2])
    print(f"\nint8 chunk compression: {ratio:.2f}x fewer wire bytes, "
          f"max rel err {rel:.4f}")
    return ratio, rel


if __name__ == "__main__":
    main()
