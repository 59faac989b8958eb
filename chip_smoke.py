#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port (``src/repro_torch``)
and imports nothing of the JAX package:

1. prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/torch_kernels/`` and prints how long that took; beside that
   build it compiles ``csrc/attention.cu``, ``csrc/mlstm.cu``,
   ``csrc/rglru.cu`` and ``csrc/slots.cu`` each alone with ``-Xptxas
   -v`` and prints their registers, shared memory and spills, then the
   number of ``HGMMA`` instructions in each
   kernel's SASS (``cuobjdump``), which must be nonzero for attention's
   wgmma prefill kernel and mlstm's tensor-core kernels;
3. holds every kernel against its plain PyTorch version on the card at
   small and odd shapes and edge cases: fedavg, quantize and dequantize
   (zero mass, a masked NaN row, bf16 updates, ties, an all-zero row,
   non-finite rows); flash_attention on the test suite's attention
   cases plus head dims 256 and 80, GQA group 10, ragged tiles, a
   rolling cache with negative key positions and rows with no live key
   (which must be exactly 0), and cases for each route (bf16 wgmma
   prefill at head dims 64, 128 and 256; split-KV decode over many
   splits, group 10 and 16, Tq 3 and 4, an empty split), in f32 (atol
   = rtol = 3e-5) and bf16 (1e-2), and the gradient through
   ``attention(impl="cuda")``;
   rglru_scan on both routes, with and without h0, T = 1, ragged last
   chunks and D, rows of a = 1 exactly, f32 (2e-5) and bf16 (1e-2;
   h_T 2e-5);
   mlstm_chunkwise on tests/test_mlstm_kernel.py's shapes plus head dims
   512 and 80, gates scaled x10, T = 1, the layer's (B, T, H, dh) views,
   and cases of each route (the tensor-core route at dh 512, 256, 96, 64
   and 32, chunk 64 and 128, one chunk and 2048 steps), f32 (5e-4 on h,
   C, n and m) and bf16 (3e-2), all finite; the slot engine's
   slot_planes (chunk-major inventories with garbage in the bits of
   peers at or above n; 1, 2, 4 and 8 words a CTA), overlap_rank and
   extract_ranked on ``SLOT_CASES`` in every plane layout, exactly,
   and slot_rounds against its plain loop
   on the card on seeded random slots of those sizes (every mode, plane
   layout, a non-symmetric overlay, tied bases), exactly;
4. the main paths, each with the launch counters set to 0 just before
   it and read just after:
   a. training: the train driver for 4 uncompressed steps of qwen3-1.7b
      at full width and depth (P = 2, batch 8, seq 512), then 2
      compressed steps of ``ElasticFLStep``; then the same for
      granite-moe-1b-a400m (moe layers, an f32 router among bf16
      leaves), 3 driver steps and 1 compressed step; all losses finite,
      each aggregation kernel launched on each path, the parameter
      count and the leaves' dtypes unchanged; prints step seconds and
      peak memory;
   b. serving: ``launch/serve.py`` for gemma2-2b, recurrentgemma-2b,
      gemma3-4b, xlstm-350m and olmoe-1b-7b at full width and depth,
      batch 8, an 8192-token prompt (twice gemma2's window, four times
      recurrentgemma's, eight times gemma3's; 8 token blocks of
      olmoe's MoE FFN) and 32 generated tokens; tokens in range,
      flash_attention (and rglru_scan for recurrentgemma) launched,
      mlstm_chunkwise launched once per mLSTM layer (21); prints
      prefill seconds, decode tokens/s, peak memory and the bytes of
      weights and caches; for xlstm and olmoe, a second prefill after
      the served run, each mLSTM and sLSTM layer (xlstm) or each
      attention mix and MoE FFN (olmoe) in it timed with a synchronise
      before and after, splits the prefill's seconds (the served
      prefill itself runs unsynchronised);
5. holds the served prefill against the same prefill through the plain
   versions at full width: last-position logits within a relative L2
   of 2e-2, the first greedy token equal in at least 7 of 8 rows; and
   prints, beside it, how far a one-ulp bump of the first layer's
   normed input moves the plain path's logits (the bf16 noise floor);
   an arch whose floor lies above 2e-2 at its depth is held to a fixed
   limit of its own (``SERVE_REL_L2_DEEP``) that a faulty control must
   exceed; gemma3-4b and olmoe-1b-7b also through ``layer_witness``:
   each layer, fed the plain path's hidden state, gives an attention
   output within 1e-2 of the plain layer's, where two faulty controls
   (``WITNESS_CONTROLS``: half the window or RoPE's base halved, and no
   causal mask) must not; for olmoe it logs, per layer, how many
   tokens' top-8 expert sets differ between the two outputs;
6. each kernel at its main path's full shapes, timed with CUDA events
   (median of 10 runs after a warm-up, each run enough back-to-back
   calls to take about 2 ms) beside its bound, its plain
   version and, where there is one, the one PyTorch call that computes
   the same function (``wn @ updates`` for fedavg, at qwen3's and
   granite's D, and in the swarm (8c); ``torch.mul`` for
   dequantize, SDPA for attention without softcap, with a boolean mask
   of the live keys where the offsets or the window need one; none for
   quantize, softcapped attention, rglru or mlstm); each attention,
   rglru and mlstm row names its route, the rglru rows and the mlstm
   row's log give the device time of their kernels (``torch.profiler``).
   The bound is the larger of the bytes over the HBM rate and
   the operations over the card's rate
   for their type (f32 for the aggregation kernels and rglru, the bf16
   tensor cores for attention, the TF32 tensor cores for mlstm, whose
   line also gives its f32 bound and the 3xTF32 split's ceiling);
7. checks the steps against a reference: one olmoe moe layer's FFN at
   full width (64 experts of 1024, top 8) on 2048 f32 tokens through
   ``_moe_ffn`` on the card and on the CPU (rtol 1e-4, atol 1e-5); on
   a small input, the reduced qwen3 and granite-moe configs trained 2
   compressed steps with P = 3, and reduced gemma2-2b,
   recurrentgemma-2b, gemma3-4b, olmoe-1b-7b and granite-moe-1b-a400m
   (40-token prompts) and xlstm-350m (200 tokens, so the last mLSTM
   chunk pads) prefill plus 4 decode steps, on the card agree with the
   same work on the CPU's plain versions;
8. the swarm (the FLTorrent round of ``repro_torch.core``):
   a. on the host, the port's ``simulate_round`` replays every loop and
      batched schedule of tests/golden_schedules.json to the same
      digest (5 policies x 2 engines x 2 seeds, n 16, K 24) and its
      attacks give the file's exact ASR numbers (all defences on and
      off, seeds 0 and 1, n 24);
   b. on the host, one round at the paper's scale (n 500, K 206,
      greedy fastest first on the batched engine, every warm-up
      defence, then fluid BitTorrent): every update reconstructable,
      no failed-open warm-up, Eq. 1 on every warm-up transfer, the log
      legal (the rules of the equivalence tests' replay, copied here);
      prints t_warm, t_round, the warm-up share and utilisation, the
      three attacks' ASR from 6 observers against 1/m and the host
      seconds by phase;
   c. on the card, the data plane at full width: 16 peers' updates of
      xlstm-350m (peer 0 its seeded parameter tree, 565,215,232
      values; peers 1 to 15 seeded f32 noise) packed into one (16, 540,
      1,048,576) f32 buffer of 4 MiB pieces (36.24 GB); peer 0's
      torrent descriptor hashed on the host, accepting 8 of its pieces
      and rejecting one with a flipped bit; its pieces reassembled into
      its tree exactly, leaf by leaf and dtype by dtype; then, the
      launch counters set to 0, two rounds of the 16-peer swarm
      (``DATACENTER`` links, exact BitTorrent, seed 0, s_max 30 and the
      default deadline that never binds: 46 and 256 reconstructable
      (v, u) pairs) and every peer's FedAvg over its own A_v through
      ``fedavg_flat(use_kernel=True)``, the ``fedavg_reduce`` kernel (32
      launches), each held against the plain version on column slices
      of 2.1 GB (atol = rtol = 2e-5), and at the open deadline all 16
      aggregates equal bit for bit (``agreement_check``, atol 0); prints
      the rounds' host seconds, the hashing seconds, the launches and
      peak memory, and times ``fedavg_reduce`` over all 16 rows
      (566,231,040 columns) beside its bound, the plain version by
      slices and ``wn @ updates``;
9. the GPU slot engine (``repro_torch.core.jit_engine``,
   ``scheduler_impl="jit"``, ``run_slot_engine_paths``), with the
   launch counters and the engine's counts set to 0 before each round:
   a. benchmarks/bench_scheduler.py's sweep point n 500 (K 206, GFF,
      k_term 1030, cand_cap 8192, warm-up only) on the card: legal,
      Eq. 1, not failed open, ``slot_planes`` and ``slot_rounds``
      launched once a slot, ``overlap_rank`` and ``extract_ranked``
      never, two host reads a slot; t_warm and warm-up utilisation
      within the equivalence tests' bands of the batched engine on the
      host; the same round with ``device="cpu"`` byte-identical; slot
      20's ``_slot_rounds`` on the card equal to the plain loop on the
      card (``impl="torch"``) and on the CPU; its kernel inputs held
      exactly against the plain versions and timed (``slot_planes`` by
      a CUDA graph over copies of its inventory that leave L2 cold,
      beside the row-major inventory's bounds and its time there, with
      its ptxas registers, spills and shared memory; ``slot_rounds``
      a slot, with its rounds, CTAs and ptxas registers and spills;
      ``overlap_rank`` and ``extract_ranked`` on the plain loop's first
      round, off the path), and the slot traced by ``torch.profiler``
      (launches, cooperative ones included, copies, busy); the warm-up
      seconds, the ``PHASE_S`` split, rounds and host reads a slot, and
      the batched engine's seconds logged;
   b. the headline round (n 100, K 64, s_max 100,000, exact BitTorrent
      through the engine): byte-identical on the card and the CPU,
      legal, t_round within the batched engine's band, the launches and
      reads of (a);
   c. the sweep's top, n 5000, on the card: legal, Eq. 1, not failed
      open, the launches and reads of (a), its timings and peak device
      memory, and the kernels held and timed at its shapes;
   d. the jit session twin (n 20, K 16, churn 0.1, two rounds) on the
      slot and event engines: the card's traces equal the CPU's byte
      for byte;
10. the event engine (``repro_torch.net``, ``run_event_paths``; no
   kernel build), whose max-min fair-share solves run in torch float64
   on the card:
   a. the card's ``maxmin_rates`` and ``transport`` against their numpy
      plain versions on tests/test_net.py's small cases, seeded
      heterogeneous cases (zero-capacity links, a tail truncated at 2
      passes, ``quantum_frac`` 0) and the first 20 transport calls of
      the n 100 round below: chunk_flow and n_solves exact, rates and
      instants within 1e-9, the largest gap logged;
   b. slot/event parity (n 60, K 64, no tracker RTT): the event
      engine's chunk and slot columns equal the slot engine's;
   c. the warm-up share at the paper's scale (``EVENT_WARM_NS``; K 206,
      RESIDENTIAL links and ``RESIDENTIAL_NET``, fluid BitTorrent):
      t_warm_s, t_round_s and the share equal the JAX package's
      committed numbers at their rounding, Eq. 1 and the legality
      replay on the event trace;
   d. Fig. 8 at n 50 (``FIG8_MODELS``; 4 MiB pieces, DATACENTER links,
      ``DATACENTER_NET``): BitTorrent only and FLTorrent, the overhead,
      share, control and spray seconds equal the committed ones; the
      first model's FLTorrent round's transport calls replayed through
      the card and through the numpy plain version on the host, timed;
   e. the time-domain efficiency at n 100 (``warmup_time_bounds``);
   f. benchmarks/bench_obs.py's recorded two-round n 100 session: its
      JSONL and Perfetto trace written, validated and counted (238
      rows, 21,971 flows, 22,113 events), the report within 1e-6 of
      each round's metrics; benchmarks/bench_session.py's churn row;
   each round's host seconds, the seconds inside the fair-share solves
   (a synchronised timer) and the solves and microseconds a solve;
11. the FL stack (``repro_torch.fl``, ``run_fl_paths``; no kernel
   build: the FL path's FedAvg and gossip are einsums, as in the JAX
   package), on the card by default, TF32 left at torch's default (the
   runners turn it off themselves; each aggregate is checked to be made
   on the card with TF32 off):
   a. Table II's fast rows (benchmarks/table2_learning.py, fast:
      synth-cifar, n 10, n_train 4000, n_test 1000, batch 32, lr 0.03,
      min degree 5) at dir0.1 and iid: the mlp for 6 rounds with CFL,
      GossipDFL and FLTorrent, the cnn for 3 with CFL and FLTorrent;
      FLTorrent's accuracy within 1e-3 of CFL's every round, with
      agreement and every update reconstructed; then FLTorrent on the
      CPU from the same weights, twice (torch's threads, one thread), and
      the card held to it: every local SGD step forced from the CPU
      run's state, the card's median step no more than 4 times as far
      from the f64 step as the CPU's (TF32 on, the faulty control, must
      be further), and each round's accuracy within 0.01 up to the first
      round in which the one-thread run parts from the CPU by more (the
      mlp at dir0.1 is chaotic in the summation order from round 3 on);
      round 1's aggregate gap logged beside the one-thread run's; each
      row and the host seconds logged;
   b. examples/fl_learning_e2e.py's churn run (n 10, 8 rounds, churn
      0.25, rejoin after 1): participation and rejoin rounds equal to
      the JAX package's, stale params seen and caught up, agreement;
   c. table2_learning.async_frontier(fast=True) on the event engine
      with its fair-share solves on the card (synth-mnist, n 16, 8
      rounds, straggler links, ``RESIDENTIAL_NET``): synchronous and
      round_slots 6 and 8 (buffer 4, staleness 3, the tail carried); K 4
      and wall_s, the staleness histogram and drops equal the JAX
      package's (242.6 s; 197.7 s, {1: 94}; 213.5 s, {1: 52}; 0
      dropped); host and fair-share seconds;
12. the pod axis (``repro_torch.dist.torrent``'s ring, the
   expert-parallel MoE; NCCL cannot run two ranks on one card):
   a. ``ring_local``: the ring's rank body with P virtual ranks on the
      card (``LocalTransport``, a send a device copy) over seeded f32
      rows at qwen3-1.7b's D (1,720,574,976) with P = 2 and
      xlstm-350m's (565,215,232) with P = 4, n_blocks 4 and 16,
      compressed and not, the launch counters and P2P counts set to 0
      before each ring: every virtual rank's aggregate equal bit for
      bit to every other's and to ``aggregate_blocks`` on the same
      rows, (P - 1) x n_blocks (+ P - 1) sends and receives a rank,
      ``chunk_quantize`` once a rank, ``chunk_dequantize`` once a
      stage, ``fedavg_reduce`` once a rank; seconds, peak memory and
      bytes on the wire a rank; then one-rank gloo and NCCL groups
      refuse a CUDA and a CPU tensor;
   b. ``moe_ep_local``: one olmoe-1b-7b MoE layer at full width (64
      experts of 1024, top 8, bf16, capacity factor 1.25) on 8192
      seeded tokens: the bf16 sum of 4 and of 8 virtual model ranks'
      ``_moe_local_block`` outputs within 1e-2 of ``_moe_ffn``; both
      timed; then a checkpoint's recomputation on the card, which
      autograd runs on a device thread of its own, sees the forward's
      ``axis_rules`` binding (``layers.checkpointed``);
   c. ``ring_nccl``: with two or more GPUs, min(count, 4) NCCL ranks
      (one process a GPU) run ``torrent_fedavg(mesh=)`` on a (P, 2^28)
      f32 update, compressed and not (equal to the single-device path
      bit for bit on every rank, the P2P counts) and two qwen3-1.7b
      pod-parallel steps (ranks equal; rank 0 against the single-device
      path: losses, params and the f32 master, m and v equal bit for
      bit); with one GPU
      it prints ``{"phase": "ring_nccl", "ran": false, "gpus": 1}``;
13. the dry run (``repro_torch.launch.dryrun``, ``run_dryrun_paths``;
   no kernel build; the plain path, as the dry run traces it):
   a. fidelity: one pod's qwen3-1.7b training step at full width on a
      one-device mesh (``DRYRUN_BATCH`` x ``DRYRUN_SEQ`` tokens),
      traced under fake tensors and then run on the card, each under
      ``CostCounter``: FLOPs, HBM bytes, op counts and collective counts
      equal; the fake run's peak within 10% of the card's
      ``max_memory_allocated``; a second step timed without the counter,
      and ``model_flops`` over that time printed as TFLOP/s and as a
      share of 989 TFLOP/s, with the roofline bound over the time and
      the card's name and power limit;
   b. one production cell: qwen3-1.7b ``train_4k`` traced on the
      2 x 16 x 16 mesh (rank 0 of 512 on the ``fake`` backend: the pod
      ring, the placements); its record printed;
14. prints one ``{"slot_engine": {...}}`` line with the slot engine's
   times, one ``{"event_paths": {...}}`` line with those times, one
   ``{"fl_paths": {...}}`` line with the FL phase's rows and times,
   ``{"ring_local": ...}``, ``{"moe_ep_local": ...}``,
   ``{"ring_nccl": ...}`` and ``{"dryrun": ...}`` lines, one
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
   {...}}``.

Any failed phase exits non-zero before the last line is printed.  With
no CUDA device, or outside a checkout of the repository, it exits
non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores, same sheet
BF16_OPS_PER_S = 989e12         # bf16 tensor cores, dense, same sheet
FULL_D = 1_720_574_976          # qwen3-1.7b parameter count
GRANITE_D = 1_334_628_352       # granite-moe-1b-a400m parameter count
PODS = 2
TORRENT_BLOCKS = 4
# arch, parameter count, train driver steps, then compressed steps of
# ElasticFLStep; the driver runs P = PODS, batch 8, seq 512
TRAIN_PATHS = (("qwen3-1.7b", FULL_D, 4, 2),
               ("granite-moe-1b-a400m", GRANITE_D, 3, 1))
FEDAVG_TOL = 2e-5
BF16_TOL = 1e-2
ATTN_TOL = 3e-5                 # f32 attention, as tests/test_kernels.py
RGLRU_TOL = 2e-5                # f32 rglru, as tests/test_kernels.py
SERVE_ARCHS = ("gemma2-2b", "recurrentgemma-2b", "gemma3-4b", "xlstm-350m",
               "olmoe-1b-7b")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 8192, 32
# the functions of models/layers.py that prefill_split times, by the
# layer kind that calls them
SPLIT_FUNCS = {"mlstm": ("_apply_mlstm",), "slstm": ("_apply_slstm",),
               "moe": ("_attention_mix", "_moe_ffn")}
SERVE_REL_L2 = 2e-2             # kernel vs plain prefill logits, bf16
# archs whose full-depth logits gap sits at the one-ulp bf16 floor
# (below), above SERVE_REL_L2: their last logits are held to a fixed
# limit of their own, above the readings of sound runs and below a
# faulty control's (PERF.md), and each of their layers is held
# to LAYER_REL_L2 by layer_witness, where depth does not blur a fault;
# olmoe's floor is raised by its routing: a one-ulp change of a
# token's state can swap its 8th and 9th expert
SERVE_REL_L2_DEEP = {"gemma3-4b": 4e-2, "olmoe-1b-7b": 4e-2}
LAYER_REL_L2 = 1e-2             # one layer's update, kernels vs plain
# the faults of the served config that the controls run: a fault of the
# attention mask, or of the keys' and queries' rotation (an offset of
# both positions by one cancels in RoPE's relative form, so the control
# halves RoPE's base instead)
FAULTS = {"half the window": lambda c: c.replace(window=c.window // 2),
          "no causal mask": lambda c: c.replace(causal=False),
          "RoPE theta halved": lambda c: c.replace(rope_theta=c.rope_theta
                                                   / 2)}
# archs whose every layer layer_witness holds, with its two controls;
# the first also runs at full depth as the control of the logits' limit
# of an arch in SERVE_REL_L2_DEEP (a global-only model has no window)
WITNESS_CONTROLS = {"gemma3-4b": ("half the window", "no causal mask"),
                    "olmoe-1b-7b": ("RoPE theta halved", "no causal mask")}
SERVE_TOKENS_AGREE = 7          # of SERVE_BATCH first greedy tokens
# b, hq, hkv, tq, tk, d, causal, window, softcap, q_offset, kv_offset:
# tests/test_torch_kernels.py's ATTN_CASES, then head dims 256 and 80,
# group 10, ragged tiles, a rolling decode cache with negative key
# positions, three query rows, and rows (or a whole tile) with no live
# key; then each route's own cases
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None, 0, 0),
    (1, 8, 4, 256, 256, 128, True, 64, None, 0, 0),
    (1, 2, 2, 100, 100, 32, True, None, 50.0, 0, 0),
    (2, 4, 1, 1, 320, 64, True, None, None, 319, 0),
    (1, 4, 4, 1, 64, 32, True, 64, None, 100, 37),
    (1, 4, 4, 128, 256, 64, False, None, None, 0, 0),
    (1, 2, 1, 96, 96, 16, True, 32, 30.0, 0, 0),
    (2, 8, 4, 200, 200, 256, True, None, 50.0, 0, 0),
    (1, 4, 4, 70, 90, 80, False, None, None, 0, 0),
    (1, 10, 1, 130, 130, 256, True, 48, None, 0, 0),
    (2, 4, 2, 77, 150, 64, True, 100, 50.0, 73, 0),
    (1, 8, 4, 1, 64, 256, True, 64, 50.0, 10, -53),
    (2, 4, 2, 3, 100, 128, True, None, 50.0, 97, 0),
    (1, 2, 1, 8, 40, 32, True, None, None, 0, 5),
    (1, 2, 2, 70, 64, 64, True, None, None, 0, 100),
    # bf16 takes the wgmma route: D 64, 128, 256, ragged Tq and Tk, window
    # and softcap on, q_offset > 0
    (2, 4, 2, 200, 333, 64, True, 100, 50.0, 133, 0),
    (1, 8, 4, 200, 333, 128, True, 150, 30.0, 133, 0),
    (2, 8, 4, 200, 333, 256, True, 96, 50.0, 133, 0),
    # split-KV decode: group 10 over 32 splits of a full rolling cache;
    # Tq 3 over a rolling cache with negative key positions (15 splits,
    # 30 rows in 2 row blocks); a row with no live key in its one split;
    # no live key at all (one empty split); D 80, group 16, Tq 4
    (2, 10, 1, 1, 2048, 256, True, 2048, None, 2999, 952),
    (1, 10, 1, 3, 2048, 128, True, 2048, 50.0, 1000, -1047),
    (2, 8, 4, 3, 300, 64, True, None, None, 0, 1),
    (1, 4, 2, 1, 100, 32, True, None, None, 0, 5),
    (1, 16, 1, 4, 1000, 80, True, None, 30.0, 996, 0),
]
DEAD_ROWS = {13: 5, 14: 70, 20: 1, 21: 1}   # index -> leading dead rows
# b, t, d: the test suite's shapes and T = 1, then T just under and at
# the scan route's threshold, ragged last chunks with ragged D, D of 9
# (rows not whole 16-byte vectors: the element-by-element path) and
# many chunks; every fifth time row has a = 1 exactly
RGLRU_CASES = [(2, 128, 64), (1, 300, 100), (3, 64, 512), (1, 17, 9),
               (4, 1, 2560), (2, 255, 72), (1, 256, 2560), (2, 1000, 200),
               (3, 777, 9), (1, 2048, 136)]
MLSTM_TOL = 5e-4                # f32, as tests/test_mlstm_kernel.py
MLSTM_BF16_TOL = 3e-2
# b, h, t, dh, chunk, gate scale, dtype, layout: tests/test_mlstm_kernel.py's
# shapes, then head dims 512 and 80 (ragged slices and row blocks), gates
# x10, T = 1, the layer's transposed (B, T, H, dh) views, chunk 100, bf16;
# then the tensor-core route's own: dh 512, 256, 96, 64 and 32, chunk 64
# and 128, gates x10, both layouts, bf16, one chunk, and T = 2048 (16
# chunks of 128, 32 of 64) for the carried state
MLSTM_CASES = [
    (2, 4, 64, 16, 16, 1.0, "float32", "bhtd"),
    (1, 2, 128, 32, 32, 1.0, "float32", "bhtd"),
    (1, 1, 256, 128, 128, 1.0, "float32", "bhtd"),
    (2, 2, 96, 8, 16, 1.0, "float32", "bhtd"),
    (1, 2, 256, 512, 128, 1.0, "float32", "bthd"),
    (2, 3, 160, 80, 32, 1.0, "float32", "bhtd"),
    (2, 2, 128, 64, 64, 10.0, "float32", "bhtd"),
    (1, 4, 256, 512, 128, 10.0, "float32", "bthd"),
    (1, 1, 1, 16, 1, 1.0, "float32", "bhtd"),
    (1, 2, 200, 48, 100, 1.0, "float32", "bthd"),
    (1, 2, 64, 32, 32, 1.0, "bfloat16", "bhtd"),
    (2, 4, 256, 512, 128, 1.0, "bfloat16", "bthd"),
    (2, 4, 2048, 512, 128, 1.0, "float32", "bthd"),
    (1, 2, 2048, 512, 64, 10.0, "float32", "bhtd"),
    (2, 2, 256, 256, 64, 10.0, "float32", "bthd"),
    (1, 3, 384, 256, 128, 1.0, "bfloat16", "bthd"),
    (1, 2, 512, 96, 128, 1.0, "float32", "bhtd"),
    (1, 3, 128, 64, 128, 10.0, "float32", "bthd"),
    (2, 2, 2048, 32, 128, 1.0, "float32", "bthd"),
    (2, 2, 64, 32, 64, 10.0, "bfloat16", "bhtd"),
]
XLSTM_SMALL_PROMPT = 200        # pads the reduced model's last mLSTM chunk
TF32_OPS_PER_S = 494e12         # TF32 tensor cores, dense, same sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# set-up
# ----------------------------------------------------------------------

def setup():
    """Import torch and the port; refuse to run without a card or repo."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this "
                           "smoke test needs an NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{src / 'repro_torch'} is missing: run "
                           "chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


PTXAS_SOURCES = ("attention.cu", "mlstm.cu", "rglru.cu", "slots.cu")
# build()'s ptxas report: (source, mangled kernel) -> registers, spills,
# static shared memory
PTXAS: dict = {}


def build() -> float:
    """Build the extension; meanwhile compile each of ``PTXAS_SOURCES``
    alone with ``-Xptxas -v`` (all at once) and log what ptxas says of
    its kernels, then count the ``HGMMA`` (wgmma) instructions in each
    kernel's SASS (``cuobjdump -sass``): nonzero in attention's wgmma
    prefill kernel and in every instance of mlstm's tensor-core
    kernels."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    out_dir = _build.BUILD_DIR.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    procs = {}
    for src in PTXAS_SOURCES:
        obj = out_dir / (Path(src).stem + "_ptxas.o")
        procs[src] = (obj, subprocess.Popen(
            [nvcc, *_build.CUDA_FLAGS, "-std=c++17", "-Xptxas", "-v", "-c",
             str(_build.CSRC / src), f"-I{_build.CSRC}", "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    try:
        _build.extension()
        for src, (_, proc) in procs.items():
            reports[src], _ = proc.communicate(timeout=600)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for src, (obj, proc) in procs.items():
        check(proc.returncode == 0,
              f"nvcc -Xptxas -v {src}:\n{reports[src]}")
        injected = 0
        func = None
        for line in reports[src].splitlines():
            if "C7519" in line:          # ptxas fenced a wgmma's registers
                injected += 1
                continue
            if "entry function '" in line:
                func = line.split("entry function '", 1)[1].split("'")[0]
                PTXAS[(src, func)] = {}
            elif func is not None and "spill stores" in line:
                words = line.replace(",", " ").split()
                PTXAS[(src, func)]["spill_stores"] = int(
                    words[words.index("spill") - 2])
            elif func is not None and "Used" in line and "registers" in line:
                words = line.split()
                PTXAS[(src, func)]["registers"] = int(
                    words[words.index("registers,") - 1]
                    if "registers," in words
                    else words[words.index("Used") + 1])
                if "smem," in words or "smem" in words:
                    PTXAS[(src, func)]["smem_bytes"] = int(words[
                        (words.index("smem,") if "smem," in words
                         else words.index("smem")) - 2])
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"{src} {line.strip()}")
        if injected:
            log(f"{src}: ptxas injected {injected} warpgroup.arrive fences "
                "around wgmma register operands (C7519)")
    hgmma: dict = {}
    for src, (obj, _) in procs.items():
        sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                               "-sass", str(obj)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        func = None
        for line in sass.splitlines():
            if "Function :" in line:
                func = line.split("Function :", 1)[1].strip()
                hgmma[(src, func)] = 0
            elif func is not None and "HGMMA" in line:
                hgmma[(src, func)] += 1
    for (src, func), n in hgmma.items():
        log(f"{src} SASS {func}: {n} HGMMA instructions")
    check(any(n > 0 for (src, f), n in hgmma.items()
              if src == "attention.cu" and "wgmma" in f),
          "attention.cu: no HGMMA instruction in the wgmma prefill kernel")
    for part in ("mlstm_intra", "mlstm_inter"):
        tc = [n for (src, f), n in hgmma.items()
              if src == "mlstm.cu" and part in f]
        check(bool(tc) and all(n > 0 for n in tc),
              f"mlstm.cu: a {part} kernel without HGMMA instructions: {tc}")
    return time.perf_counter() - t0


# ----------------------------------------------------------------------
# timing helpers
# ----------------------------------------------------------------------

def time_ms(fn, runs: int = 10) -> float:
    """Median over ``runs`` CUDA-event timings, after a warm-up, of one
    call of ``fn()``: each timing spans enough back-to-back calls (up to
    100) to take about 2 ms, so that a short kernel's time is the
    card's and not the host's enqueue."""
    import torch

    def once(n: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    fn()
    torch.cuda.synchronize()
    n = max(1, min(100, int(2.0 / max(once(1), 1e-3))))
    return statistics.median(once(n) for _ in range(runs))


def time_fresh_ms(fn, src, runs: int = 10, pool: int = 20) -> float:
    """``time_ms`` for a call that updates its argument in place: median
    over ``runs`` CUDA-event timings of ``fn(b)`` over ``pool`` copies
    ``b`` of ``src``, all refreshed before each timing starts."""
    import torch

    bufs = [src.clone() for _ in range(pool)]
    fn(bufs[0])
    times = []
    for _ in range(runs):
        for b in bufs:
            b.copy_(src)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for b in bufs:
            fn(b)
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e) / pool)
    return statistics.median(times)


def graph_ms(fn, calls: int, runs: int = 10) -> float:
    """Device milliseconds of one call: median over ``runs`` CUDA-event
    timings of one replay of a CUDA graph that holds ``fn(0)`` to
    ``fn(calls - 1)``, so the host's enqueue (the wrapper's checks and
    allocations) is not in the time, as it is in ``time_ms`` for a call
    shorter than its enqueue.  Every call's result is kept until the
    timing ends, so no call writes into memory an earlier call wrote
    (and left in L2); ``fn`` picks its inputs by the call's index."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                           # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn(i) for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e) / calls)
    del graph, kept
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: the larger of its bytes (each input read
    once, each output written once) over the HBM rate and its
    operations over the card's rate for their type (f32 by default);
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms_by_kernel(fn, match: str, calls: int = 3) -> dict:
    """Mean device milliseconds per call of ``fn`` for each CUDA kernel
    whose name contains ``match``, from ``torch.profiler`` over
    ``calls`` calls after a warm-up; empty if the trace has no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dt = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0))
        if match in e.key and dt:
            name = e.key.split("(anonymous namespace)::")[-1].split("<")[0]
            out[name] = out.get(name, 0.0) + dt / calls / 1e3
    return out


def free_cuda() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------

def _close_err(got, want, atol: float, rtol: float, what: str) -> float:
    """Max |got - want|; fails where it exceeds atol + rtol * |want|."""
    import torch
    g, w = got.float(), want.float()
    check(torch.equal(torch.isfinite(g), torch.isfinite(w)),
          f"{what}: non-finite values differ")
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    check(ok, f"{what}: max abs error {err:.3e} exceeds atol={atol} "
              f"rtol={rtol}")
    return err


def check_small() -> None:
    """Kernels vs plain versions at small and odd shapes, edge cases."""
    import torch

    from repro_torch.kernels import fedavg, quantize, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n_cases = 0
    for n in (1, 2, 3, 7):
        for d in (1, 2047, 2 ** 20 + 3):
            u = torch.randn((n, d), generator=gen, device=dev)
            w = torch.rand((n,), generator=gen, device=dev) * 10
            a = (torch.rand((n,), generator=gen, device=dev) > 0.3).float()
            a[0] = 1.0
            got = fedavg.fedavg_reduce(u, w, a)
            _close_err(got, ref.fedavg_reduce(u, w, a), FEDAVG_TOL,
                       FEDAVG_TOL, f"fedavg n={n} d={d}")
            x = torch.randn((n, d), generator=gen, device=dev) * 5
            q, s = quantize.chunk_quantize(x)
            qr, sr = ref.chunk_quantize(x)
            check(torch.equal(q, qr) and torch.equal(s, sr),
                  f"quantize n={n} e={d}: codes or scales differ")
            for dt in (torch.float32, torch.bfloat16):
                check(torch.equal(quantize.chunk_dequantize(q, s, dtype=dt),
                                  ref.chunk_dequantize(q, s).to(dt)),
                      f"dequantize n={n} e={d} {dt}: values differ")
            n_cases += 1
    # zero active mass -> zeros, never NaN
    u = torch.randn((4, 4099), generator=gen, device=dev)
    w = torch.tensor([1., 2., 3., 4.], device=dev)
    z = fedavg.fedavg_reduce(u, w, torch.zeros(4, device=dev))
    check(bool((z == 0).all()), "fedavg zero mass: not all zeros")
    # a masked NaN row is selected out, not multiplied
    u[2] = float("nan")
    act = torch.tensor([1., 1., 0., 1.], device=dev)
    got = fedavg.fedavg_reduce(u, w, act)
    check(bool(torch.isfinite(got).all()), "fedavg: masked NaN row leaked")
    _close_err(got, ref.fedavg_reduce(u, w, act), FEDAVG_TOL, FEDAVG_TOL,
               "fedavg masked NaN row")
    # bf16 updates, f32 accumulation, bf16 result
    ub = torch.randn((3, 2 ** 20 + 3), generator=gen, device=dev).bfloat16()
    got = fedavg.fedavg_reduce(ub, w[:3], act[:3])
    check(got.dtype == torch.bfloat16, "fedavg bf16: wrong output dtype")
    _close_err(got, ref.fedavg_reduce(ub, w[:3], act[:3]), BF16_TOL,
               BF16_TOL, "fedavg bf16")
    # round half to even, an all-zero row, exact amax
    ties = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                         [0.0] * 8], device=dev)
    q, s = quantize.chunk_quantize(ties)
    qr, sr = ref.chunk_quantize(ties)
    check(torch.equal(q, qr) and torch.equal(s, sr),
          "quantize ties / zero row: differ from the plain version")
    check(q[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126],
          f"quantize ties: got {q[0].tolist()}")
    check(bool((q[1] == 0).all()) and float(s[1]) == 1.0,
          "quantize zero row: codes or scale wrong")
    # non-finite rows must not fault; finite rows stay exact
    x = torch.randn((4, 5000), generator=gen, device=dev)
    x[1, 17] = float("nan")
    x[2, 3] = float("inf")
    q, s = quantize.chunk_quantize(x)
    torch.cuda.synchronize()
    qr, sr = ref.chunk_quantize(x)
    for r in (0, 3):
        check(torch.equal(q[r], qr[r]) and torch.equal(s[r], sr[r]),
              f"quantize finite row {r} next to non-finite rows differs")
    log(f"small-shape checks passed ({n_cases} shapes + edge cases)")


def _attn_inputs(case, dtype, gen):
    import torch
    b, hq, hkv, tq, tk, d = case[:6]
    dev = torch.device("cuda")
    q = torch.randn((b, hq, tq, d), generator=gen, device=dev)
    k = torch.randn((b, hkv, tk, d), generator=gen, device=dev)
    v = torch.randn((b, hkv, tk, d), generator=gen, device=dev)
    kw = dict(causal=case[6], window=case[7], softcap=case[8],
              q_offset=case[9], kv_offset=case[10])
    return q.to(dtype), k.to(dtype), v.to(dtype), kw


def check_small_serving() -> None:
    """flash_attention and rglru_scan vs their plain versions at small
    and odd shapes, the gradient through attention(impl="cuda")."""
    import torch

    from repro_torch.kernels import attention, ops, ref, rglru
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    for i, case in enumerate(ATTN_CASES):
        for dt, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16,
                                                    BF16_TOL)):
            q, k, v, kw = _attn_inputs(case, dt, gen)
            got = attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(got.dtype == dt and got.shape == q.shape,
                  f"flash_attention {case}: {got.dtype} {tuple(got.shape)}")
            want = ops.attention(q, k, v, impl="torch", block_q=64, **kw)
            _close_err(got, want, tol, tol, f"flash_attention {case} {dt}")
            dead = DEAD_ROWS.get(i, 0)
            check(bool((got[:, :, :dead] == 0).all()),
                  f"flash_attention {case}: a row with no live key is "
                  "not exactly 0")
    # the gradient recomputes through the plain path
    q, k, v, kw = _attn_inputs(ATTN_CASES[10], torch.float32, gen)
    grads = []
    for impl in ("cuda", "torch"):
        req = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.attention(*req, impl=impl, block_q=64, **kw)
        grads.append(torch.autograd.grad((out * out).sum(), req))
    for name, a, b in zip("qkv", *grads):
        _close_err(a, b, ATTN_TOL, ATTN_TOL, f"attention d{name}")
    routes: dict = {}
    for b, t, d in RGLRU_CASES:
        x = torch.randn((b, t, d), generator=gen, device="cuda")
        a = 0.5 + 0.499 * torch.rand((b, t, d), generator=gen, device="cuda")
        a[:, ::5] = 1.0
        g = torch.rand((b, t, d), generator=gen, device="cuda")
        h0 = torch.randn((b, d), generator=gen, device="cuda")
        for dt, tol in ((torch.float32, RGLRU_TOL), (torch.bfloat16,
                                                     BF16_TOL)):
            path = rglru.route(t, dt)
            routes[path] = routes.get(path, 0) + 1
            for h in (None, h0):
                xs, as_, gs = x.to(dt), a.to(dt), g.to(dt)
                y, ht = rglru.rglru_scan(xs, as_, gs, h)
                torch.cuda.synchronize()
                yr, hr = ref.rglru(xs, as_, gs, h)
                what = (f"rglru_scan ({b}, {t}, {d}) {dt} h0="
                        f"{h is not None}, {path}")
                check(y.dtype == dt and ht.dtype == torch.float32,
                      f"{what}: dtypes {y.dtype}, {ht.dtype}")
                _close_err(y, yr, tol, tol, what)
                _close_err(ht, hr, RGLRU_TOL, RGLRU_TOL, what + " h_T")
    check(set(routes) == {"scan", "seq"}, f"rglru routes taken: {routes}")
    log(f"small serving-kernel checks passed ({len(ATTN_CASES)} attention "
        f"shapes x 2 dtypes, the gradient, {len(RGLRU_CASES)} rglru shapes"
        f" x 2 dtypes x 2 h0; rglru routes {routes})")


def _mlstm_inputs(b, h, t, dh, gate_scale, dtype, layout, gen):
    """q, k, v (B, H, T, dh) of ``dtype``, i and f (B, H, T) f32; with
    layout "bthd" they are transposed views of (B, T, H, ...) tensors,
    as the layer passes them."""
    import torch
    dev = torch.device("cuda")
    shp, gshp = ((b, t, h, dh), (b, t, h)) if layout == "bthd" else (
        (b, h, t, dh), (b, h, t))
    q = torch.randn(shp, generator=gen, device=dev) * dh ** -0.5
    k = torch.randn(shp, generator=gen, device=dev) * dh ** -0.5
    v = torch.randn(shp, generator=gen, device=dev)
    i = torch.randn(gshp, generator=gen, device=dev) * gate_scale
    f = (torch.randn(gshp, generator=gen, device=dev) + 1.0) * gate_scale
    if layout == "bthd":
        q, k, v, i, f = (x.transpose(1, 2) for x in (q, k, v, i, f))
    return q.to(dtype), k.to(dtype), v.to(dtype), i, f


# (n, m_pad, m_cnt, w_full): one word, ragged candidates, S = 1 and 16,
# the sweep's 8192 candidates; W = 1, 8, 4, 256 and 2 words, so
# slot_planes runs every width of CTA (1, 2, 4, 8 words) and a row that
# spans CTAs; the inventory holds 32 w_full chunks
SLOT_CASES = [(7, 32, 32, 20), (50, 256, 200, 400), (33, 128, 97, 64),
              (300, 8192, 8000, 3219), (20, 64, 41, 3)]


def slot_case(case, g):
    """Seeded stage-1 inputs of ``case``'s (n, m_pad, m_cnt, w_full)
    size from numpy generator ``g``, as CPU tensors (have_t, cand,
    owner, allowed, recv_ok): a chunk-major inventory of 32 w_full rows
    of ``_n_wp(n)`` random words (bit 31 set, garbage in the bits of
    peers at or above n, every third row sparser), candidate ids
    anywhere in it, random owners, windows and receivers."""
    import numpy as np
    import torch

    from repro_torch.core.jit_engine import _n_wp
    n, m_pad, m_cnt, w_full = case
    have_t = g.integers(-2 ** 31, 2 ** 31, size=(w_full * 32, _n_wp(n)),
                        dtype=np.int64).astype(np.int32)
    have_t[::3] &= g.integers(-2 ** 31, 2 ** 31, size=have_t[::3].shape,
                              dtype=np.int64).astype(np.int32)
    cand = g.choice(w_full * 32, size=m_pad, replace=False)
    owner = g.integers(0, n, size=m_pad)
    return [torch.from_numpy(have_t), torch.from_numpy(cand).int(),
            torch.from_numpy(owner).int(),
            torch.from_numpy(g.random(m_pad) < 0.5),
            torch.from_numpy(g.random(n) < 0.8)]


def check_small_slots(device="cuda", cases=SLOT_CASES) -> None:
    """The three slot kernels against their plain versions on seeded
    inputs (``cases`` of (n, m_pad, m_cnt, w_full), every plane layout:
    with and without the owner tier, gated and ungated), exact:
    ``slot_case``'s chunk-major inventories with garbage pad bits;
    random senders, grants of 0 to 64 columns with the tier split at
    its count, rows with no grant.
    tests/test_torch_jit_engine.py runs it case by case."""
    import numpy as np
    import torch

    from repro_torch.kernels import slots
    dev = torch.device(device)
    held = 0
    for n, m_pad, m_cnt, w_full in cases:
        g = np.random.default_rng(n * m_pad)
        host = slot_case((n, m_pad, m_cnt, w_full), g)
        for nonowner in (True, False):
            for ungated in (True, False):
                kw = dict(nonowner=nonowner, ungated=ungated)
                want = slots.slot_planes(*host, m_cnt, **kw, impl="torch")
                got = slots.slot_planes(*(t.to(dev) for t in host), m_cnt,
                                        **kw)
                for w, c in zip(want, got):
                    check((w is None) == (c is None)
                          and (w is None or torch.equal(c.cpu(), w)),
                          f"slot_planes {n, m_pad, m_cnt} {kw}: differs")
                plane_a, plane_b, need = want[:3]
                u_c = torch.from_numpy(g.integers(0, n, size=n))
                on = (lambda t: None if t is None else t.to(dev))
                sbc, cnt_b = slots.overlap_rank(plane_a, plane_b, need, u_c,
                                                impl="torch")
                csbc, ccnt = slots.overlap_rank(on(plane_a), on(plane_b),
                                                on(need), on(u_c))
                check(torch.equal(csbc.cpu(), sbc)
                      and torch.equal(ccnt.cpu(), cnt_b),
                      f"overlap_rank {n, m_pad} {kw}: differs")
                cnt_a = sbc[:, -1]
                take = torch.minimum(cnt_a + cnt_b, torch.from_numpy(
                    g.integers(0, 65, size=n)).int()).int()
                take[::5] = 0
                t_a = (torch.minimum(take, cnt_a) if plane_b is not None
                       else take)
                cneed = need.clone().to(dev)
                want_cols = slots.extract_ranked(
                    plane_a, plane_b, need, u_c, take, t_a, sbc, 64,
                    impl="torch")
                cols = slots.extract_ranked(
                    on(plane_a), on(plane_b), cneed, on(u_c), on(take),
                    on(t_a), on(sbc), 64)
                check(torch.equal(cols.cpu(), want_cols)
                      and torch.equal(cneed.cpu(), need),
                      f"extract_ranked {n, m_pad} {kw}: differs")
                held += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"slot kernels: slot_planes, overlap_rank and extract_ranked equal "
        f"to their plain versions on {held} cases")


def random_slot(case, mode_id: int, nonowner: bool, ungated: bool,
                variant: int, device="cpu"):
    """A seeded slot of ``case``'s (n, m_pad, m_cnt, w_full) size for
    ``slots.slot_rounds``: the planes of a random inventory, a random
    overlay (``variant`` 1: not symmetric, with a peer that no one lists;
    2: noise, tie and priority bases drawn from 3 values, so scores,
    keys and priorities tie), random budgets, some of them 0.  Returns
    the wrapper's positional arguments and keywords on ``device``."""
    import numpy as np
    import torch

    from repro_torch.core.jit_engine import _n_wp, _pow2, _transpose_lists
    from repro_torch.kernels import slots
    n, m_pad, m_cnt, w_full = case
    g = np.random.default_rng([n, m_pad, mode_id, nonowner, ungated,
                               variant])
    have_t = g.integers(-2 ** 31, 2 ** 31, size=(w_full * 32, _n_wp(n)),
                        dtype=np.int64).astype(np.int32)
    # every even peer holds about a quarter of the chunks, odd ones half
    have_t &= g.integers(-2 ** 31, 2 ** 31, size=have_t.shape,
                         dtype=np.int64).astype(np.int32) | np.int32(
                             -0x55555556)
    cand = g.choice(w_full * 32, size=m_pad, replace=False)
    host = [torch.from_numpy(have_t), torch.from_numpy(cand).int(),
            torch.from_numpy(g.integers(0, n, size=m_pad)).int(),
            torch.from_numpy(g.random(m_pad) < 0.5),
            torch.from_numpy(g.random(n) < 0.85)]
    planes = slots.slot_planes(*host, m_cnt, nonowner=nonowner,
                               ungated=ungated, impl="torch")
    adj = g.random((n, n)) < min(6.0 / n, 0.5)
    if variant != 1:
        adj |= adj.T
    else:
        adj[:, n - 1] = False            # no one lists the last peer
    np.fill_diagonal(adj, False)
    deg = adj.sum(1)
    nbr = np.full((n, _pow2(max(int(deg.max(initial=1)), 1))), -1, np.int32)
    for v in range(n):
        row = np.flatnonzero(adj[v])
        nbr[v, :row.size] = g.permutation(row)
    in_nbr = _transpose_lists(nbr)
    rem_up = g.integers(0, 40, size=n).astype(np.int32)
    rem_down = g.integers(0, 60, size=n).astype(np.int32)
    rem_up[::7] = 0
    hi = 3 if variant == 2 else 2 ** 32
    bases = tuple(torch.from_numpy(
        g.integers(0, hi, size=shape, dtype=np.int64).astype(np.uint32)
        .view(np.int32)) for shape in (nbr.shape, (n,), (n,)))
    on = (lambda t: t if t is None else t.to(device))
    args = [*(on(t) for t in planes), on(torch.from_numpy(nbr)),
            on(torch.from_numpy(in_nbr)), on(torch.from_numpy(rem_up)),
            on(torch.from_numpy(rem_down)), tuple(on(b) for b in bases)]
    kw = dict(mode_id=mode_id, t_cap=64, r_max=16,
              batch_cap=(8 if variant == 0 else 1 << 30), tau=2)
    return args, kw


def check_small_slot_rounds(device="cuda", cases=SLOT_CASES) -> int:
    """``slots.slot_rounds`` against ``slot_rounds_plain`` on the same
    device, exactly, on seeded random slots of each of ``cases``' sizes
    (``random_slot``): the three modes, every plane layout and the three
    overlay and base variants.  tests/test_torch_jit_engine.py runs it
    case by case.  Returns the number of rounds held."""
    import torch

    from repro_torch.kernels import slots
    held = rounds = 0
    for case in cases:
        for mode_id in (0, 1, 2):
            for nonowner, ungated in ((True, False), (False, False),
                                      (False, True), (True, True)):
                for variant in (0, 1, 2):
                    args, kw = random_slot(case, mode_id, nonowner, ungated,
                                           variant, device)
                    snd, col, r = slots.slot_rounds(*args, **kw)
                    psnd, pcol, pr = slots.slot_rounds_plain(
                        *args[:6], *args[7:], **kw)
                    what = (f"slot_rounds {case} mode {mode_id} nonowner "
                            f"{nonowner} ungated {ungated} variant "
                            f"{variant}")
                    check(torch.equal(r, pr), f"{what}: {int(r)} rounds "
                          f"against {int(pr)}")
                    check(torch.equal(snd, psnd),
                          f"{what}: out_snd differs in "
                          f"{int((snd != psnd).sum())} cells")
                    check(torch.equal(col, pcol),
                          f"{what}: out_col differs in "
                          f"{int((col != pcol).sum())} cells")
                    held += 1
                    rounds += int(pr)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"slot_rounds: equal to slot_rounds_plain on {held} random slots "
        f"({rounds} rounds) on {device}")
    return rounds


def check_small_mlstm() -> None:
    """mlstm_chunkwise vs its plain version at small and odd shapes: h
    and the final state (C, n, m), all finite."""
    import torch

    from repro_torch.kernels import mlstm, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    routes: dict = {}
    for b, h, t, dh, chunk, gsc, dtype, layout in MLSTM_CASES:
        dt = getattr(torch, dtype)
        path = mlstm.route(dt, dh, chunk)
        routes[path] = routes.get(path, 0) + 1
        q, k, v, i, f = _mlstm_inputs(b, h, t, dh, gsc, dt, layout, gen)
        got = mlstm.mlstm_chunkwise(q, k, v, i, f, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.mlstm_chunkwise(q.float(), k.float(), v.float(), i, f,
                                   chunk=chunk)
        what = (f"mlstm_chunkwise ({b}, {h}, {t}, {dh}) chunk {chunk} gates "
                f"x{gsc} {dtype} {layout}, {path}")
        check(got[0].dtype == dt and got[0].shape == q.shape
              and all(x.dtype == torch.float32 for x in got[1:]),
              f"{what}: dtypes {[x.dtype for x in got]}")
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f"{what}: non-finite output")
        tol = MLSTM_TOL if dt == torch.float32 else MLSTM_BF16_TOL
        for name, g, w in zip(("h", "C", "n", "m"), got, want):
            _close_err(g, w, tol, tol, f"{what} {name}")
    check(set(routes) == {"tc", "fma"}, f"mlstm routes taken: {routes}")
    log(f"small mlstm checks passed ({len(MLSTM_CASES)} shapes: h, C, n, m;"
        f" routes {routes})")


def check_full_shapes(train_counts: dict) -> list[dict]:
    """Each kernel at the train steps' shapes: compare, time, bound.
    ``train_counts``: each training arch's launch counts; fedavg has a
    row at each arch's D, quantize and dequantize at qwen3-1.7b's."""
    import torch

    from repro_torch.kernels import quantize, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = []

    # fedavg over the gathered (P, D) f32 buffer
    for arch, d, _, _ in TRAIN_PATHS:
        u = torch.randn((PODS, d), generator=gen, device=dev)
        w = torch.tensor([3.0, 1.0], device=dev)
        a = torch.ones(PODS, device=dev)
        rows.append(fedavg_row(u, w, a, train_counts[arch], arch, 1 << 28))
        del u
        free_cuda()
    counts = train_counts["qwen3-1.7b"]     # quantize's rows: qwen3's D

    # quantize / dequantize over the torrent blocks (P * n_blocks, db)
    nq, e = PODS * TORRENT_BLOCKS, FULL_D // TORRENT_BLOCKS
    x = torch.randn((nq, e), generator=gen, device=dev).mul_(5)
    q, s = quantize.chunk_quantize(x)
    q_err = 0.0
    for r in range(nq):
        qr, sr = ref.chunk_quantize(x[r:r + 1])
        q_err = max(q_err, float((q[r:r + 1].int() - qr.int()).abs().max()),
                    float((s[r:r + 1] - sr).abs().max()))
        check(torch.equal(q[r:r + 1], qr) and torch.equal(s[r:r + 1], sr),
              f"quantize full row {r}: codes or scales differ")
        del qr, sr

    def plain_quant():
        for r in range(nq):
            ref.chunk_quantize(x[r:r + 1])

    ms = time_ms(lambda: quantize.chunk_quantize(x))
    plain = time_ms(plain_quant, runs=3)
    nbytes = 4.0 * nq * e + 1.0 * nq * e + 4.0 * nq
    ops = 6.0 * nq * e          # abs, max, divide, round, two clamps
    rows.append(_row("chunk_quantize", "csrc/quantize.cu",
                     "src/repro/kernels/quantize.py:34", counts, q_err, ms,
                     plain, bound_ms(nbytes, ops), None))
    # a row's amax must be known before any of its codes is written, and
    # a row (1.72 GB) is far larger than L2, so x is read twice
    two_reads = bound_ms(nbytes + 4.0 * nq * e)[0]
    log(f"chunk_quantize ({nq}, {e}) f32: {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s "
        f"({100 * bound_ms(nbytes)[0] / ms:.1f}% of HBM peak); bound with "
        f"x read twice {two_reads:.3f} ms ({100 * two_reads / ms:.1f}%); "
        f"plain {plain:.3f} ms; codes and scales equal")

    out = x   # the train step dequantizes back into the buffer it quantized
    quantize.chunk_dequantize(q, s, out=out)
    d_err = 0.0
    for r in range(nq):
        want = ref.chunk_dequantize(q[r:r + 1], s[r:r + 1])
        d_err = max(d_err, float((out[r:r + 1] - want).abs().max()))
        check(torch.equal(out[r:r + 1], want),
              f"dequantize full row {r}: values differ")
        del want

    def plain_dequant():
        for r in range(nq):
            ref.chunk_dequantize(q[r:r + 1], s[r:r + 1])

    ms = time_ms(lambda: quantize.chunk_dequantize(q, s, out=out))
    plain = time_ms(plain_dequant, runs=3)
    # one PyTorch call for the same function: int8 times the f32 (n, 1)
    # scales promotes to f32, written into the same buffer
    lib = time_ms(lambda: torch.mul(q, s, out=out))
    for r in range(nq):
        check(torch.equal(out[r:r + 1],
                          ref.chunk_dequantize(q[r:r + 1], s[r:r + 1])),
              f"dequantize: torch.mul(q, s) differs on row {r}")
    nbytes = 1.0 * nq * e + 4.0 * nq + 4.0 * nq * e
    ops = 1.0 * nq * e                     # one multiply per value
    rows.append(_row("chunk_dequantize", "csrc/quantize.cu",
                     "src/repro/kernels/quantize.py:55", counts, d_err, ms,
                     plain, bound_ms(nbytes, ops), lib))
    log(f"chunk_dequantize ({nq}, {e}) -> f32: {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s "
        f"({100 * bound_ms(nbytes)[0] / ms:.1f}% of HBM peak); plain "
        f"{plain:.3f} ms; torch.mul(q, s) {lib:.3f} ms; max err "
        f"{d_err:.3e}")
    del x, q, s, out
    free_cuda()
    return rows


def _row(name, source, replaces, counts, err, ms, plain, bound, lib):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": replaces, "launches": counts.get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


# ----------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------

def run_train_path(arch: str, n_params: int, steps: int,
                   comp_steps: int) -> dict:
    """Train driver (``steps`` uncompressed steps) + ``comp_steps``
    compressed ElasticFLStep steps of ``arch`` at full width, the launch
    counters set to 0 before and read after; returns the counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.fl_step import ElasticFLStep
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models import init_params, param_count
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant_lr
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    free_cuda()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hist: list = []
    train.main(["--arch", arch, "--full", "--pods", str(PODS), "--steps",
                str(steps), "--batch", "8", "--seq", "512"], history=hist)
    check(len(hist) == steps,
          f"{arch}: train driver ran {len(hist)} steps, not {steps}")
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"{arch}: non-finite loss in {[h['loss'] for h in hist]}")
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch} train driver: losses "
        + ", ".join(f"{h['loss']:.4f}" for h in hist) + "; step s "
        + ", ".join(f"{h['seconds']:.3f}" for h in hist)
        + f"; peak memory {peak_a:.2f} GB")
    free_cuda()

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = init_params(cfg, gen)
    check(param_count(params) == n_params,
          f"{arch} has {param_count(params)} params, not {n_params}")
    dtypes = {str(t.dtype) for t in leaves(params)}
    opt = adamw_init(params)
    step = ElasticFLStep(cfg, lr_schedule=constant_lr(1e-4),
                         mesh_factory=lambda p: None,
                         torrent_blocks=TORRENT_BLOCKS, compress=True)
    rng = np.random.default_rng(1)
    ones = torch.ones(PODS, device=dev)
    comp = []
    for _ in range(comp_steps):
        batch = train.synthetic_batch(rng, PODS, 4, 512, cfg.vocab,
                                      device=dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, ones, ones)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        comp.append((loss, time.perf_counter() - t0))
    check(all(math.isfinite(l) for l, _ in comp),
          f"{arch}: non-finite compressed loss in {comp}")
    check({str(t.dtype) for t in leaves(params)} == dtypes,
          f"{arch}: the step changed the leaves' dtypes from {dtypes}")
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch} compressed ElasticFLStep: losses "
        + ", ".join(f"{l:.4f}" for l, _ in comp) + "; step s "
        + ", ".join(f"{t:.3f}" for _, t in comp)
        + f"; peak memory {peak_b:.2f} GB; D = {n_params}, leaf dtypes "
        f"{sorted(dtypes)}")
    counts = dict(LAUNCHES)
    del params, opt, step
    free_cuda()
    for name in ("fedavg_reduce", "chunk_quantize", "chunk_dequantize"):
        check(counts.get(name, 0) > 0,
              f"{name} never launched on {arch}'s train path: {counts}")
    log(f"launches on {arch}'s train path: {counts}")
    return counts


def run_serving_path() -> tuple[dict, dict]:
    """The serving driver at full width for each serving arch, the
    launch counters set to 0 before each run and read after it."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve

    total: dict = {}
    out: dict = {}
    for arch in SERVE_ARCHS:
        cfg = serve.serving_config(arch, reduced=False)
        stats: dict = {}
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        toks = serve.main(["--arch", arch, "--full", "--batch",
                           str(SERVE_BATCH), "--prompt-len",
                           str(SERVE_PROMPT), "--gen", str(SERVE_GEN)],
                          stats=stats)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(toks.shape == (SERVE_BATCH, SERVE_GEN),
              f"{arch}: tokens of shape {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch}: tokens outside [0, {cfg.vocab})")
        check(bool(np.isfinite(stats["logits"].numpy()).all()),
              f"{arch}: non-finite prefill logits")
        kinds = list(cfg.pattern) * cfg.n_cycles + list(cfg.tail_kinds)
        if {"global", "local", "moe"} & set(kinds):
            check(counts.get("flash_attention", 0) > 0,
                  f"{arch}: flash_attention never launched: {counts}")
        if "rglru" in kinds:
            check(counts.get("rglru_scan", 0) > 0,
                  f"{arch}: rglru_scan never launched: {counts}")
        if "mlstm" in kinds:
            # once per mLSTM layer in prefill; decode runs the cell step
            n_mlstm = kinds.count("mlstm")
            check(counts.get("mlstm_chunkwise", 0) == n_mlstm,
                  f"{arch}: mlstm_chunkwise launched "
                  f"{counts.get('mlstm_chunkwise', 0)} times, not {n_mlstm}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        kv = 2 * 2 * SERVE_BATCH * cfg.n_kv * cfg.head_dim   # k, v bf16
        dh_m = 2 * cfg.d_model // max(cfg.rnn_heads, 1)
        mem = {"weights": stats["param_bytes"] / 1e9,
               "caches": stats["cache_bytes"] / 1e9,
               "global_kv": kv * (SERVE_PROMPT + SERVE_GEN)
               * (kinds.count("global") + kinds.count("moe")) / 1e9,
               "local_kv": kv * (cfg.window or 0) * kinds.count("local")
               / 1e9,
               "mlstm_state": 4.0 * SERVE_BATCH * cfg.rnn_heads * dh_m
               * (dh_m + 1) * kinds.count("mlstm") / 1e9,
               "peak": peak}
        out[arch] = {"stats": stats, "counts": counts, "mem": mem}
        log(f"serve {arch} full width, batch {SERVE_BATCH}, prompt "
            f"{SERVE_PROMPT}, gen {SERVE_GEN}: prefill "
            f"{stats['prefill_s']:.3f} s, decode "
            f"{stats['decode_tok_s']:.1f} tok/s ({stats['decode_s']:.3f} s);"
            f" peak memory {peak:.2f} GB (weights {mem['weights']:.2f}, "
            f"caches {mem['caches']:.2f}: global KV {mem['global_kv']:.2f},"
            f" local KV {mem['local_kv']:.2f}, mLSTM C and n "
            f"{mem['mlstm_state']:.2f} GB); launches {counts}")
        funcs = [f for k, fs in SPLIT_FUNCS.items() if k in kinds
                 for f in fs]
        if funcs:
            pre, split = prefill_split(cfg, funcs)
            log(f"{arch} prefill split (a second prefill, each call of "
                f"{', '.join(funcs)} synchronised and timed: {pre:.3f} s "
                f"against the served {stats['prefill_s']:.3f} s): "
                + "; ".join(f"{n} {f} calls {t:.3f} s ({t / n:.3f} s each, "
                            f"{100 * t / pre:.1f}%)"
                            for f, (t, n) in split.items()))
    free_cuda()
    log(f"launches on the serving path: {total}")
    return total, out


def prefill_split(cfg, funcs) -> tuple[float, dict]:
    """The served config's prefill once more, after the served run and
    outside its launch count, with each call of ``funcs`` (names in
    ``models/layers.py``) timed (``timed_calls``): its own seconds and
    {func: (seconds, calls)}.  The served prefill_s carries no such
    synchronisation."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import prefill

    split: dict = {}
    with torch.no_grad():
        params = serve.make_params(cfg, "cuda")
        prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, "cuda")
        with timed_calls(split, funcs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(cfg, params, prompts,
                                     max_len=SERVE_PROMPT + SERVE_GEN)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
    del params, prompts, logits, caches
    free_cuda()
    return total, split


@contextlib.contextmanager
def timed_calls(totals: dict, funcs):
    """For as long as the context lasts, add to ``totals[func]`` the
    host seconds (synchronised before and after) and the count of each
    call of the functions ``funcs`` of ``models/layers.py``, which the
    layers look up at each call, so a prefill's time splits by them."""
    import torch

    from repro_torch.models import layers
    originals = {f: getattr(layers, f) for f in funcs}

    def timed(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            t, n = totals.get(name, (0.0, 0))
            totals[name] = (t + time.perf_counter() - t0, n + 1)
            return out
        return call

    for f, fn in originals.items():
        setattr(layers, f, timed(f, fn))
    try:
        yield totals
    finally:
        for f, fn in originals.items():
            setattr(layers, f, fn)


def check_serving_vs_plain(served: dict) -> None:
    """The served prefill's last logits against the same prefill with
    the plain impls, same parameters and prompt, at full width."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import prefill

    for arch in SERVE_ARCHS:
        served_cfg = serve.serving_config(arch, reduced=False)
        cfg = served_cfg.replace(attn_impl="xla", rnn_impl="xla")
        control = None
        with torch.no_grad():
            params = serve.make_params(cfg, "cuda")
            prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT,
                                         "cuda")
            want, caches = prefill(cfg, params, prompts,
                                   max_len=SERVE_PROMPT + SERVE_GEN)
            want = want.float().cpu()
            del caches
            if arch in SERVE_REL_L2_DEEP:
                # the served path with a fault
                fault = WITNESS_CONTROLS[arch][0]
                control, caches = prefill(
                    FAULTS[fault](served_cfg), params, prompts,
                    max_len=SERVE_PROMPT + SERVE_GEN)
                control = control.float().cpu()
                del caches
            # the noise floor of bf16 through the whole depth: the plain
            # path again, its first norm's output scaled by 1 + 2^-8
            # (one bf16 ulp)
            slot0 = params["cycles"]["slot0"]
            first = slot0["ln1" if "ln1" in slot0 else "norm"]
            first[0].fill_(2.0 ** -8)
            bumped, caches = prefill(cfg, params, prompts,
                                     max_len=SERVE_PROMPT + SERVE_GEN)
            bumped = bumped.float().cpu()
        del params, caches
        free_cuda()
        got = served[arch]["stats"]["logits"]
        rel = float((got - want).norm() / want.norm())
        floor = float((bumped - want).norm() / want.norm())
        agree = int((got.argmax(-1) == want.argmax(-1)).sum())
        limit = SERVE_REL_L2_DEEP.get(arch, SERVE_REL_L2)
        log(f"{arch} full-width prefill, kernels vs plain: relative L2 of "
            f"the last logits {rel:.3e} (limit {limit:.3e}; a one-ulp "
            f"bump of the first layer's normed input moves the plain path "
            f"by {floor:.3e}); first greedy token equal in {agree} of "
            f"{SERVE_BATCH} rows")
        check(rel <= limit, f"{arch}: relative L2 {rel:.3e}")
        check(agree >= SERVE_TOKENS_AGREE,
              f"{arch}: first tokens agree in {agree} of {SERVE_BATCH}")
        if control is not None:
            bad = float((control - want).norm() / want.norm())
            log(f"{arch} control, the served path with "
                f"{WITNESS_CONTROLS[arch][0]}: relative L2 of the last "
                f"logits {bad:.3e} (must exceed {limit:.3e})")
            check(bad > limit, f"{arch}: the control's relative L2 "
                  f"{bad:.3e} is within the limit {limit:.3e}")
        if arch in WITNESS_CONTROLS:
            layer_witness(arch)


def _layer_params(cfg, params):
    """(kind, that layer's parameters) of each layer in order, cycles
    then tail, as ``model._run_layers`` walks them."""
    for c in range(cfg.n_cycles):
        for i, kind in enumerate(cfg.pattern):
            yield kind, {name: w[c] for name, w in
                         params["cycles"][f"slot{i}"].items()}
    for j, kind in enumerate(cfg.tail_kinds):
        yield kind, params["tail"][j]


def layer_witness(arch: str) -> None:
    """Each attention layer of ``arch`` at full width and depth, fed the
    plain path's hidden state of the served prompts: the output of its
    attention mix (q, k, v, the attention kernel, the output
    projection) through the served kernels against the plain version's,
    as a relative L2, held to LAYER_REL_L2.  The plain layer's output
    goes on to the next layer, so no layer inherits another's rounding,
    and a kernel's fault shows at the layer where it happens instead of
    in the last logits' gap, which depth drives to the bf16 floor.  Two
    controls, the served config with a fault (``WITNESS_CONTROLS``),
    must each move some layer past LAYER_REL_L2.  For a moe layer it
    also logs how many tokens' top-k expert sets differ between the
    served and the plain attention output (nothing is gated on it)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import layers, model
    from repro_torch.models.common import rms_norm

    cfg = serve.serving_config(arch, reduced=False)
    plain = cfg.replace(attn_impl="xla", rnn_impl="xla")
    variants = {"kernels": cfg}
    variants.update((name, FAULTS[name](cfg))
                    for name in WITNESS_CONTROLS[arch])
    gaps: dict = {name: [] for name in variants}
    kinds = []
    flips = []              # (layer, tokens whose top-k sets differ)

    def experts(lp, x, attn):
        """Each token's top-k experts, sorted, after ``attn`` joins the
        residual, as ``layers._apply_attn`` routes them."""
        if cfg.post_norm:
            attn = rms_norm(attn, lp["post_ln1"], cfg.norm_eps)
        h2 = rms_norm(x + attn, lp["ln2"], cfg.norm_eps)
        probs = torch.softmax(h2.reshape(-1, cfg.d_model).float()
                              @ lp["router"], dim=-1)
        return layers._top_k(probs, cfg.top_k)[1].sort(dim=-1).values

    with torch.no_grad():
        params = serve.make_params(cfg, "cuda")
        prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, "cuda")
        x = model._embed_inputs(plain, params, prompts)
        for kind, lp in _layer_params(cfg, params):
            kinds.append(kind)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)

            def mix(c):
                cache = layers.init_cache(c, kind, SERVE_BATCH, SERVE_PROMPT,
                                          device="cuda")
                return layers._attention_mix(c, kind, lp, h, "prefill",
                                             cache, None)[0]
            want = mix(plain)
            for name, c in variants.items():
                got = mix(c)
                gaps[name].append(float((got.float() - want.float()).norm()
                                        / want.float().norm()))
                if name == "kernels" and kind == "moe":
                    differ = (experts(lp, x, got) != experts(lp, x, want))
                    flips.append((len(kinds) - 1,
                                  int(differ.any(dim=-1).sum())))
                del got
            x = layers.apply_layer(plain, kind, lp, x, "prefill",
                                   layers.init_cache(plain, kind, SERVE_BATCH,
                                                     SERVE_PROMPT,
                                                     device="cuda"))[0]
    del params, prompts, x, h, want
    free_cuda()
    for name, g in gaps.items():
        by_kind = {k: max(v for v, kk in zip(g, kinds) if kk == k)
                   for k in sorted(set(kinds))}
        log(f"{arch} layer witness, {name}: the largest relative L2 of a "
            f"layer's attention output against the plain layer's "
            f"{max(g):.3e} (layer {g.index(max(g))} of {len(g)}; by kind: "
            + ", ".join(f"{k} {v:.3e}" for k, v in by_kind.items())
            + f"; limit {LAYER_REL_L2:.3e}); every layer: "
            + " ".join(f"{v:.2e}" for v in g))
    if flips:
        log(f"{arch} layer witness: tokens (of {SERVE_BATCH * SERVE_PROMPT}) "
            f"whose top-{cfg.top_k} expert set differs between the served "
            "and the plain attention output, by layer: "
            + " ".join(f"{i}:{n}" for i, n in flips)
            + f" (total {sum(n for _, n in flips)})")
    check(max(gaps["kernels"]) <= LAYER_REL_L2,
          f"{arch}: a layer's attention output through the kernels is "
          f"{max(gaps['kernels']):.3e} from the plain layer's")
    for name in variants:
        if name != "kernels":
            check(max(gaps[name]) > LAYER_REL_L2,
                  f"{arch}: the control '{name}' stays within "
                  f"LAYER_REL_L2 on every layer")


def _live_pairs(tq, tk, causal, window, q_offset, kv_offset) -> int:
    """(q, k) pairs the attention mask keeps, for these offsets."""
    import torch
    qp = q_offset + torch.arange(tq, dtype=torch.int64)
    lo = torch.full_like(qp, max(0, -kv_offset))
    if window is not None:
        lo = torch.maximum(lo, qp - window + 1 - kv_offset)
    hi = torch.full_like(qp, tk - 1)
    if causal:
        hi = torch.minimum(hi, qp - kv_offset)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def check_full_shapes_serving(counts: dict) -> list[dict]:
    """flash_attention at the serving path's shapes: compare with the
    plain version, time, bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    bf = torch.bfloat16
    b, t, cache = SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    pos = SERVE_PROMPT + 8
    # name, (b, hq, hkv, tq, tk, d, causal, window, softcap, q_off, kv_off)
    shapes = [
        ("gemma2 prefill global", (b, 8, 4, t, t, 256, True, None, 50.0,
                                   0, 0)),
        ("gemma2 prefill local", (b, 8, 4, t, t, 256, True, 4096, 50.0,
                                  0, 0)),
        ("gemma2 decode global", (b, 8, 4, 1, cache, 256, True, None, 50.0,
                                  pos, 0)),
        ("gemma2 decode local", (b, 8, 4, 1, 4096, 256, True, 4096, 50.0,
                                 pos, pos - 4095)),
        ("recurrentgemma prefill local", (b, 10, 1, t, t, 256, True, 2048,
                                          None, 0, 0)),
        ("gemma2 prefill global, softcap off", (b, 8, 4, t, t, 256, True,
                                                None, None, 0, 0)),
        ("gemma2 decode global, softcap off", (b, 8, 4, 1, cache, 256, True,
                                               None, None, pos, 0)),
        ("gemma2 decode local, softcap off", (b, 8, 4, 1, 4096, 256, True,
                                              4096, None, pos, pos - 4095)),
        ("recurrentgemma decode local", (b, 10, 1, 1, 2048, 256, True, 2048,
                                         None, pos, pos - 2047)),
        # gemma3-4b's global layers are gemma2's with the softcap off
        ("gemma3 prefill local", (b, 8, 4, t, t, 256, True, 1024, None, 0,
                                  0)),
        ("gemma3 decode local", (b, 8, 4, 1, 1024, 256, True, 1024, None,
                                 pos, pos - 1023)),
        # olmoe-1b-7b: MHA (group 1) at head dim 128, global, no softcap;
        # decode at the last step, over the whole cache
        ("olmoe prefill global", (b, 16, 16, t, t, 128, True, None, None, 0,
                                  0)),
        ("olmoe decode global, full cache", (b, 16, 16, 1, cache, 128, True,
                                             None, None, cache - 1, 0)),
    ]
    rows = []
    for label, case in shapes:
        q, k, v, kw = _attn_inputs(case, bf, gen)
        got = attention.flash_attention(q, k, v, **kw)
        want = ref.attention_qchunk(q, k, v, **kw)
        err = _close_err(got, want, BF16_TOL, BF16_TOL,
                         f"flash_attention {label}")
        del got, want
        ms = time_ms(lambda: attention.flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: ref.attention_qchunk(q, k, v, **kw),
                        runs=3)
        bq, hq, hkv, tq, tk, d = case[:6]
        pairs = _live_pairs(tq, tk, kw["causal"], kw["window"],
                            kw["q_offset"], kw["kv_offset"])
        ops = 4.0 * bq * hq * d * pairs
        live_k = pairs if tq == 1 else tk       # decode reads live keys
        nbytes = 2.0 * (2 * bq * hq * tq * d + 2 * bq * hkv * live_k * d)
        bound = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        lib = None
        if kw["softcap"] is None:
            # the one PyTorch call for the same function: SDPA, causal
            # where the offsets are 0 and no window, else with a boolean
            # mask of the live keys built outside the timed call
            mask = None
            if kw["window"] is not None or kw["q_offset"] or kw["kv_offset"]:
                mask = ref.attention_mask(tq, tk, causal=kw["causal"],
                                          window=kw["window"],
                                          q_offset=kw["q_offset"],
                                          kv_offset=kw["kv_offset"],
                                          device="cuda")

            def sdpa():
                if mask is None:
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            _close_err(sdpa(), attention.flash_attention(q, k, v, **kw),
                       BF16_TOL, BF16_TOL, f"SDPA {label}")
            lib = time_ms(sdpa)
        row = _row("flash_attention", "csrc/attention.cu",
                   "src/repro/kernels/attention.py:104", counts, err, ms,
                   plain, bound, lib)
        path = attention.route(bf, case[3], case[5])
        row["shape"] = f"{label}: {list(case)} bf16, {path}"
        rows.append(row)
        log(f"flash_attention {label} {list(case[:6])}, {path}: {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} TFLOP/s, bound {bound[0]:.3f} ms by "
            f"{bound[1]}); plain {plain:.3f} ms; library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}; max err "
            f"{err:.3e}")
        del q, k, v
        free_cuda()
    return rows


def check_full_shape_rglru(counts: dict) -> list[dict]:
    """rglru_scan at recurrentgemma-2b's prefill and decode shapes: each
    row's route, compare with the plain version, time back to back and
    on the device alone, bound."""
    import torch

    from repro_torch.kernels import ref, rglru
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    bf = torch.bfloat16
    b, t = SERVE_BATCH, SERVE_PROMPT
    rows = []
    for label, (bb, tt, d), with_h0 in (
            ("recurrentgemma prefill", (b, t, 2560), False),
            ("recurrentgemma decode", (b, 1, 2560), True)):
        path = rglru.route(tt, bf)
        x = torch.randn((bb, tt, d), generator=gen, device="cuda").to(bf)
        a = (0.9 + 0.099 * torch.rand((bb, tt, d), generator=gen,
                                      device="cuda")).to(bf)
        g = torch.rand((bb, tt, d), generator=gen, device="cuda").to(bf)
        h0 = (torch.randn((bb, d), generator=gen, device="cuda")
              if with_h0 else None)
        y, ht = rglru.rglru_scan(x, a, g, h0)
        yr, hr = ref.rglru(x, a, g, h0)
        err = max(_close_err(y, yr, BF16_TOL, BF16_TOL, f"rglru {label}"),
                  _close_err(ht, hr, RGLRU_TOL, RGLRU_TOL,
                             f"rglru {label} h_T"))
        ms = time_ms(lambda: rglru.rglru_scan(x, a, g, h0))
        plain = time_ms(lambda: ref.rglru(x, a, g, h0), runs=3)
        # the kernel's own device time, without the host's enqueue
        dev = device_ms_by_kernel(lambda: rglru.rglru_scan(x, a, g, h0),
                                  "rglru")
        dev_ms = sum(dev.values()) if dev else None
        n = bb * tt * d
        nbytes = 2.0 * 4 * n + 4.0 * bb * d * (2 if with_h0 else 1)
        bound = bound_ms(nbytes, 6.0 * n)
        row = _row("rglru_scan", "csrc/rglru.cu",
                   "src/repro/kernels/rglru.py:60", counts, err, ms, plain,
                   bound, None)
        row["shape"] = (f"{label}: ({bb}, {tt}, {d}) bf16"
                        + (", h0" if with_h0 else "") + f", {path}")
        row["device_ms"] = dev_ms
        rows.append(row)
        log(f"rglru_scan {label} ({bb}, {tt}, {d}), {path}: {ms:.4f} ms "
            f"back to back ({nbytes / ms / 1e6:.1f} GB/s, "
            f"{100 * bound[0] / ms:.1f}% of the bound {bound[0]:.4f} ms by "
            f"{bound[1]}); device "
            + ("not measured (no device time in the trace)" if dev is None
               or not dev else "; ".join(f"{k_} {v_:.4f} ms"
                                         for k_, v_ in dev.items()))
            + f" (torch.profiler, mean of 3 calls); plain {plain:.3f} ms; "
            f"no library call; max err {err:.3e}")
        del x, a, g, y, yr
        free_cuda()
    return rows


def check_full_shape_mlstm(counts: dict) -> list[dict]:
    """mlstm_chunkwise at xlstm-350m's prefill shape, as the layer calls
    it (transposed views of (B, T, H, dh) f32): compare with the plain
    version, time, bound."""
    import torch

    from repro_torch.kernels import mlstm, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    b, h, t, dh, chunk = SERVE_BATCH, 4, SERVE_PROMPT, 512, 128
    q, k, v, i, f = _mlstm_inputs(b, h, t, dh, 1.0, torch.float32, "bthd",
                                  gen)
    got = mlstm.mlstm_chunkwise(q, k, v, i, f, chunk=chunk)
    want = ref.mlstm_chunkwise(q, k, v, i, f, chunk=chunk)
    check(all(bool(torch.isfinite(x).all()) for x in got),
          "mlstm_chunkwise full shape: non-finite output")
    errs = {name: _close_err(g, w, MLSTM_TOL, MLSTM_TOL, f"mlstm full {name}")
            for name, g, w in zip(("h", "C", "n", "m"), got, want)}
    err = max(errs.values())
    del got, want
    ms = time_ms(lambda: mlstm.mlstm_chunkwise(q, k, v, i, f, chunk=chunk))
    plain = time_ms(lambda: ref.mlstm_chunkwise(q, k, v, i, f, chunk=chunk),
                    runs=3)
    # the function's own work per (b, h) and chunk of lc steps: C0 q and
    # the C update (2 lc dh^2 each), and the live (causal) triangle of
    # the scores and of P v (2 dh lc (lc + 1) / 2 each); the denominator
    # comes from the scores' row sums, so no W k product is counted
    lcs = [min(chunk, t - s) for s in range(0, t, chunk)]
    ops = b * h * sum(4.0 * lc * dh * dh + 2.0 * dh * lc * (lc + 1)
                      for lc in lcs)
    nbytes = 4.0 * (4 * b * h * t * dh + 2 * b * h * t
                    + b * h * (dh * dh + dh + 1))
    # the least time: the operations on the TF32 tensor cores; beside it
    # the f32 rate, the 3xTF32 split's own ceiling (three TF32 products
    # a product) and the bytes with H's f32 round trip between passes
    path = mlstm.route(q.dtype, dh, chunk)
    bound = bound_ms(nbytes, ops, TF32_OPS_PER_S)
    f32_ms = bound_ms(nbytes, ops)[0]
    split_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    rt_bytes = nbytes + 2 * 4.0 * b * h * t * dh
    row = _row("mlstm_chunkwise", "csrc/mlstm.cu",
               "src/repro/kernels/mlstm.py:102", counts, err, ms, plain,
               bound, None)
    row["shape"] = (f"xlstm-350m prefill: ({b}, {h}, {t}, {dh}) f32, chunk "
                    f"{chunk}, {path}")
    passes = device_ms_by_kernel(
        lambda: mlstm.mlstm_chunkwise(q, k, v, i, f, chunk=chunk), "mlstm")
    log("mlstm_chunkwise device time by kernel (torch.profiler, mean of 3 "
        "calls): " + ("; ".join(f"{name} {ms_:.3f} ms"
                                for name, ms_ in passes.items())
                      or "not measured (no device time in the trace)"))
    log(f"mlstm_chunkwise ({b}, {h}, {t}, {dh}) f32 chunk {chunk}, {path}: "
        f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of the function's "
        f"{ops / 1e9:.1f} GFLOP); bound {bound[0]:.3f} ms by {bound[1]} "
        f"on the TF32 tensor cores (f32 bound {f32_ms:.3f} ms, 3xTF32 "
        f"ceiling {split_ms:.3f} ms, bytes with H's round trip "
        f"{rt_bytes / 1e9:.3f} GB = {rt_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms); plain {plain:.3f} ms; no library call; max err {err:.3e} ("
        + ", ".join(f"{name} {e:.3e}" for name, e in errs.items()) + ")")
    del q, k, v, i, f
    free_cuda()
    return [row]


MOE_FFN_TOKENS = 2048


def check_full_moe_ffn() -> None:
    """One olmoe-1b-7b moe layer's FFN at full width (d 2048, 64
    experts of 1024, top 8, cf 1.25) on 2048 tokens in f32 (cap 320):
    ``_moe_ffn`` on the card against the CPU, the same weights, within
    rtol 1e-4 and atol 1e-5; the routing (each token's top-8 set) and
    the dropped assignments are logged."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("olmoe-1b-7b").replace(dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    names = ("router", "moe_gate", "moe_up", "moe_down")
    layer = layers.init_layer(cfg, "moe", gen, "cuda")
    p = {name: layer[name] for name in names}
    x = torch.randn((1, MOE_FFN_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    out, sets = {}, {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            pd = {name: w.to(dev) for name, w in p.items()}
            xd = x.to(dev)
            out[dev] = layers._moe_ffn(cfg, pd, xd).cpu()
            probs = torch.softmax(xd[0] @ pd["router"], dim=-1)
            sets[dev] = layers._top_k(probs, cfg.top_k)[1].sort(-1).values.cpu()
    cap = max(8, -(-math.ceil(MOE_FFN_TOKENS * cfg.top_k / cfg.n_experts
                              * cfg.capacity_factor) // 8) * 8)
    per_expert = torch.bincount(sets["cpu"].reshape(-1),
                                minlength=cfg.n_experts)
    dropped = int(torch.clamp(per_expert - cap, min=0).sum())
    differ = int((sets["cuda"] != sets["cpu"]).any(-1).sum())
    err = _close_err(out["cuda"], out["cpu"], 1e-5, 1e-4,
                     "full-width MoE FFN card vs CPU")
    log(f"full-width MoE FFN (olmoe layer: d {cfg.d_model}, "
        f"{cfg.n_experts} experts of {cfg.d_expert}, top {cfg.top_k}, cf "
        f"{cfg.capacity_factor}) on {MOE_FFN_TOKENS} tokens f32, cap {cap}:"
        f" card == CPU, max abs err {err:.3e} (rtol 1e-4, atol 1e-5); "
        f"top-{cfg.top_k} sets differing {differ} of {MOE_FFN_TOKENS}; "
        f"{dropped} of {MOE_FFN_TOKENS * cfg.top_k} assignments dropped")
    del layer, p, x
    free_cuda()


def check_small_serve_vs_cpu() -> None:
    """Reduced serving configs (the serving archs and granite-moe),
    prefill + 4 decode steps: the card (CUDA kernels) against the CPU
    (plain versions), same parameters."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import tree_map

    for arch in SERVE_ARCHS + ("granite-moe-1b-a400m",):
        cfg = serve.serving_config(arch, reduced=True)
        p_cpu = serve.make_params(cfg, "cpu")
        t = XLSTM_SMALL_PROMPT if "mlstm" in cfg.pattern else 40
        prompts = np.random.default_rng(4).integers(0, cfg.vocab,
                                                    size=(2, t))
        logits: dict = {}
        toks: list = []          # the CPU's greedy tokens, fed to both
        with torch.no_grad():
            for dev in ("cpu", "cuda"):
                params = tree_map(lambda x: x.to(dev, copy=True), p_cpu)
                lg, caches = prefill(cfg, params,
                                     torch.as_tensor(prompts, device=dev),
                                     max_len=t + 4)
                steps = [lg.cpu()]
                for i in range(4):
                    if dev == "cpu":
                        toks.append(torch.argmax(steps[-1], -1))
                    lg, caches = decode_step(cfg, params, caches,
                                             toks[i].to(dev), t + i)
                    steps.append(lg.cpu())
                logits[dev] = steps
        err = 0.0
        for c, g in zip(logits["cpu"], logits["cuda"]):
            err = max(err, _close_err(g, c, 1e-5, 1e-4,
                                      f"reduced {arch} card vs CPU"))
        log(f"reduced {arch} prompt {t} prefill + 4 decode steps: card == "
            f"CPU, max abs err {err:.3e} (rtol 1e-4, atol 1e-5)")


def check_small_step_vs_cpu() -> None:
    """Reduced qwen3 and granite-moe, 2 compressed steps with P = 3: the
    card (CUDA kernels) against the CPU (plain versions) from the same
    parameters, losses within rtol 1e-4."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.fl_step import make_fl_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant_lr
    from repro_torch.tree import tree_map

    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        cfg = get_config(arch, reduced=True)
        gen = torch.Generator()
        gen.manual_seed(3)
        p_cpu = init_params(cfg, gen)
        runs = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
            opt = adamw_init(params)
            step = make_fl_train_step(cfg, lr_schedule=constant_lr(1e-3),
                                      n_pods=3, compress=True)
            rng = np.random.default_rng(3)
            w = torch.tensor([1.0, 2.0, 3.0])
            a = torch.tensor([1.0, 0.0, 1.0])
            losses = []
            for _ in range(2):
                batch = synthetic_batch(rng, 3, 2, 32, cfg.vocab, device=dev)
                params, opt, m = step(params, opt, batch, w, a)
                losses.append(float(m["loss"]))
            runs[dev] = losses
        for lc, lg in zip(runs["cpu"], runs["cuda"]):
            check(math.isfinite(lg) and abs(lc - lg) <= 1e-4 * abs(lc),
                  f"reduced {arch} step on the card {runs['cuda']} vs CPU "
                  f"{runs['cpu']}")
        log(f"reduced {arch} P=3 compressed steps: card {runs['cuda']} == "
            f"CPU {runs['cpu']} (rtol 1e-4)")


# ----------------------------------------------------------------------
# the swarm: the FLTorrent round on the host, its data plane on the card
# ----------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "golden_schedules.json"
GOLDEN_MODES = ("random_fifo", "random_fastest_first",
                "greedy_fastest_first", "distributed", "flooding")
# the jit digests follow jax.random's stream, which the port does not
# draw (its jit engine's noise bases come from a torch.Generator)
GOLDEN_IMPLS = ("batched", "loop")
GOLDEN_SEEDS = (1, 9)
# the columns of a transfer log that tests/capture_golden.py digests
LOG_KEYS = ("slot", "sender", "receiver", "chunk", "owner", "b_size",
            "o_size", "phase")
# the scaling point of benchmarks/bench_scheduler.py: n 500, K 206
# (GoogLeNet's chunking), greedy fastest first on the batched engine,
# k_term 1030 chunks a client, every warm-up defence on
PAPER_N, PAPER_K = 500, 206
ATTACK_OBSERVERS = 6
# the data plane: 16 peers' updates of xlstm-350m at full width, cut
# into 4 MiB pieces (the last one padded)
SWARM_ARCH = "xlstm-350m"
SWARM_D = 565_215_232           # xlstm-350m parameter count
SWARM_PEERS = 16
SWARM_CHUNK_BYTES = 4 << 20
SWARM_K = 540
# the rounds' deadlines (None: the default, which never binds) and how
# many (v, u) pairs each leaves reconstructable
SWARM_DEADLINES = ((30, 46), (None, 256))
SWARM_SLICE_COLS = 1 << 25      # plain fedavg on (16, 2^25) f32: 2.1 GB
SWARM_VERIFY_PIECES = 8


def log_digest(log) -> str:
    """tests/capture_golden.py's sha256 over a transfer log's columns."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for key in LOG_KEYS:
        arr = np.ascontiguousarray(np.asarray(log[key], dtype=np.int64))
        h.update(key.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def check_swarm_goldens() -> None:
    """The port's ``simulate_round`` replays every loop and batched
    schedule of tests/golden_schedules.json (5 policies x 2 engines x
    seeds 1 and 9; n 16, K 24) to the same digest, and its attacks give
    the file's exact ASR numbers (all defences on and all off, seeds 0
    and 1; loop engine, n 24)."""
    import numpy as np

    from repro_torch.core import SwarmConfig, simulate_round
    from repro_torch.core.attacks import run_all_attacks

    golden = json.loads(GOLDEN.read_text())
    t0 = time.perf_counter()
    for mode in GOLDEN_MODES:
        for impl in GOLDEN_IMPLS:
            for seed in GOLDEN_SEEDS:
                cfg = SwarmConfig(n=16, chunks_per_update=24, s_max=5000,
                                  seed=seed, scheduler=mode,
                                  scheduler_impl=impl)
                key = f"{mode}/{impl}/{seed}"
                got = log_digest(simulate_round(cfg).log)
                check(got == golden["schedules"][key],
                      f"golden schedule {key}: digest {got} != "
                      f"{golden['schedules'][key]}")
    t_sched = time.perf_counter() - t0
    ablations = {"full": {},
                 "none": dict(enable_preround=False, enable_timelag=False,
                              enable_gating=False,
                              enable_nonowner_first=False)}
    for name, kw in ablations.items():
        for seed in (0, 1):
            cfg = SwarmConfig(n=24, chunks_per_update=24, s_max=5000,
                              seed=seed, scheduler_impl="loop", **kw)
            res = simulate_round(cfg)
            reps = run_all_attacks(res.log, np.arange(6), 24)
            pooled = run_all_attacks(res.log, np.arange(12), 24,
                                     pooled=True)
            got = {a: {"max": reps[a].max_asr, "mean": reps[a].mean_asr,
                       "n": reps[a].n_decisions,
                       "pooled_max": pooled[a].max_asr,
                       "pooled_any": pooled[a].any_correct_rate}
                   for a in reps}
            key = f"{name}/{seed}"
            check(got == golden["attacks"][key],
                  f"golden attacks {key}: {got} != {golden['attacks'][key]}")
    n_sched = len(GOLDEN_MODES) * len(GOLDEN_IMPLS) * len(GOLDEN_SEEDS)
    log(f"swarm goldens: {n_sched} loop and batched schedule digests and "
        f"{2 * len(ablations)} attack sets equal to "
        f"tests/golden_schedules.json; host {time.perf_counter() - t0:.2f}"
        f" s ({t_sched:.2f} s the schedules)")


def replay_legality(cfg, res, check_tau: bool) -> None:
    """The rules of tests/test_scheduler_equivalence.py::_replay_legality:
    replay the log slot by slot against reconstructed inventories; every
    sender holds what it sends, no receiver gets a chunk twice, and
    outside the spray every slot keeps the uplink and downlink budgets,
    the overlay's adjacency and (``check_tau``) tau concurrency."""
    from collections import Counter

    import numpy as np
    n, K = cfg.n, cfg.chunks_per_update
    log = res.log
    have = np.zeros((n, cfg.total_chunks), dtype=bool)
    for v in range(n):
        have[v, v * K:(v + 1) * K] = True
    # spray (phase 0) applies before warm-up slot 0
    key = log["slot"].astype(np.int64) * 4 + log["phase"]
    order = np.argsort(key, kind="stable")
    snd = log["sender"][order]
    rcv = log["receiver"][order]
    chk = log["chunk"][order]
    ph = log["phase"][order]
    key = key[order]
    for s in np.unique(key):
        sl = key == s
        check(bool(have[snd[sl], chk[sl]].all()), "sender missing chunk")
        check(not have[rcv[sl], chk[sl]].any(), "duplicate delivery")
        have[rcv[sl], chk[sl]] = True
        if (ph[sl] == 0).any():
            continue                    # spray is tracker-tunnelled
        check(bool((np.bincount(snd[sl], minlength=n) <= res.up).all()),
              "uplink budget exceeded")
        check(bool((np.bincount(rcv[sl], minlength=n) <= res.down).all()),
              "downlink budget exceeded")
        check(bool(res.adj[snd[sl], rcv[sl]].all()), "non-adjacent transfer")
        if check_tau:
            pairs = set(zip(snd[sl].tolist(), rcv[sl].tolist()))
            per_sender = Counter(u for u, _ in pairs)
            check(max(per_sender.values(), default=0)
                  <= cfg.tau_concurrent, "tau concurrency exceeded")


def run_swarm_paper_scale() -> None:
    """One round at the paper's scale on the host (``PAPER_N`` peers,
    ``PAPER_K`` chunks each, spray, lags, gating, non-owner-first
    warm-up, then BitTorrent, here the fluid engine, which ``bt_mode``
    "auto" picks at this size): every update reconstructable, no
    failed-open warm-up, Eq. 1 on every warm-up transfer, the log
    legal; logs the round's metrics, the three attacks' ASR from
    ``ATTACK_OBSERVERS`` observers against 1/m, and the host seconds."""
    import numpy as np

    from repro_torch.core import SwarmConfig, privacy
    from repro_torch.core.attacks import run_all_attacks
    from repro_torch.core.simulator import RoundSimulator, measured_clock

    cfg = SwarmConfig(n=PAPER_N, chunks_per_update=PAPER_K, s_max=100_000,
                      seed=0, scheduler="greedy_fastest_first",
                      scheduler_impl="batched",
                      warmup_threshold_pct=5.0 / PAPER_N, cand_cap=8192)
    t0 = time.perf_counter()
    with measured_clock():
        res = RoundSimulator(cfg).run()
    host_s = time.perf_counter() - t0
    m = res.metrics
    check(bool(res.reconstructable.all()),
          f"n={PAPER_N}: {int((~res.reconstructable).sum())} (v, u) pairs "
          "not reconstructable")
    check(not m.failed_open, f"n={PAPER_N}: the warm-up failed open")
    check(privacy.check_eq1(res.log, cfg.owner_throttle, cfg.k_gate),
          f"n={PAPER_N}: a warm-up transfer breaks Eq. 1")
    t1 = time.perf_counter()
    replay_legality(cfg, res, check_tau=True)
    reps = run_all_attacks(res.log, np.arange(ATTACK_OBSERVERS), PAPER_K)
    check_s = time.perf_counter() - t1
    phases = ", ".join(f"{k[:-2]} {v:.2f}" for k, v in res.timings.items())
    log(f"swarm n={PAPER_N} K={PAPER_K} {cfg.scheduler} batched, bt "
        f"{'fluid' if res.fluid_bt else 'exact'}: t_warm {m.t_warm}, "
        f"t_round {m.t_round}, warm-up share {m.warmup_share:.4f}, warm-up "
        f"utilisation {m.warmup_utilization:.4f}, {len(res.log['slot'])} "
        f"logged transfers; Eq. 1 holds, log legal, all reconstructable; "
        "ASR (max / mean / decisions) "
        + "; ".join(f"{a} {r.max_asr:.4f} / {r.mean_asr:.4f} / "
                    f"{r.n_decisions}" for a, r in reps.items())
        + f" against 1/m = {1 / cfg.min_degree:.4f}; host {host_s:.2f} s "
        f"({phases} s), checks {check_s:.2f} s")


def run_swarm_path(reduced: bool = False) -> tuple[dict, list[dict]]:
    """The round's data plane at full width (``reduced``: the reduced
    config on the CPU, a rehearsal with the plain versions).

    Peer 0's update is an xlstm-350m parameter tree made from a seed,
    flattened and packed into one (16, K, C/4) f32 buffer beside 15
    peers' seeded noise.  Peer 0's descriptor is hashed on the host,
    accepts ``SWARM_VERIFY_PIECES`` pieces and rejects one with a
    flipped bit, and reassembling its pieces gives its tree back
    exactly.  Then, the launch counters set to 0, two rounds of the
    16-peer swarm (``DATACENTER`` links, the exact BitTorrent engine,
    the deadlines of ``SWARM_DEADLINES``) and each peer's FedAvg over
    its own A_v through ``fedavg_flat(use_kernel=True)``; each
    aggregate is held against the plain version on column slices, and
    at the deadline that never binds every peer's equals peer 0's bit
    for bit (``agreement_check``, atol 0).  Returns the launch counts
    and the kernels-line row of ``fedavg_reduce`` at this shape."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SwarmConfig, capacities, chunking
    from repro_torch.core import simulate_round
    from repro_torch.core.aggregation import agreement_check, fedavg_flat
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import param_count
    from repro_torch.tree import leaves

    dev = torch.device("cpu" if reduced else "cuda")
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SWARM_ARCH, reduced=reduced)
    chunk_bytes = 4096 if reduced else SWARM_CHUNK_BYTES
    params = serve.make_params(cfg, dev)
    d = param_count(params)
    check(reduced or d == SWARM_D, f"{SWARM_ARCH} has {d} params, not "
          f"{SWARM_D}")
    flat, spec = chunking.flatten_update(params)
    buf = chunking.alloc_chunks(SWARM_PEERS, d, chunk_bytes, dev)
    k = buf.shape[1]
    check(reduced or k == SWARM_K, f"{k} pieces, not {SWARM_K}")
    chunking.pack_chunks(flat, chunk_bytes, out=buf[0])
    del flat
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    for v in range(1, SWARM_PEERS):
        buf[v].view(-1)[:d].normal_(generator=gen)
    rng = np.random.default_rng(18)
    weights = rng.integers(1, 1000, SWARM_PEERS).astype(np.float64)
    sync()

    # peer 0's descriptor, piece checks and reassembly
    t0 = time.perf_counter()
    desc = chunking.TorrentDescriptor.build(buf[0], weights[0])
    hash_s = time.perf_counter() - t0
    check(desc.num_chunks == k and desc.chunk_bytes == chunk_bytes,
          f"descriptor of {desc.num_chunks} x {desc.chunk_bytes} bytes")
    picks = [k - 1] + sorted(rng.choice(k - 1, SWARM_VERIFY_PIECES - 1,
                                        replace=False).tolist())
    for i in picks:
        check(desc.verify_chunk(i, buf[0, i]),
              f"descriptor rejects peer 0's piece {i}")
    bad = buf[0, picks[1]].to("cpu", copy=True)
    word = bad.view(torch.int32)
    word[12345 % word.numel()] ^= 1 << 3
    check(not desc.verify_chunk(picks[1], bad),
          f"descriptor accepts piece {picks[1]} with a flipped bit")
    back = chunking.reassemble_update(buf[0], (spec, d))
    for a, b in zip(leaves(back), leaves(params), strict=True):
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b), "reassembled leaf differs: "
              f"{a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
    n_leaves = len(leaves(params))
    dtypes = sorted({str(t.dtype) for t in leaves(params)})
    del back, params
    log(f"swarm data plane: {SWARM_PEERS} peers x ({k}, {buf.shape[2]}) "
        f"f32 pieces ({buf.numel() * 4 / 1e9:.2f} GB), peer 0 = "
        f"{SWARM_ARCH} (D = {d}, {n_leaves} leaves, {dtypes}); peer 0's "
        f"descriptor {desc.desc_id} hashed in {hash_s:.2f} s on the host "
        f"({d * 4 / 1e9 / hash_s:.2f} GB/s with the copy), "
        f"{SWARM_VERIFY_PIECES} pieces accepted, a flipped bit rejected; "
        f"reassembly exact, leaf by leaf and dtype by dtype")

    # the main path: two rounds, each peer's FedAvg over its own A_v
    flat2d = buf.view(SWARM_PEERS, -1)
    cols = [slice(c, c + SWARM_SLICE_COLS)
            for c in range(0, flat2d.shape[1], SWARM_SLICE_COLS)]
    w_dev = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    reset_launches()
    for s_max, pairs in SWARM_DEADLINES:
        kw = {} if s_max is None else {"s_max": s_max}
        scfg = SwarmConfig(n=SWARM_PEERS, chunks_per_update=k,
                           chunk_bytes=chunk_bytes, seed=0, min_degree=10,
                           **kw)
        t0 = time.perf_counter()
        res = simulate_round(scfg, link_model=capacities.DATACENTER,
                             bt_mode="exact")
        round_s = time.perf_counter() - t0
        recon = res.reconstructable
        check(reduced or int(recon.sum()) == pairs,
              f"s_max {s_max}: {int(recon.sum())} reconstructable pairs, "
              f"not {pairs}")
        check(bool(np.diag(recon).all()),
              f"s_max {s_max}: a peer cannot rebuild its own update")
        agg_s, err, first = 0.0, 0.0, None
        for v in range(SWARM_PEERS):
            sync()
            t0 = time.perf_counter()
            agg = fedavg_flat(flat2d, weights, recon[v], use_kernel=True)
            sync()
            agg_s += time.perf_counter() - t0
            a_dev = torch.as_tensor(recon[v], dtype=torch.float32,
                                    device=dev)
            for c in cols:
                err = max(err, _close_err(
                    agg[c], ref.fedavg_reduce(flat2d[:, c], w_dev, a_dev),
                    FEDAVG_TOL, FEDAVG_TOL,
                    f"swarm peer {v} FedAvg over A_v (s_max {s_max})"))
            if s_max is None:
                if first is None:
                    first = agg
                else:
                    check(agreement_check([first, agg], atol=0.0),
                          f"peer {v}'s aggregate differs from peer 0's at "
                          "the deadline that never binds")
            del agg
        del first
        log(f"swarm round n={SWARM_PEERS} K={k} DATACENTER exact, s_max "
            f"{s_max or scfg.s_max}: t_warm {res.metrics.t_warm}, t_round "
            f"{res.metrics.t_round}, {int(recon.sum())} of "
            f"{SWARM_PEERS ** 2} pairs reconstructable, "
            f"{len(np.unique(recon, axis=0))} distinct A_v; host "
            f"{round_s:.3f} s; {SWARM_PEERS} per-peer FedAvg "
            f"{agg_s:.3f} s, max err against the plain version "
            f"{err:.3e}" + ("; all 16 aggregates bit-identical"
                             if s_max is None else ""))
    counts = dict(LAUNCHES)
    if cuda:
        check(counts.get("fedavg_reduce", 0) == 2 * SWARM_PEERS,
              f"fedavg_reduce launched {counts.get('fedavg_reduce', 0)} "
              f"times on the swarm path, not {2 * SWARM_PEERS}: {counts}")
    log(f"launches on the swarm path: {counts}")
    rows = []
    if cuda:
        rows.append(fedavg_row(flat2d, w_dev,
                               torch.ones(SWARM_PEERS, device=dev), counts,
                               "swarm, all rows", SWARM_SLICE_COLS))
        log(f"swarm peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            " GB")
    del buf, flat2d
    if cuda:
        free_cuda()
    return counts, rows


def fedavg_row(u, w, a, counts, label, cols_width) -> dict:
    """``fedavg_reduce`` over the (n, D) f32 rows ``u``: compare, time,
    bound.  The plain version runs column slice by column slice of
    ``cols_width`` (it is separable over D), so that its (n, D)
    temporaries stay small beside ``u``."""
    import torch

    from repro_torch.kernels import fedavg, ref
    n, d = u.shape
    cols = [slice(c, c + cols_width) for c in range(0, d, cols_width)]
    got = fedavg.fedavg_reduce(u, w, a)
    err = 0.0
    for c in cols:
        err = max(err, _close_err(got[c], ref.fedavg_reduce(u[:, c], w, a),
                                  FEDAVG_TOL, FEDAVG_TOL,
                                  f"fedavg full {label}"))
    del got

    def plain_fedavg():
        for c in cols:
            ref.fedavg_reduce(u[:, c], w, a)

    wn = ref.masked_normalized_weights(w, a)
    ms = time_ms(lambda: fedavg.fedavg_reduce(u, w, a))
    plain = time_ms(plain_fedavg, runs=3)
    lib = time_ms(lambda: torch.matmul(wn, u))
    nbytes = 4.0 * n * d + 4.0 * d
    ops = 2.0 * n * d                      # a multiply-add per value
    bound = bound_ms(nbytes, ops)
    row = _row("fedavg_reduce", "csrc/fedavg.cu",
               "src/repro/kernels/fedavg.py:60", counts, err, ms, plain,
               bound, lib)
    row["shape"] = f"{label}: ({n}, {d}) f32"
    log(f"fedavg_reduce {label} ({n}, {d}) f32: {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s ({100 * bound[0] / ms:.1f}% of HBM "
        f"peak, bound {bound[0]:.3f} ms); plain {plain:.3f} ms; wn @ "
        f"updates {lib:.3f} ms; max err {err:.3e}")
    return row


# ----------------------------------------------------------------------
# the GPU slot engine (repro_torch.core.jit_engine): scheduler_impl="jit"
# ----------------------------------------------------------------------

# benchmarks/bench_scheduler.py's configurations: the scaling sweep's
# points (_sweep_cfg: K 206, GFF, k_term 1030 chunks a client at every
# n, cand_cap 8192, warm-up only) and the headline round (n 100, K 64,
# s_max 100,000, exact BitTorrent); tests/test_scheduler_equivalence.py's
# jit session twin (n 20, K 16, churn 0.1, two rounds).
SLOT_K = 206
SLOT_CAP = 8192
SLOT_NS = (500, 5000)           # the sweep's bottom and top
SLOT_CAPTURE_AT = 20            # the slot whose kernel inputs are kept
SLOT_KERNELS = ("slot_planes", "slot_rounds", "overlap_rank",
                "extract_ranked")
# the kernels a slot launches, once each; the other two run
# slot_rounds' row bodies alone and are off the path since it fused them
SLOT_PATH_KERNELS = ("slot_planes", "slot_rounds")
SLOT_LINES = {"slot_planes": "src/repro/core/jit_engine.py:358",
              "slot_rounds": "src/repro/core/jit_engine.py:559",
              "overlap_rank": "src/repro/core/jit_engine.py:462",
              "extract_ranked": "src/repro/core/jit_engine.py:273"}
SLOT_PROFILED_SLOTS = 1         # slot replays traced by torch.profiler


def sweep_cfg(n: int, impl: str):
    """bench_scheduler.py::_sweep_cfg."""
    from repro_torch.core import SwarmConfig
    return SwarmConfig(n=n, chunks_per_update=SLOT_K, s_max=100_000, seed=0,
                       scheduler="greedy_fastest_first", scheduler_impl=impl,
                       warmup_threshold_pct=5.0 / n, cand_cap=SLOT_CAP)


def _clone_args(args):
    import torch
    out = []
    for a in args:
        if torch.is_tensor(a):
            a = a.clone()
        elif isinstance(a, tuple):
            a = tuple(b.clone() for b in a)
        out.append(a)
    return out


@contextlib.contextmanager
def capture_slot(at: int):
    """Keep (clones of) the arguments of ``_slot_rounds``'s call number
    ``at`` (0-based) in the yielded dict's ``"args"``."""
    from repro_torch.core import jit_engine as je
    orig = je._slot_rounds
    held = {"calls": 0, "args": None}

    def wrapped(*args, **kw):
        if held["calls"] == at:
            held["args"] = _clone_args(args)
        held["calls"] += 1
        return orig(*args, **kw)

    je._slot_rounds = wrapped
    try:
        yield held
    finally:
        je._slot_rounds = orig


def capture_kernel_inputs(slot_args) -> dict:
    """Replay a captured slot on the card with the path's wrappers
    (``slot_planes``, ``slot_rounds``) keeping (clones of) the inputs of
    their call, then through the plain loop (``impl="torch"``) with the
    plain versions of the two row bodies keeping those of their first
    call (the slot's first grant round), for ``overlap_rank`` and
    ``extract_ranked``, which the path no longer launches."""
    from repro_torch.core import jit_engine as je
    from repro_torch.kernels import slots
    got = {}
    hooks = {"slot_planes": "slot_planes", "slot_rounds": "slot_rounds",
             "overlap_rank": "overlap_rank_plain",
             "extract_ranked": "extract_ranked_plain"}
    orig = {name: getattr(slots, attr) for name, attr in hooks.items()}

    def recorder(name):
        def f(*a, **kw):
            if name not in got:
                got[name] = (_clone_args(a), dict(kw))
            return orig[name](*a, **kw)
        return f

    for name, attr in hooks.items():
        setattr(slots, attr, recorder(name))
    try:
        je._slot_rounds(*slot_args)
        je._slot_rounds(*slot_args, impl="torch")
    finally:
        for name, attr in hooks.items():
            setattr(slots, attr, orig[name])
    check(set(got) == set(SLOT_KERNELS), f"slot kernels not called: {got}")
    return got


# slot_planes on slot 20 over the row-major inventory it replaced, for
# the log line only: that kernel's wrapper back to back (ms, this
# script's run on an NVIDIA H100 80GB HBM3 at 700 W)
ROW_MAJOR_PLANES_MS = {"n 500": 0.0585, "n 5000": 1.0138}
# bytes that pass between two reads of one copy of slot_planes' inputs
# when its device time is taken: twice the H100's 50 MB L2, so the
# candidates' have_t rows come from HBM, as on the path
COLD_BYTES = 100e6
GRAPH_CALLS = 50                # slot_planes calls a timed graph holds


def _planes_bytes(a, outs) -> dict:
    """Bytes of stage 1 on these inputs: ``"bound"``, its own (the
    candidates' chunk-major rows, the ``ceil(n / 32)`` words that hold
    peers below n; cand, owner and allowed once; recv_ok; the outputs),
    and, for the row-major inventory it replaced, ``"row_words"`` (each
    receiver's inventory words that hold a candidate) and
    ``"row_sectors"`` (the 32-byte sectors those words lie in, what the
    card moves: no kernel over that layout reads less)."""
    import torch
    have_t, cand, owner, allowed, recv_ok, m_cnt = a
    n = recv_ok.shape[0]
    real = cand[:m_cnt].long()
    rows = torch.unique(real).numel()
    rest = cand.numel() * 9.0 + n + sum(
        t.numel() * t.element_size() for t in outs if t is not None)
    return {"bound": rows * -(-n // 32) * 4.0 + rest,
            "row_words": n * torch.unique(real >> 5).numel() * 4.0 + rest,
            "row_sectors": n * torch.unique(real >> 8).numel() * 32.0
            + rest}


def _rank_bytes(a, sbc) -> float:
    import torch
    plane_a, plane_b, need, u_c = a
    n, w = need.shape
    rows = torch.unique(u_c).numel()
    planes = 1 if plane_b is None else 2
    return (need.numel() * 4.0 + planes * rows * w * 4.0 + u_c.numel() * 8.0
            + sbc.numel() * 4.0 + n * 4.0)


def _extract_bytes(a, cols) -> float:
    import torch
    plane_a, plane_b, need, u_c, take, t_a, sbc, t_cap = a
    n, w = need.shape
    granted = take > 0
    g = int(granted.sum())
    senders = torch.unique(u_c[granted]).numel()
    planes = 1 if plane_b is None else 2
    return (g * w * 4.0 + planes * senders * w * 4.0 + n * 16.0
            + g * sbc.shape[1] * 4.0 + cols.numel() * 4.0
            + float(take.sum()) * 4.0)


def _rounds_bytes(a, outs) -> float:
    """slot_rounds' inputs read once (the planes, counts and budgets, the
    neighbor lists both ways, the bases) and its grids written once."""
    import torch
    ins = [t for t in a[:9] if torch.is_tensor(t)] + list(a[9])
    return float(sum(t.numel() * t.element_size() for t in (*ins, *outs)))


def slot_kernel_rows(inputs: dict, counts: dict, slots_run: int,
                     label: str) -> list[dict]:
    """Each slot kernel on its captured inputs: on the card against its
    plain version on the card (exact integer equality), timed with CUDA
    events beside the plain version, and its bound (bytes: inputs read
    once, outputs written once; the candidates' rows of the chunk-major
    inventory, the plane rows of this round's senders, the need rows of
    this round's grants).  ``slot_planes``' time is a CUDA graph's
    over copies of ``have_t`` that leave L2 cold (``planes_cold_ms``),
    beside its wrapper's back-to-back time and the row-major layout's
    bounds.  extract_ranked clears
    ``need`` in place, so each timed call runs on its own fresh copy,
    made before the timing starts (``time_fresh_ms``)."""
    import torch

    from repro_torch.kernels import slots
    rows = []
    for name in SLOT_KERNELS:
        a, kw = inputs[name]
        kw = {k: v for k, v in kw.items() if k != "impl"}
        fn = getattr(slots, name)
        if name == "extract_ranked":
            need0 = a[2]
            buf = torch.empty_like(need0)

            def run(impl, fn=fn, a=a, kw=kw, need0=need0, buf=buf):
                buf.copy_(need0)
                return fn(*a[:2], buf, *a[3:], **kw, impl=impl)
            got = (run("cuda"), buf.clone())
            want = (run("torch"), buf.clone())
        else:
            def run(impl, fn=fn, a=a, kw=kw):
                out = fn(*a, **kw, impl=impl)
                return out if isinstance(out, tuple) else (out,)
            got, want = run("cuda"), run("torch")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check((g is None) == (w is None),
                  f"{name} {label}: a plane is missing on one side")
            if g is not None:
                check(torch.equal(g, w),
                      f"{name} {label}: the kernel differs from its plain "
                      f"version ({int((g != w).sum())} of {g.numel()} "
                      "elements)")
        if name == "extract_ranked":
            def on(b, impl, fn=fn, a=a, kw=kw):
                fn(*a[:2], b, *a[3:], **kw, impl=impl)
            ms = time_fresh_ms(lambda b: on(b, "cuda"), need0)
            plain = time_fresh_ms(lambda b: on(b, "torch"), need0, runs=3)
            nbytes = _extract_bytes(a, got[0])
        elif name == "slot_rounds":
            ms = time_ms(lambda: fn(*a, **kw, impl="cuda"))
            plain = time_ms(lambda: fn(*a, **kw, impl="torch"), runs=3)
            nbytes = _rounds_bytes(a, got)
        elif name == "slot_planes":
            # shorter than the wrapper's enqueue: the device time is a
            # CUDA graph's, the back-to-back one kept
            wrapper_ms = time_ms(lambda: run("cuda"))
            planes_bytes = _planes_bytes(a, got)
            nbytes = planes_bytes["bound"]
            ms, copies = planes_cold_ms(a, kw, nbytes)
            plain = time_ms(lambda: run("torch"), runs=3)
        else:
            ms = time_ms(lambda: run("cuda"))
            plain = time_ms(lambda: run("torch"), runs=3)
            nbytes = _rank_bytes(a, got[0])
        bound = bound_ms(nbytes)
        row = _row(name, "csrc/slots.cu", SLOT_LINES[name], counts, 0.0, ms,
                   plain, bound, None)
        row["launches_per_slot"] = counts.get(name, 0) / max(slots_run, 1)
        row["on_path"] = name in SLOT_PATH_KERNELS
        row["library"] = "none (no PyTorch popcount op)"
        width = (a[1].shape[0] // 32 if name == "slot_planes"
                 else a[2].shape[1])
        rows_n = a[4].shape[0] if name == "slot_planes" else a[0].shape[0]
        row["shape"] = f"{label}: planes ({rows_n}, {width}) words"
        extra = ""
        if name == "slot_planes":
            wb = min(slots.PLANE_WORDS, width)
            word_bound = bound_ms(planes_bytes["row_words"])[0]
            floor = bound_ms(planes_bytes["row_sectors"])[0]
            row.update(wrapper_ms=wrapper_ms, words_per_cta=wb,
                       have_t_copies=copies,
                       row_major_word_bound_ms=word_bound,
                       row_major_sector_floor_ms=floor)
            row["ptxas"] = next(
                (v for (src, f), v in PTXAS.items()
                 if f"slot_planes_kernelILi{wb}E" in f), None)
            extra = (f"; device time over {copies} copies of have_t "
                     f"{tuple(a[0].shape)} words (L2 cold), the wrapper back"
                     f" to back {wrapper_ms:.4f} ms (inputs warm); {wb} "
                     f"words a CTA; over the row-major inventory: "
                     f"{ROW_MAJOR_PLANES_MS.get(label)} ms back to back on "
                     f"an H100 at 700 W, word bound {word_bound:.4f} ms, "
                     f"sector floor {floor:.4f} ms; ptxas {row['ptxas']}")
        elif name == "slot_rounds":
            from repro_torch.kernels import _build
            row["rounds"] = int(got[2][0])
            row["grid_ctas"] = _build.extension().slot_rounds_grid(
                a[2], a[2].shape[0])
            row["ptxas"] = next((v for (src, f), v in PTXAS.items()
                                 if "slot_rounds_kernel" in f), None)
            extra = (f", {row['rounds']} rounds, {row['grid_ctas']} CTAs "
                     f"of 256 threads, ptxas {row['ptxas']}")
        elif not row["on_path"]:
            extra = ", off the path (fused into slot_rounds)"
        rows.append(row)
        log(f"{name} {label}: {ms:.4f} ms against a bound of "
            f"{bound[0]:.4f} ms ({bound[1]}, {100 * bound[0] / ms:.1f}%), "
            f"plain {plain:.4f} ms, library none (no PyTorch popcount op); "
            f"{counts.get(name, 0)} launches, "
            f"{row['launches_per_slot']:.2f} a slot{extra}; equal to the "
            "plain version")
    return rows


def planes_cold_ms(a, kw, nbytes: float) -> tuple[float, int]:
    """``slot_planes``' device time on its captured inputs (``graph_ms``)
    with call i reading copy i % k of ``have_t``, k the fewest copies
    (at least 3, at most the graph's calls) between whose reads
    ``COLD_BYTES`` pass, a call moving ``nbytes``; and k."""
    import math

    from repro_torch.kernels import slots
    k = min(max(3, math.ceil(COLD_BYTES / nbytes)), GRAPH_CALLS)
    copies = [a[0].clone() for _ in range(k)]
    ms = graph_ms(lambda i: slots.slot_planes(copies[i % k], *a[1:], **kw),
                  calls=GRAPH_CALLS)
    del copies
    return ms, k


def profile_slot(slot_args) -> dict:
    """One captured slot replayed on the card under ``torch.profiler``:
    kernel launches (``cudaLaunchKernel`` and the cooperative
    ``cudaLaunchCooperativeKernel``) and copies (runtime calls), device
    time and the busy share of the traced wall time (None, not
    measured, when the trace holds no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import jit_engine as je
    je._slot_rounds(*slot_args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SLOT_PROFILED_SLOTS):
            _, _, rounds = je._slot_rounds(*slot_args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, launches, copies = 0.0, 0, 0
    for e in prof.key_averages():
        dev_us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) or 0)
        if e.key in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel"):
            launches += e.count
        elif e.key in ("cudaMemcpyAsync", "cudaMemcpy"):
            copies += e.count
    k = SLOT_PROFILED_SLOTS
    # a trace without device activity measured none: say so, not 0
    dev_ms = dev_us / k / 1e3 if dev_us > 0 else None
    return {"rounds": rounds, "launches_per_slot": launches / k,
            "copies_per_slot": copies / k, "device_ms_per_slot": dev_ms,
            "wall_ms_per_slot": 1e3 * wall / k,
            "busy": None if dev_ms is None else dev_us / (1e6 * wall)}


def jit_round(cfg, device, warmup_only: bool, capture: int | None = None):
    """One jit round on ``device`` under the measured clock, the launch
    counters and the engine's counts set to 0 before it; returns the
    result, the host seconds, PHASE_S, COUNTS, the launches and the
    captured slot's arguments (or None)."""
    from repro_torch import kernels
    from repro_torch.core import jit_engine as je
    from repro_torch.core.simulator import RoundSimulator, measured_clock
    cap = capture_slot(capture if capture is not None else -1)
    with cap as held, measured_clock() as clk:
        je.reset_phase_timers()
        je.reset_counts()
        kernels.reset_launches()
        t0 = clk()
        res = RoundSimulator(cfg, device=device).run(warmup_only=warmup_only)
        host_s = clk() - t0
        phases = je.reset_phase_timers()
        counts = je.reset_counts()
        launches = dict(kernels.LAUNCHES)
    return res, host_s, phases, counts, launches, held["args"]


def _digest_equal(a, b, what: str) -> None:
    check(log_digest(a.log) == log_digest(b.log),
          f"{what}: the card's transfer log differs from the CPU's")


def _bands(rj, rb, what: str, t_round: bool = False) -> None:
    """tests/test_scheduler_equivalence.py's three-way bands against the
    batched engine."""
    check(abs(rj.t_warm - rb.t_warm) <= max(3, 0.6 * rb.t_warm),
          f"{what}: t_warm {rj.t_warm} against batched {rb.t_warm}")
    check(abs(rj.warmup_utilization - rb.warmup_utilization) <= 0.2,
          f"{what}: warm-up utilisation {rj.warmup_utilization:.4f} "
          f"against batched {rb.warmup_utilization:.4f}")
    if t_round:
        check(abs(rj.t_round - rb.t_round) <= max(5, 0.35 * rb.t_round),
              f"{what}: t_round {rj.t_round} against batched {rb.t_round}")


def check_slot_launches(launches: dict, counts: dict, what: str) -> None:
    """A slot-engine path launched slot_planes and slot_rounds once a
    slot each, overlap_rank and extract_ranked never, and read the host
    twice a slot (rounds, then the grids)."""
    slots_run = counts["slots"]
    check(slots_run > 0, f"{what}: no slot ran")
    for k in SLOT_KERNELS:
        want = slots_run if k in SLOT_PATH_KERNELS else 0
        check(launches.get(k, 0) == want,
              f"{what}: {k} launched {launches.get(k, 0)} times in "
              f"{slots_run} slots (want {want})")
    check(counts["host_reads"] == 2 * slots_run,
          f"{what}: {counts['host_reads']} host reads in {slots_run} slots")


def _slot_line(label, res, host_s, phases, counts, launches) -> dict:
    m = res.metrics
    slots_run = max(counts["slots"], 1)
    t = {"host_s": host_s, **res.timings, **phases, **counts,
         "t_warm": m.t_warm, "t_round": m.t_round,
         "warmup_utilization": m.warmup_utilization,
         "rounds_per_slot": counts["rounds"] / slots_run,
         "host_reads_per_slot": counts["host_reads"] / slots_run,
         "launches": {k: launches.get(k, 0) for k in SLOT_KERNELS}}
    warm = res.timings["warmup_s"]
    log(f"jit {label}: host {host_s:.2f} s (warm-up {warm:.2f} s: "
        f"bitplane {phases['bitplane_s']:.2f}, matching "
        f"{phases['matching_s']:.2f}, extraction {phases['extraction_s']:.2f}"
        f"), t_warm {m.t_warm}, t_round {m.t_round}, warm-up utilisation "
        f"{m.warmup_utilization:.4f}, {counts['slots']} slots, "
        f"{t['rounds_per_slot']:.2f} rounds and {t['host_reads_per_slot']:.2f}"
        f" host reads a slot, launches {t['launches']}")
    return t


def run_slot_engine_paths(device=None) -> tuple[dict, list[dict]]:
    """The GPU slot engine's phase (``scheduler_impl="jit"``), on the card
    (``device`` None) or, as a rehearsal, on the CPU (``"cpu"``: no
    card-against-CPU twins, no kernel rows):

    a. the n 500 sweep point, warm-up only, on the card, with the launch
       counters set to 0 just before it: legal, Eq. 1, not failed open,
       every slot kernel launched; t_warm and utilisation within the
       batched engine's bands (the batched round on the host beside
       it); the same round on the CPU byte-identical; the captured
       slot's ``_slot_rounds`` on the card equal to the CPU's, its
       kernel inputs held exactly against the plain versions and
       timed, and the slot traced (launches, host copies, busy share);
    b. bench_scheduler.py's headline round (n 100, K 64, exact
       BitTorrent through the engine, full round) on the card and on
       the CPU: byte-identical, t_round within the batched band;
    c. the sweep's top (n 5000), warm-up only, on the card: legal, Eq. 1,
       not failed open, the kernels held and timed at its shapes;
    d. the jit session twin (n 20, K 16, churn 0.1, two rounds) on the
       slot and event engines: the card's traces equal the CPU's byte
       for byte.
    Returns the phase's times and the kernel rows."""
    import numpy as np

    from repro_torch.core import SwarmConfig, SwarmSession, privacy
    from repro_torch.core import jit_engine as je
    from repro_torch.core import simulate_round
    from repro_torch.net import NetConfig
    card = device is None
    dev = "cuda" if card else device
    t_phase = time.perf_counter()
    out, rows = {}, []

    # a. n 500
    n = SLOT_NS[0]
    cfg = sweep_cfg(n, "jit")
    res, host_s, ph, cnt, launches, slot_args = jit_round(
        cfg, dev, True, SLOT_CAPTURE_AT)
    check(not res.metrics.failed_open, f"jit n={n}: the warm-up failed open")
    check(privacy.check_eq1(res.log, cfg.owner_throttle, cfg.k_gate),
          f"jit n={n}: a warm-up transfer breaks Eq. 1")
    replay_legality(cfg, res, check_tau=True)
    if card:
        check_slot_launches(launches, cnt, f"jit n={n}")
    out[f"n{n}"] = _slot_line(f"n={n} K={SLOT_K} on {dev}", res, host_s, ph,
                              cnt, launches)
    t0 = time.perf_counter()
    rb = simulate_round(sweep_cfg(n, "batched"), warmup_only=True)
    out[f"n{n}"]["batched_s"] = batched_s = time.perf_counter() - t0
    _bands(res.metrics, rb.metrics, f"jit n={n}")
    log(f"batched n={n}: warm-up {batched_s:.2f} s of host time, t_warm "
        f"{rb.metrics.t_warm}, utilisation "
        f"{rb.metrics.warmup_utilization:.4f}; jit within its bands")
    if card:
        cres, cpu_s, *_ = jit_round(cfg, "cpu", True)
        _digest_equal(res, cres, f"jit n={n}")
        out[f"n{n}"]["cpu_s"] = cpu_s
        log(f"jit n={n} on the CPU: {cpu_s:.2f} s, the same log byte for "
            "byte")
        check(slot_args is not None, f"jit n={n}: no slot captured")
        cpu_args = [a.cpu() if hasattr(a, "cpu") else
                    (tuple(b.cpu() for b in a) if isinstance(a, tuple) else a)
                    for a in slot_args]
        g, c = je._slot_rounds(*slot_args), je._slot_rounds(*cpu_args)
        t = je._slot_rounds(*slot_args, impl="torch")
        for other, where in ((c, "the CPU"), (t, "the plain loop on the "
                                                  "card")):
            check(g[2] == other[2]
                  and bool((g[0] == other[0].to(g[0].device)).all())
                  and bool((g[1] == other[1].to(g[1].device)).all()),
                  f"jit n={n}: _slot_rounds on the card differs from "
                  f"{where}")
        log(f"jit n={n}: slot {SLOT_CAPTURE_AT}'s _slot_rounds on the card "
            f"(slot_rounds) equal to the plain loop on the card and on the "
            f"CPU ({g[2]} rounds)")
        rows += slot_kernel_rows(capture_kernel_inputs(slot_args), launches,
                                 cnt["slots"], f"n {n}")
        out[f"n{n}"]["profile"] = prof = profile_slot(slot_args)
        # the slot's two kernels by CUDA events (their rows above)
        prof["kernel_ms_per_slot"] = sum(
            r["ms"] for r in rows if r["name"] in SLOT_PATH_KERNELS)
        device = ("not measured (the trace held no device time)"
                  if prof["device_ms_per_slot"] is None else
                  f"{prof['device_ms_per_slot']:.3f} ms (busy "
                  f"{100 * prof['busy']:.1f}%)")
        log(f"jit n={n} slot {SLOT_CAPTURE_AT} traced: {prof['rounds']} "
            f"rounds, {prof['launches_per_slot']:.0f} kernel launches, "
            f"{prof['copies_per_slot']:.0f} copies, "
            f"{prof['wall_ms_per_slot']:.3f} ms of wall time; device "
            f"{device}; its kernels {prof['kernel_ms_per_slot']:.3f} ms "
            "by CUDA events")
    del slot_args
    if card:
        free_cuda()

    # b. the headline round: exact BitTorrent through the engine
    hcfg = SwarmConfig(n=100, chunks_per_update=64, s_max=100_000, seed=0,
                       scheduler_impl="jit")
    res, host_s, ph, cnt, launches, _ = jit_round(hcfg, dev, False)
    check(not res.fluid_bt, "headline: BitTorrent ran fluid, not exact")
    check(bool(res.reconstructable.all()) and not res.metrics.failed_open,
          "headline: not every update reconstructable")
    replay_legality(hcfg, res, check_tau=True)
    if card:
        check_slot_launches(launches, cnt, "headline")
    out["headline"] = _slot_line(f"headline n=100 K=64 on {dev}", res,
                                 host_s, ph, cnt, launches)
    t0 = time.perf_counter()
    rb = simulate_round(hcfg.replace(scheduler_impl="batched"))
    out["headline"]["batched_s"] = time.perf_counter() - t0
    _bands(res.metrics, rb.metrics, "headline", t_round=True)
    log(f"batched headline: {out['headline']['batched_s']:.2f} s, t_round "
        f"{rb.metrics.t_round}; jit within its bands")
    if card:
        cres, cpu_s, *_ = jit_round(hcfg, "cpu", False)
        _digest_equal(res, cres, "headline")
        out["headline"]["cpu_s"] = cpu_s
        log(f"jit headline on the CPU: {cpu_s:.2f} s, the same log byte for "
            "byte")

    # c. the sweep's top
    if card:
        import torch
        n = SLOT_NS[1]
        cfg = sweep_cfg(n, "jit")
        torch.cuda.reset_peak_memory_stats()
        res, host_s, ph, cnt, launches, slot_args = jit_round(
            cfg, dev, True, SLOT_CAPTURE_AT)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(not res.metrics.failed_open,
              f"jit n={n}: the warm-up failed open")
        check(privacy.check_eq1(res.log, cfg.owner_throttle, cfg.k_gate),
              f"jit n={n}: a warm-up transfer breaks Eq. 1")
        t0 = time.perf_counter()
        replay_legality(cfg, res, check_tau=True)
        legal_s = time.perf_counter() - t0
        check_slot_launches(launches, cnt, f"jit n={n}")
        out[f"n{n}"] = _slot_line(f"n={n} K={SLOT_K} on {dev}", res, host_s,
                                  ph, cnt, launches)
        out[f"n{n}"]["legality_s"] = legal_s
        out[f"n{n}"]["peak_gb"] = peak
        inv = cfg.total_chunks * je._n_wp(n) * 4 / 1e6
        log(f"jit n={n}: peak device memory {peak:.3f} GB (the chunk-major "
            f"inventory {inv:.1f} MB, held twice: slot {SLOT_CAPTURE_AT}'s "
            "captured inputs keep a copy)")
        del res
        rows += slot_kernel_rows(capture_kernel_inputs(slot_args), launches,
                                 cnt["slots"], f"n {n}")
        del slot_args
        free_cuda()

    # d. the session twin
    for te in ("slot", "event"):
        traces = []
        for d in ((dev, "cpu") if card else (dev,)):
            scfg = SwarmConfig(n=20, chunks_per_update=16, min_degree=5,
                               s_max=4000, seed=7, scheduler_impl="jit")
            kw = ({"time_engine": "event",
                   "net": NetConfig(tracker_rtt_s=0.05)} if te == "event"
                  else {})
            ses = SwarmSession(scfg, churn_rate=0.1, device=d, **kw)
            ses.run(2)
            traces.append(ses.trace())
        for tr in traces[1:]:
            for key in LOG_KEYS:
                check(np.array_equal(tr[key], traces[0][key]),
                      f"jit session ({te}): {key} differs card to CPU")
            check(np.asarray(tr.t_start).tobytes()
                  == np.asarray(traces[0].t_start).tobytes()
                  and np.asarray(tr.t_end).tobytes()
                  == np.asarray(traces[0].t_end).tobytes(),
                  f"jit session ({te}): t_start/t_end differ card to CPU")
        log(f"jit session twin ({te}): {len(traces[0]['slot'])} rows"
            + (", the card's trace equal to the CPU's" if card else ""))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"slot engine phase: {out['phase_s']:.1f} s")
    return out, rows



# ----------------------------------------------------------------------
# the event engine (repro_torch.net): fair-share solves on the card
# ----------------------------------------------------------------------

# The reference numbers are the JAX package's, as committed:
# results/bench/BENCH_net.json's warm_share rows (n 100 and 200) and
# results/bench/fig8_llm_scale.json's rows; n 500's share (0.1041), the
# efficiency at n 100 and the recorded session's counts come from the
# JAX package's bench_net.py, bench_obs.py and bench_session.py
# functions at this tree (the committed BENCH_net.json time_domain row
# is its --quick n 60 point, 0.9802).  Each is held at its committed
# rounding: seconds to 0.1, shares to 4 places, overheads to 2.
EVENT_TOL = 1e-9                # fair-share on the card vs plain, rtol/atol
# warm-up share rounds run (n 200, about 115 s of host time, and n 500
# are cut for the script's time; their references stay)
EVENT_WARM_NS = (100,)
WARM_SHARE_REF = {100: (242.4, 2540.4, 0.0954),     # t_warm_s, t_round_s,
                  200: (544.4, 5337.4, 0.1020),     # warmup_share_s
                  500: (1370.3, 13165.3, 0.1041)}
FIG8_CHUNK = 4 * 2**20          # fig8_llm_scale.py: 4 MiB pieces, n 50
FIG8_N = 50
FIG8_MODELS = ("Gemma-7B",)     # pairs run (Llama-3.3-70B: PERF.md)
FIG8_REF = {   # bf16 bytes; chunks, BT-only s, FLTorrent s, overhead %,
    # warm-up share, control s, spray s
    "Gemma-7B": (7e9 * 2, 3338, 782.0, 837.1, 7.04, 0.1434, 43.4, 3.3),
    "Llama-3.3-70B": (70e9 * 2, 33379, 7826.0, 8375.2, 7.02, 0.142,
                      429.1, 32.7)}
EFFICIENCY_REF = (0.9654, 200.9, 208.1)   # efficiency, lb_s, realized_s
OBS_REF = (238, 21971, 22113)   # rows, flows in flow rows, Perfetto events
OBS_REPORT_TOL = 1e-6           # bench_obs.py's report bound
CHURN_REF = (0.7025, 0.8896, 0.0793, 0)   # persistence, participation,
#                                         warm-up share, failed-open rounds
FAIRSHARE_RECORDED = 20         # first transport calls of the n 100 round


class FairshareTimer:
    """Wraps the event engine's ``transport`` and ``maxmin_rates`` (the
    names ``repro_torch.net.engine`` calls) with a synchronised host
    timer; records the first ``keep`` transport calls' arguments."""

    def __init__(self, keep: int = 0):
        self.keep = keep
        self.calls: list = []
        self.seconds = 0.0

    def __enter__(self):
        import torch

        from repro_torch.net import engine
        self._mod = engine
        self._orig = (engine.transport, engine.maxmin_rates)

        def timed(fn, record):
            def wrapper(*args, **kw):
                if record and len(self.calls) < self.keep:
                    self.calls.append((args, dict(kw)))
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out
            return wrapper

        engine.transport = timed(self._orig[0], True)
        engine.maxmin_rates = timed(self._orig[1], False)
        return self

    def __exit__(self, *exc):
        self._mod.transport, self._mod.maxmin_rates = self._orig
        return False


def event_round(cfg, link_model, net, device=None, keep: int = 0,
                **sim_kw):
    """One event round under a recorder and a :class:`FairshareTimer`;
    returns the simulator, the result and its timings."""
    from repro_torch import obs
    from repro_torch.core.simulator import RoundSimulator

    sim = RoundSimulator(cfg, link_model, time_engine="event", net=net,
                         device=device, **sim_kw)
    with obs.recording() as rec, FairshareTimer(keep) as ft:
        t0 = time.perf_counter()
        res = sim.run()
        host_s = time.perf_counter() - t0
    m = {k: rec.metrics[k]["value"] for k in (
        "fairshare.transport_calls", "fairshare.solves",
        "fairshare.maxmin_calls") if k in rec.metrics}
    solves = int(m.get("fairshare.maxmin_calls", 0))
    return sim, res, {"host_s": host_s, "fairshare_s": ft.seconds,
                      "transport_calls": int(
                          m.get("fairshare.transport_calls", 0)),
                      "solves": solves,
                      "us_per_solve": 1e6 * ft.seconds / max(solves, 1),
                      "recorded": ft.calls}


def _fairshare_gap(got, want, what: str) -> float:
    """Exact chunk_flow and n_solves, finish and chunk_end to EVENT_TOL;
    the largest gap."""
    import numpy as np
    check(np.array_equal(got.chunk_flow, want.chunk_flow),
          f"{what}: chunk_flow differs")
    check(got.n_solves == want.n_solves,
          f"{what}: n_solves {got.n_solves} != {want.n_solves}")
    fin = np.isfinite(want.finish)
    check(np.array_equal(np.isfinite(got.finish), fin),
          f"{what}: finite finish instants differ")
    gap = 0.0
    for g, w in ((got.finish[fin], want.finish[fin]),
                 (got.chunk_end, want.chunk_end)):
        ok = np.abs(g - w) <= EVENT_TOL + EVENT_TOL * np.abs(w)
        check(bool(ok.all()), f"{what}: instants beyond {EVENT_TOL}")
        gap = max(gap, float(np.max(np.abs(g - w), initial=0.0)))
    return gap


def check_fairshare(recorded, device=None) -> None:
    """The card's fair-share solves against the numpy plain versions:
    tests/test_net.py's small cases, seeded heterogeneous cases (links
    over six decades, zero-capacity links, a tail truncated at 2 passes,
    ``quantum_frac`` 0) and ``recorded`` transport calls of a real round
    (argument tuples)."""
    import numpy as np

    from repro_torch.net import fairshare as fs
    rate_cases = [([0, 0, 0], [1, 2, 3], [9.0] * 4, [100.0] * 4, 16),
                  ([0, 0], [1, 2], [10.0, 100.0, 100.0],
                   [100.0, 2.0, 100.0], 16)]
    flow_cases = [([0, 1], [2, 2], [5, 3], 10.0, [10.0] * 3,
                   [10.0, 10.0, 8.0], 1 / 64),
                  (list(range(4)), [4] * 4, [6] * 4, 2.0, [100.0] * 5,
                   [12.0] * 5, 1 / 64)]
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n, f = int(rng.integers(2, 80)), int(rng.integers(1, 600))
        src = rng.integers(0, n, f)
        dst = (src + 1 + rng.integers(0, n - 1, f)) % n
        up = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
        down = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
        if seed % 3 == 0:
            up[src[0]] = 0.0
            down[dst[-1]] = 0.0
        rate_cases.append((src, dst, up, down, 2 if seed % 2 else 16))
        flow_cases.append((src, dst, rng.integers(1, 9, f), 1000.0, up,
                           down, 0.0 if seed % 4 == 1 else 1 / 64))
    gap = 0.0
    for i, (src, dst, up, down, passes) in enumerate(rate_cases):
        a = [np.asarray(x) for x in (src, dst, up, down)]
        got = fs.maxmin_rates(*a, passes, device=device)
        want = fs.maxmin_rates_plain(*a, passes)
        err = np.abs(got - want)
        check(bool((err <= EVENT_TOL + EVENT_TOL * np.abs(want)).all()),
              f"maxmin case {i}: rates beyond {EVENT_TOL}")
        gap = max(gap, float(err.max(initial=0.0)))
    for i, (src, dst, cnt, cb, up, down, qf) in enumerate(flow_cases):
        a = [np.asarray(x) for x in (src, dst, cnt)]
        b = [np.asarray(x) for x in (up, down)]
        gap = max(gap, _fairshare_gap(
            fs.transport(*a, cb, *b, quantum_frac=qf, device=device),
            fs.transport_plain(*a, cb, *b, quantum_frac=qf),
            f"transport case {i}"))
    for i, (args, kw) in enumerate(recorded):
        gap = max(gap, _fairshare_gap(
            fs.transport(*args, **kw),
            fs.transport_plain(*args, quantum_frac=kw["quantum_frac"]),
            f"recorded transport call {i}"))
    log(f"fair-share on the card vs the numpy plain version: "
        f"{len(rate_cases)} max-min cases, {len(flow_cases)} transport "
        f"cases and {len(recorded)} recorded calls of the n 100 round; "
        f"chunk_flow and n_solves exact; largest gap {gap:.3e} "
        f"(tolerance {EVENT_TOL})")


def check_counts_parity(device=None) -> None:
    """bench_net.py::counts_parity: n 60, K 64, no tracker RTT; the
    event engine's chunk and slot columns equal the slot engine's."""
    import numpy as np

    from repro_torch.core import SwarmConfig
    from repro_torch.core.simulator import RoundSimulator
    from repro_torch.net import NetConfig
    cfg = SwarmConfig(n=60, chunks_per_update=64, s_max=20_000, seed=0)
    rs = RoundSimulator(cfg).run()
    re = RoundSimulator(cfg, time_engine="event",
                        net=NetConfig(tracker_rtt_s=0.0),
                        device=device).run()
    for k in ("chunk", "slot"):
        check(np.array_equal(rs.log[k], re.log[k]),
              f"counts parity: the event engine's {k} column differs")
    log(f"slot/event schedule parity (n 60, K 64): {len(re.log)} "
        "transfers equal, chunk and slot columns")


def _time_line(label: str, t: dict) -> str:
    return (f"{label}: host {t['host_s']:.2f} s, of it fair-share "
            f"{t['fairshare_s']:.2f} s ({t['transport_calls']} transport "
            f"calls, {t['solves']} solves, {t['us_per_solve']:.1f} us a "
            "solve)")


def run_warm_share(n: int, device=None, keep: int = 0):
    """bench_net.py::warm_share_sweep at one n: K 206, RESIDENTIAL,
    RESIDENTIAL_NET, fluid BitTorrent, seed 0; held to the reference,
    Eq. 1 and the legality replay on the event trace."""
    from repro_torch.core import SwarmConfig, privacy
    from repro_torch.core.capacities import RESIDENTIAL
    from repro_torch.net import RESIDENTIAL_NET
    cfg = SwarmConfig(n=n, chunks_per_update=206, s_max=50_000, seed=0)
    _, res, t = event_round(cfg, RESIDENTIAL, RESIDENTIAL_NET, device,
                            keep, bt_mode="fluid")
    m = res.metrics
    got = (round(m.t_warm_s, 1), round(m.t_round_s, 1),
           round(m.warmup_share_s, 4))
    check(got == WARM_SHARE_REF[n],
          f"n {n}: (t_warm_s, t_round_s, share) {got} != "
          f"{WARM_SHARE_REF[n]}")
    check(privacy.check_eq1(res.log, cfg.owner_throttle, cfg.k_gate),
          f"n {n}: a warm-up transfer breaks Eq. 1 on the event trace")
    replay_legality(cfg, res, check_tau=True)
    log(f"warm-up share n {n}, K 206: t_warm_s {m.t_warm_s:.1f}, "
        f"t_round_s {m.t_round_s:.1f}, share {m.warmup_share_s:.4f}, "
        f"control_s {m.control_s:.1f}, spray_s {m.t_spray_s:.1f}; Eq. 1 "
        f"and the log legal; " + _time_line("time", t))
    return got, t


def run_fig8(name: str, device=None, keep: int = 0):
    """fig8_llm_scale.py's pair for one model at n 50: BitTorrent only
    (every defence off) and FLTorrent, DATACENTER, DATACENTER_NET."""
    from repro_torch.core import SwarmConfig
    from repro_torch.core.capacities import DATACENTER
    from repro_torch.net import DATACENTER_NET
    nbytes, *ref = FIG8_REF[name]
    K = int(-(-nbytes // FIG8_CHUNK))
    common = dict(n=FIG8_N, chunks_per_update=K, chunk_bytes=FIG8_CHUNK,
                  s_max=10**7, seed=0, min_degree=min(FIG8_N - 1, 10))
    base = SwarmConfig(**common, enable_gating=False,
                       enable_preround=False, enable_timelag=False,
                       enable_nonowner_first=False,
                       warmup_threshold_pct=0.0)
    _, b, tb = event_round(base, DATACENTER, DATACENTER_NET, device,
                           bt_mode="fluid")
    _, f, tf = event_round(SwarmConfig(**common), DATACENTER,
                           DATACENTER_NET, device, keep, bt_mode="fluid")
    bm, fm = b.metrics, f.metrics
    ovh = 100 * (fm.t_round_s - bm.t_round_s) / bm.t_round_s
    got = (K, round(bm.t_round_s, 1), round(fm.t_round_s, 1),
           round(ovh, 2), round(fm.warmup_share_s, 4),
           round(fm.control_s, 1), round(fm.t_spray_s, 1))
    check(list(got) == ref, f"Fig. 8 {name}: {got} != {tuple(ref)}")
    log(f"Fig. 8 {name} (n {FIG8_N}, K {K}): BitTorrent only "
        f"{bm.t_round_s:.1f} s, FLTorrent {fm.t_round_s:.1f} s, overhead "
        f"{ovh:+.2f}%, warm-up share {fm.warmup_share_s:.4f}, control_s "
        f"{fm.control_s:.1f}, spray_s {fm.t_spray_s:.1f}; "
        + _time_line("BT-only", tb) + "; " + _time_line("FLTorrent", tf))
    return got, tb, tf


def replay_fig8_calls(calls, device=None) -> dict:
    """The recorded transport calls of a round through the card and
    through the numpy plain version on the host; equal, and timed."""
    import torch

    from repro_torch.net import fairshare as fs
    t0 = time.perf_counter()
    got = [fs.transport(*a, **kw) for a, kw in calls]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [fs.transport_plain(*a, quantum_frac=kw["quantum_frac"])
            for a, kw in calls]
    plain_s = time.perf_counter() - t0
    gap = max((_fairshare_gap(g, w, f"replayed call {i}")
               for i, (g, w) in enumerate(zip(got, want))), default=0.0)
    solves = sum(w.n_solves for w in want)
    chunks = max((int(a[2].sum()) for a, _ in calls), default=0)
    prof = profile_fairshare(calls[:PROFILED_CALLS],
                             sum(w.n_solves for w in want[:PROFILED_CALLS]))
    log(f"Gemma-7B's {len(calls)} transport calls replayed ({solves} "
        f"solves, up to {chunks} chunks a call): card {card_s:.3f} s, "
        f"numpy plain version on the host {plain_s:.3f} s "
        f"({plain_s / max(card_s, 1e-9):.2f}x); largest gap {gap:.3e}; "
        f"the first {PROFILED_CALLS} calls under torch.profiler: "
        f"{prof['launches_per_solve']:.0f} kernel launches and "
        f"{prof['syncs_per_solve']:.1f} device-to-host copies a solve, "
        f"{prof['device_us_per_solve']:.1f} us of device time a solve in "
        f"{prof['wall_us_per_solve']:.1f} us of wall time (device busy "
        f"{100 * prof['busy']:.1f}%)")
    return {"calls": len(calls), "solves": solves, "card_s": card_s,
            "plain_s": plain_s, "profile": prof}


PROFILED_CALLS = 8              # replayed calls traced by torch.profiler


def profile_fairshare(calls, solves: int) -> dict:
    """Trace ``calls`` transport calls on the card: kernel launches and
    device-to-host copies (``cudaLaunchKernel``, ``cudaMemcpyAsync``
    runtime calls) and device time a solve, and the device's busy share
    of the traced wall time (the profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.net import fairshare as fs
    cuda = torch.cuda.is_available()      # False: a CPU rehearsal
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        for a, kw in calls:
            fs.transport(*a, **kw)
        sync()
        wall = time.perf_counter() - t0
    dev_us, launches, copies = 0.0, 0, 0
    for e in prof.key_averages():
        dev_us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) or 0)
        if e.key == "cudaLaunchKernel":
            launches += e.count
        elif e.key == "cudaMemcpyAsync":
            copies += e.count
    k = max(solves, 1)
    return {"launches_per_solve": launches / k,
            "syncs_per_solve": copies / k,
            "device_us_per_solve": dev_us / k,
            "wall_us_per_solve": 1e6 * wall / k,
            "busy": dev_us / max(1e6 * wall, 1e-9)}


def check_time_domain_efficiency(device=None) -> None:
    """bench_net.py::time_domain_efficiency at n 100: realized warm-up
    transport seconds against the per-cycle congestion bound
    (``warmup_time_bounds``), zero latency."""
    from repro_torch.core import SwarmConfig
    from repro_torch.core.capacities import RESIDENTIAL
    from repro_torch.core.maxflow import warmup_time_bounds
    from repro_torch.net import NetConfig
    cfg = SwarmConfig(n=100, chunks_per_update=206, s_max=50_000, seed=0)
    sim, res, t = event_round(cfg, RESIDENTIAL, NetConfig(), device,
                              bt_mode="fluid")
    lbs, real = warmup_time_bounds(res.log, cfg.chunk_bytes, sim.up_bps,
                                   sim.down_bps)
    eff = float(lbs.sum() / max(real.sum(), 1e-12))
    got = (round(eff, 4), round(float(lbs.sum()), 1),
           round(float(real.sum()), 1))
    check(got == EFFICIENCY_REF,
          f"time-domain efficiency {got} != {EFFICIENCY_REF}")
    log(f"time-domain efficiency n 100 (GFF): {eff:.4f} of the bound "
        f"({lbs.sum():.1f} s bound, {real.sum():.1f} s realized); "
        + _time_line("time", t))


def check_sessions(device=None) -> None:
    """bench_obs.py's recorded session and bench_session.py's churn row.

    The recorded session: n 100, K 8, min degree 6, s_max 3000, the
    event engine on RESIDENTIAL_NET with an evolving overlay, two rounds
    cut at a quorum of 90 with the tail drained at the boundary; its
    JSONL and Perfetto trace written to a temporary directory,
    validated, counted against the reference, and the report held to
    each round's metrics.  The churn row: n 100, K 64, s_max 100,000,
    leave 0.1, 2.5 joins a boundary, rejoin after 2, fluid BitTorrent,
    the slot engine, 3 rounds."""
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.core import ChurnModel, SwarmConfig, SwarmSession
    from repro_torch.net import RESIDENTIAL_NET
    cfg = SwarmConfig(n=100, chunks_per_update=8, min_degree=6,
                      s_max=3000, seed=0)
    t0 = time.perf_counter()
    with obs.recording(meta={"bench": "obs", "n": 100,
                             "rounds": 2}) as rec, FairshareTimer() as ft:
        ses = SwarmSession(cfg, time_engine="event", net=RESIDENTIAL_NET,
                           evolve_overlay=True, device=device)
        ses.run(2, quorum_k=90, tail_mode="drain")
    host_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "obs_round.jsonl"
        n_rows = obs.write_jsonl(rec, path)
        rows = obs.read_jsonl(path)
        bad = obs.validate_rows(rows)
        check(not bad, f"recorded session: JSONL violations {bad[:3]}")
        n_events = obs.write_perfetto(rows, Path(tmp) / "trace.json")
        trace = json.loads((Path(tmp) / "trace.json").read_text())
    check(len(trace["traceEvents"]) == n_events
          and {0, 1, 2} <= {e["pid"] for e in trace["traceEvents"]},
          "recorded session: the Perfetto trace does not load")
    flows = sum(r["n"] for r in rows if r.get("kind") == "flows")
    got = (n_rows, flows, n_events)
    check(got == OBS_REF, f"recorded session: (rows, flows, Perfetto "
          f"events) {got} != {OBS_REF}")
    summary = obs.summarize(rows)
    wc = ses.wall_clock()
    err = max(abs(summary["rounds"][r][k] - wc[k][r]) for r in range(2)
              for k in ("t_warm_s", "t_round_s", "warmup_share_s"))
    check(err < OBS_REPORT_TOL,
          f"recorded session: report off its metrics by {err:.3e}")
    log(f"recorded session (n 100, 2 event rounds, quorum 90, drain): "
        f"{n_rows} rows, {flows} flows, {n_events} Perfetto events, "
        f"valid; report within {err:.2e} of the metrics; host "
        f"{host_s:.2f} s, of it fair-share {ft.seconds:.2f} s")
    cfg = SwarmConfig(n=100, chunks_per_update=64, s_max=100_000, seed=0)
    ses = SwarmSession(cfg, churn=ChurnModel(
        leave_prob=0.1, join_rate=0.1 * 100 / 4, rejoin_after=2),
        bt_mode="fluid")
    t0 = time.perf_counter()
    recs = ses.run(3)
    got = (round(ses.edge_persistence(), 4),
           round(float(ses.participation().mean()), 4),
           round(float(np.mean([r.result.metrics.warmup_share
                                for r in recs])), 4),
           sum(r.result.metrics.failed_open for r in recs))
    check(got == CHURN_REF, f"churn row {got} != {CHURN_REF}")
    log(f"churn row (n 100, leave 0.1, 3 slot rounds): edge persistence "
        f"{got[0]}, participation {got[1]}, warm-up share {got[2]}, "
        f"{got[3]} failed-open rounds; host "
        f"{time.perf_counter() - t0:.2f} s")


def run_event_paths(device=None) -> dict:
    """The event engine's phase: fair-share on the card against its
    plain version, slot/event parity, the warm-up share rounds
    (``EVENT_WARM_NS``), Fig. 8's pairs (``FIG8_MODELS``) with the
    FLTorrent round's transport calls replayed on the host, the
    time-domain efficiency, the recorded session and the churn row.
    ``device`` None is the card; ``"cpu"`` rehearses on the CPU.
    Returns the times for the summary line."""
    t_phase = time.perf_counter()
    out = {"rounds": {}}
    _, t = run_warm_share(EVENT_WARM_NS[0], device, FAIRSHARE_RECORDED)
    check(len(t["recorded"]) == FAIRSHARE_RECORDED,
          f"only {len(t['recorded'])} transport calls recorded")
    out["rounds"][f"n{EVENT_WARM_NS[0]}"] = t
    check_fairshare(t.pop("recorded"), device)
    check_counts_parity(device)
    for n in EVENT_WARM_NS[1:]:
        _, t = run_warm_share(n, device)
        t.pop("recorded")
        out["rounds"][f"n{n}"] = t
    for i, name in enumerate(FIG8_MODELS):
        _, tb, tf = run_fig8(name, device, keep=10**6 if i == 0 else 0)
        calls = tf.pop("recorded")
        tb.pop("recorded")
        out["rounds"][f"{name} BT-only"] = tb
        out["rounds"][f"{name} FLTorrent"] = tf
        if i == 0:
            out["replay"] = replay_fig8_calls(calls, device)
    check_time_domain_efficiency(device)
    check_sessions(device)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"event phase: {out['phase_s']:.1f} s")
    return out


# ----------------------------------------------------------------------
# the FL stack (repro_torch.fl): the paper's learning runs on the card
# ----------------------------------------------------------------------

# benchmarks/table2_learning.py's fast configurations and
# examples/fl_learning_e2e.py's churn run.  The churn run's participation
# and rejoin rounds are host numpy (the session's stream), taken from the
# JAX package's run_experiment at this tree; the async frontier's numbers
# depend only on the swarm, and are the JAX package's
# table2_learning.async_frontier(fast=True) at this tree (the committed
# results/bench/table2_learning.json has the same).
FL_TABLE2 = dict(dataset="synth-cifar", n_clients=10, n_train=4000,
                 n_test=1000, seed=0, min_degree=5)
FL_LOCAL = dict(epochs=1, batch_size=32, lr=0.03)
FL_DISTS = ("dir0.1", "iid")
FL_ROUNDS = {"mlp": 6, "cnn": 3}
FL_AGREE_TOL = 1e-3             # FLTorrent against CFL, accuracy a round
FL_STEP_RATIO = 4.0             # card/CPU median step error against f64
FL_ACC_TOL = 0.01               # accuracy a round, card against CPU
FL_CHURN = dict(dataset="synth-cifar", model="mlp", dist="dir0.1",
                n_clients=10, rounds=8, n_train=3000, n_test=800, seed=0,
                min_degree=5, churn_rate=0.25, rejoin_after=1)
FL_CHURN_REF = ([1.0, 0.9, 0.8, 1.0, 1.0, 0.8, 0.9, 0.8],  # participation
                [2, 3, 3, 6, 6, 7])                         # rejoin rounds
FL_ASYNC = dict(dataset="synth-mnist", dist="dir0.1", n_clients=16,
                rounds=8, min_degree=5, n_train=3000, n_test=800, seed=0)
FL_ASYNC_SLOTS = (None, 6, 8)   # sync, then round_slots 6 and 8
FL_ASYNC_REF = {None: (4, 242.6, {}, 0),        # K, wall_s[-1] at 0.1 s,
                6: (4, 197.7, {1: 94}, 0),      # staleness_hist, dropped
                8: (4, 213.5, {1: 52}, 0)}


class RoundTap:
    """Wraps the synchronous runner's ``make_local_train`` and
    ``apply_aggregate`` (the names ``repro_torch.fl.runner`` calls) and
    keeps, for every round that applies an aggregate, the global params
    and the batching rng's state before the round's first local step,
    the aggregate as a host vector, the device it lay on and the TF32
    flags in force."""

    def __enter__(self):
        import copy

        import numpy as np
        import torch

        from repro_torch.fl import runner
        from repro_torch.interop import to_numpy
        from repro_torch.tree import leaves
        self._mod = runner
        self._orig = (runner.make_local_train, runner.apply_aggregate)
        self.rounds: list[dict] = []
        self._open = None

        def make(apply_fn, spec):
            inner = self._orig[0](apply_fn, spec)

            def local_train(params, x, y, rng):
                if self._open is None:
                    self._open = {"params": to_numpy(params), "rng":
                                  copy.deepcopy(rng.bit_generator.state)}
                return inner(params, x, y, rng)
            return local_train

        def apply(params, agg):
            ls = leaves(agg)
            rd, self._open = self._open, None
            rd.update(agg=np.concatenate(
                [x.detach().cpu().numpy().ravel() for x in ls]),
                device=ls[0].device.type,
                tf32=(torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
            self.rounds.append(rd)
            return self._orig[1](params, agg)

        runner.make_local_train, runner.apply_aggregate = make, apply
        return self

    def __exit__(self, *exc):
        self._mod.make_local_train, self._mod.apply_aggregate = self._orig
        return False


def step_errors(cfg, rounds: list, device=None,
                tf32: bool = False) -> tuple[list, list]:
    """Every local SGD step of the tapped FLTorrent rounds, forced from
    the CPU run: each round from its tapped global params and batching
    rng state, each step from the CPU's parameters and momentum before
    it.  The step's gradient in f32 on the CPU and on ``device``, each
    against the same step in f64 on the CPU: a step's error is the
    largest difference over the largest f64 gradient entry of the same
    leaf, the largest over leaves.  Returns the CPU's and the card's
    errors, one a step.  ``tf32`` runs the card's steps with TF32 on
    (the faulty control)."""
    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.fl.client import make_sgd_step
    from repro_torch.fl.models_small import MODELS, true_f32
    from repro_torch.fl.runner import setup_run
    from repro_torch.interop import params_from_numpy
    from repro_torch.tree import flatten
    cpu, dev = torch.device("cpu"), resolve_device(device)
    host = setup_run(cfg, cpu, rounds[0]["params"])
    card = setup_run(cfg, dev, rounds[0]["params"])
    step = make_sgd_step(MODELS[cfg.model][1], cfg.local)
    bs = cfg.local.batch_size

    def err(g, ref):
        return max(float((x.cpu().double() - r).abs().max())
                   / max(float(r.abs().max()), 1e-300)
                   for x, r in zip(g, ref))

    err_cpu, err_card = [], []
    with true_f32():
        for rd in rounds:
            rng = np.random.default_rng()
            rng.bit_generator.state = rd["rng"]
            for v in range(cfg.n_clients):
                # local_train's loop (client.py), one step at a time.
                leaves, td = flatten(params_from_numpy(rd["params"], cpu))
                mom = [torch.zeros_like(p) for p in leaves]
                for _ in range(cfg.local.epochs):
                    order = rng.permutation(len(host.ys[v]))
                    for i in range(0, len(order), bs):
                        sl = torch.from_numpy(order[i:i + bs])
                        if len(sl) < 2:
                            continue
                        xb, yb = host.xs[v][sl], host.ys[v][sl]
                        new, new_mom, g = step(leaves, td, mom, xb, yb)
                        _, _, g64 = step([p.double() for p in leaves], td,
                                         [m.double() for m in mom],
                                         xb.double(), yb)
                        sd = sl.to(dev)
                        with (tf32_on() if tf32
                              else contextlib.nullcontext()):
                            _, _, gd = step([p.to(dev) for p in leaves],
                                            td, [m.to(dev) for m in mom],
                                            card.xs[v][sd], card.ys[v][sd])
                        err_cpu.append(err(g, g64))
                        err_card.append(err(gd, g64))
                        leaves, mom = new, new_mom
    return err_cpu, err_card


@contextlib.contextmanager
def tf32_on():
    """TF32 matmuls and cuDNN convolutions, as torch allows them."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def one_thread():
    """torch on the CPU with one thread: the same arithmetic as with the
    default threads, summed in another order."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _fl_config(**kw):
    from repro_torch.fl import FLConfig, LocalSpec
    local = kw.pop("local", FL_LOCAL)
    return FLConfig(local=LocalSpec(**local), **kw)


def _fl_params0(model: str, dataset: str):
    """The port's initial weights for ``model`` (seed 0) as numpy."""
    import torch

    from repro_torch.fl.models_small import MODELS
    from repro_torch.interop import to_numpy
    shape = {"synth-mnist": (28, 28, 1), "synth-cifar": (32, 32, 3)}
    return to_numpy(MODELS[model][0](torch.Generator().manual_seed(0),
                                     shape[dataset], 10))


def fl_run(method: str, cfg, device, params0):
    """One ``run_experiment`` under a :class:`RoundTap`; the result, the
    tap and the host seconds (synchronised)."""
    import torch

    from repro_torch.fl import run_experiment
    with RoundTap() as tap:
        t0 = time.perf_counter()
        res = run_experiment(method, cfg, device=device, params0=params0)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in res.accuracy)
          and len(res.accuracy) == cfg.rounds,
          f"{method}: accuracies {res.accuracy}")
    want = "cpu" if device == "cpu" else "cuda"
    for rd in tap.rounds:
        check(rd["device"] == want and rd["tf32"] == (False, False),
              f"{method}: aggregated on {rd['device']} with TF32 flags "
              f"{rd['tf32']}, not on {want} in true f32")
    check(len(tap.rounds) == (0 if method == "gossip" else cfg.rounds),
          f"{method}: {len(tap.rounds)} aggregates applied")
    return res, tap, host_s


def _acc_gaps(a, b) -> list:
    return [abs(x - y) for x, y in zip(a, b)]


def run_table2(model: str, dist: str, device=None) -> dict:
    """One row of Table II (``FL_TABLE2``): CFL, GossipDFL (mlp only) and
    FLTorrent on ``device``, FLTorrent's trajectory held to CFL's; then
    FLTorrent on the CPU from the same weights, and the card held to it.

    Two f32 runs that sum in different orders part at ReLU boundaries (a
    pre-activation within an ulp of 0 takes the other branch) and then
    diverge, round by round and within a round; the CPU does so against
    itself with one thread.  So the card is held step by step
    (``step_errors``: its median step's gradient no more than
    ``FL_STEP_RATIO`` times as far from f64 as the CPU's; TF32, the
    faulty control, must be further), and on the accuracy of every round
    before the first in which the one-thread run parts from the CPU by
    more than ``FL_ACC_TOL``.  Round 1's aggregate is logged beside the
    one-thread run's."""
    import numpy as np
    import torch
    cfg = _fl_config(model=model, dist=dist, rounds=FL_ROUNDS[model],
                     **FL_TABLE2)
    params0 = _fl_params0(model, cfg.dataset)
    methods = ("cfl", "gossip", "fltorrent") if model == "mlp" \
        else ("cfl", "fltorrent")
    runs = {m: fl_run(m, cfg, device, params0) for m in methods}
    flt, cfl = runs["fltorrent"][0], runs["cfl"][0]
    check(flt.agreement and flt.reconstruct_frac == 1.0,
          f"{model} {dist}: FLTorrent agreement {flt.agreement}, "
          f"reconstruct_frac {flt.reconstruct_frac}")
    gap = max(_acc_gaps(flt.accuracy, cfl.accuracy))
    check(gap <= FL_AGREE_TOL + 1e-12,
          f"{model} {dist}: FLTorrent {flt.accuracy} is not CFL "
          f"{cfl.accuracy} within {FL_AGREE_TOL}")
    cpu, ctap, cpu_s = fl_run("fltorrent", cfg, "cpu", params0)
    check(cpu.agreement and cpu.reconstruct_frac == 1.0,
          f"{model} {dist}: FLTorrent on the CPU disagrees")
    with one_thread():
        ctl, ttap, ctl_s = fl_run("fltorrent", cfg, "cpu", params0)
    t0 = time.perf_counter()
    e_cpu, e_card = (np.asarray(e) for e in
                     step_errors(cfg, ctap.rounds, device))
    steps_s = time.perf_counter() - t0
    ratio = float(np.median(e_card) / max(np.median(e_cpu), 1e-300))
    # The faulty control (the card only: the CPU has no TF32): round 1's
    # steps with TF32 on must fail the gate.
    if device == "cpu":
        tf32_ratio = None
    else:
        c1, t1 = step_errors(cfg, ctap.rounds[:1], device, tf32=True)
        tf32_ratio = float(np.median(t1) / max(np.median(c1), 1e-300))
    agg1 = float(np.max(np.abs(runs["fltorrent"][1].rounds[0]["agg"]
                               - ctap.rounds[0]["agg"])))
    ctl_agg1 = float(np.max(np.abs(ttap.rounds[0]["agg"]
                                   - ctap.rounds[0]["agg"])))
    card_gaps = _acc_gaps(flt.accuracy, cpu.accuracy)
    ctl_gaps = _acc_gaps(ctl.accuracy, cpu.accuracy)
    held = next((r for r, g in enumerate(ctl_gaps) if g > FL_ACC_TOL),
                cfg.rounds)
    vs_cpu = {"steps": int(e_card.size),
              "step_err_cpu_median": float(np.median(e_cpu)),
              "step_err_card_median": float(np.median(e_card)),
              "step_err_ratio": ratio,
              "step_err_card_p90": float(np.quantile(e_card, 0.9)),
              "step_err_card_max": float(e_card.max()),
              "steps_s": steps_s, "tf32_control_ratio": tf32_ratio,
              "agg1_gap": agg1,
              "control_agg1_gap": ctl_agg1, "acc_gaps": card_gaps,
              "control_acc_gaps": ctl_gaps, "acc_rounds_held": held,
              "cpu_host_s": cpu_s, "control_host_s": ctl_s,
              "threads": torch.get_num_threads(),
              "cpu_accuracy": cpu.accuracy}
    row = {m: round(float(np.mean(r.accuracy[-3:])), 4)
           for m, (r, _, _) in runs.items()}
    row.update(agreement=bool(flt.agreement),
               reconstruct_frac=float(flt.reconstruct_frac),
               flt_cfl_gap=gap,
               host_s={m: h for m, (_, _, h) in runs.items()},
               accuracy={m: r.accuracy for m, (r, _, _) in runs.items()},
               vs_cpu=vs_cpu)
    log(f"Table II {cfg.dataset} {model} {dist} (n {cfg.n_clients}, "
        f"{cfg.rounds} rounds): "
        + ", ".join(f"{m} {row[m]:.4f}" for m in methods)
        + f" (mean of the last 3 rounds); FLTorrent - CFL at most "
        f"{gap:.4f} a round, agreement, every update reconstructed; host "
        + ", ".join(f"{m} {h:.2f} s" for m, h in row["host_s"].items()))
    log(f"  card vs CPU ({vs_cpu['threads']} threads, {cpu_s:.2f} s): "
        f"{e_card.size} SGD steps forced from the CPU's state, the "
        f"gradient's error against f64: median {np.median(e_card):.2e} "
        f"on the card, {np.median(e_cpu):.2e} on the CPU (ratio "
        f"{ratio:.2f}; the card's 90th percentile "
        f"{vs_cpu['step_err_card_p90']:.2e}, largest {e_card.max():.2e}; "
        f"{steps_s:.2f} s)"
        + ("" if tf32_ratio is None else
           f", round 1's steps with TF32 on (the faulty control) ratio "
           f"{tf32_ratio:.2f}")
        + "; "
        f"round 1's aggregate within {agg1:.3e} (the CPU with 1 thread: "
        f"{ctl_agg1:.3e}); accuracy gaps {[round(g, 4) for g in card_gaps]}"
        f", the CPU with 1 thread {[round(g, 4) for g in ctl_gaps]} "
        f"({ctl_s:.2f} s), held to {FL_ACC_TOL} in the first {held} "
        f"rounds; card {flt.accuracy}, CPU {cpu.accuracy}")
    check(ratio <= FL_STEP_RATIO,
          f"{model} {dist}: the card's median SGD step is {ratio:.2f}x as "
          f"far from f64 as the CPU's (limit {FL_STEP_RATIO})")
    check(tf32_ratio is None or tf32_ratio > FL_STEP_RATIO,
          f"{model} {dist}: TF32 steps at {tf32_ratio}x pass the step "
          f"gate {FL_STEP_RATIO}: the check cannot see them")
    check(all(g <= FL_ACC_TOL + 1e-12 for g in card_gaps[:held]),
          f"{model} {dist}: accuracies {flt.accuracy} on the card, "
          f"{cpu.accuracy} on the CPU")
    return row


def run_fl_churn(device=None) -> dict:
    """examples/fl_learning_e2e.py's churn run: leavers hold stale
    params and catch up when they rejoin."""
    cfg = _fl_config(**FL_CHURN)
    res, _, host_s = fl_run("fltorrent", cfg, device,
                            _fl_params0(cfg.model, cfg.dataset))
    check((res.participation, res.rejoin_rounds) == FL_CHURN_REF,
          f"churn: participation {res.participation}, rejoin rounds "
          f"{res.rejoin_rounds} != {FL_CHURN_REF}")
    check(res.stale_seen and res.caught_up and res.agreement,
          f"churn: stale_seen {res.stale_seen}, caught_up "
          f"{res.caught_up}, agreement {res.agreement}")
    log(f"churn (n {cfg.n_clients}, rate {cfg.churn_rate}, rejoin after "
        f"{cfg.rejoin_after}, {cfg.rounds} rounds): participation "
        f"{res.participation}, rejoins at {res.rejoin_rounds}, stale "
        f"params re-synced, agreement; final accuracy "
        f"{res.accuracy[-1]:.4f}; host {host_s:.2f} s")
    return {"participation": res.participation,
            "rejoin_rounds": res.rejoin_rounds,
            "accuracy": res.accuracy, "host_s": host_s}


def run_fl_async(slots, device=None) -> dict:
    """table2_learning.async_frontier(fast=True) at one point: synchronous
    (``slots`` None) or round_slots ``slots`` (buffer 4, staleness 3,
    the tail carried), on straggler links and the event engine, whose
    fair-share solves run on ``device``."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core.capacities import MBPS, StragglerLinkModel
    from repro_torch.fl import AsyncConfig, run_async_experiment
    from repro_torch.net import RESIDENTIAL_NET
    slow = StragglerLinkModel(up_lo=15.5 * MBPS, up_hi=25.3 * MBPS,
                              down_lo=36.5 * MBPS, down_hi=121.0 * MBPS,
                              straggler_frac=0.08, up_slowdown=32.0)
    base = dict(time_engine="event", net=RESIDENTIAL_NET, link_model=slow,
                evolve_overlay=True)
    acfg = AsyncConfig(**base) if slots is None else AsyncConfig(
        buffer_k=4, max_staleness=3, overlap=True, round_slots=slots,
        **base)
    cfg = _fl_config(local=dict(epochs=1, lr=0.001), **FL_ASYNC)
    with obs.recording() as rec, FairshareTimer() as ft:
        t0 = time.perf_counter()
        res = run_async_experiment(cfg, acfg, device=device)
        host_s = time.perf_counter() - t0
    want = "cpu" if device == "cpu" else "cuda"
    check(res.session.device.type == want,
          f"async: the fair shares were solved on {res.session.device}")
    got = (res.session.cfg.chunks_per_update, round(res.wall_s[-1], 1),
           res.staleness_hist, res.dropped)
    label = "sync" if slots is None else f"round_slots {slots}"
    check(got == FL_ASYNC_REF[slots],
          f"async {label}: (K, wall_s, staleness_hist, dropped) {got} != "
          f"{FL_ASYNC_REF[slots]}")
    check(all(math.isfinite(a) for a in res.accuracy) and res.agreement,
          f"async {label}: accuracies {res.accuracy}")
    solves = int(rec.metrics.get("fairshare.maxmin_calls",
                                 {"value": 0})["value"])
    acc = float(np.mean(res.accuracy[-3:]))
    log(f"async frontier {label} (n {cfg.n_clients}, K {got[0]}, "
        f"{cfg.rounds} rounds): wall {res.wall_s[-1]:.1f} s, accuracy "
        f"{acc:.4f} (last 3), staleness {res.staleness_hist}, dropped "
        f"{res.dropped}, merged {res.merged}; host {host_s:.2f} s, of it "
        f"fair-share {ft.seconds:.2f} s ({solves} solves, "
        f"{1e6 * ft.seconds / max(solves, 1):.1f} us a solve)")
    return {"wall_s": res.wall_s[-1], "acc": acc,
            "staleness_hist": {str(k): v for k, v in
                               res.staleness_hist.items()},
            "dropped": res.dropped, "host_s": host_s,
            "fairshare_s": ft.seconds, "solves": solves}


def run_fl_paths(device=None) -> dict:
    """The FL phase: Table II's fast rows (``FL_DISTS``; mlp with all three
    methods, the cnn with CFL and FLTorrent), each FLTorrent trajectory
    held to CFL's and the first dist's FLTorrent held to the same run on
    the CPU; the churn run; the async frontier (``FL_ASYNC_SLOTS``).
    ``device`` None is the card; ``"cpu"`` rehearses on the CPU.  TF32 is
    left at torch's default (cuDNN on) during the phase: the runners must
    turn it off themselves.  Returns the rows and times."""
    import torch
    t_phase = time.perf_counter()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = {"table2": {f"{model}/{dist}": run_table2(model, dist, device)
                          for model in FL_ROUNDS for dist in FL_DISTS}}
        check(torch.backends.cudnn.allow_tf32,
              "the runners did not restore the caller's TF32 flag")
        out["churn"] = run_fl_churn(device)
        out["async"] = {"sync" if s is None else f"round_slots{s}":
                        run_fl_async(s, device) for s in FL_ASYNC_SLOTS}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"FL phase: {out['phase_s']:.1f} s")
    return out


# ----------------------------------------------------------------------
# the multi-rank layer: the torrent ring, the expert-parallel MoE
# ----------------------------------------------------------------------

# (label, D, P, n_blocks): the ring at qwen3-1.7b's and xlstm-350m's
# update widths, each compressed and not
RING_LOCAL_CASES = (("qwen3-1.7b", FULL_D, 2, 4), ("qwen3-1.7b", FULL_D, 2, 16),
                    ("xlstm-350m", SWARM_D, 4, 4),
                    ("xlstm-350m", SWARM_D, 4, 16))
MOE_EP_TOKENS = 8192            # one of _moe_ffn's token blocks
MOE_EP_RANKS = (4, 8)           # virtual model ranks
MOE_EP_TOL = 1e-2               # bf16
NCCL_MAX_RANKS = 4
RING_NCCL_D = 1 << 28           # torrent_fedavg's row on each NCCL rank
RING_NCCL_STEPS = 2
RING_NCCL_TIMEOUT = 420       # seconds for all ranks


def _ring_weights(p: int, device):
    """FedAvg weights 1..P, pod 2 masked where P > 2."""
    import torch
    w = torch.arange(1, p + 1, dtype=torch.float32, device=device)
    a = torch.ones(p, device=device)
    if p > 2:
        a[2] = 0.0
    return w, a


def ring_local_case(label: str, d: int, p: int, nb: int, comp: bool,
                    device="cuda") -> dict:
    """P virtual pod ranks of the torrent ring on this device
    (``LocalTransport``) over seeded (P, D) f32 rows: every rank's
    aggregate equal bit for bit to every other's and to
    ``aggregate_blocks`` on the same rows; (P - 1) x n_blocks (+ P - 1)
    sends and receives a rank; ``chunk_quantize`` once a rank,
    ``chunk_dequantize`` once a stage and ``fedavg_reduce`` once a rank
    (counted from 0 around the ring).  Returns seconds, peak memory and
    bytes on the wire."""
    import torch

    from repro_torch.dist import torrent
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import flatten

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        free_cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(d % 1000 + 10 * p + nb)
    rows = torrent.alloc_blocks(p, d, nb, dev)
    rows.view(p, -1)[:, :d].normal_(generator=gen)
    w, a = _ring_weights(p, dev)
    what = f"ring {label} P={p} n_blocks={nb} compress={comp}"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    torrent.reset_p2p()
    reset_launches()
    t0 = time.perf_counter()
    aggs = torrent.ring_fedavg(torrent.LocalTransport(p), list(rows), w, a,
                               compress=comp)
    sync()
    secs = time.perf_counter() - t0
    launches, p2p = dict(LAUNCHES), dict(torrent.P2P)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    meta = (flatten(rows)[1], [(d,)], [torch.float32], d)
    want = torrent.aggregate_blocks(rows, meta, w, a, compress=comp)
    del rows
    for i, agg in enumerate(aggs):
        check(torch.equal(agg, aggs[0]),
              f"{what}: virtual rank {i}'s aggregate differs from rank 0's")
        check(torch.equal(agg[:d], want),
              f"{what}: virtual rank {i}'s aggregate differs from "
              "aggregate_blocks on the same rows")
    del aggs, want
    sends = (p - 1) * (nb + comp)
    for i in range(p):
        check(p2p.get(("send", i)) == sends and p2p.get(("recv", i)) == sends,
              f"{what}: P2P {p2p}, not {sends} sends and receives a rank")
    if cuda:
        want_launches = {"fedavg_reduce": p}
        if comp:
            want_launches.update(chunk_quantize=p, chunk_dequantize=p * p)
        check(launches == want_launches,
              f"{what}: launches {launches}, not {want_launches}")
    db = -(-d // nb)
    wire = (p - 1) * (nb * db * (1 if comp else 4) + (4 * nb if comp else 0))
    row = {"case": label, "D": d, "P": p, "n_blocks": nb, "compress": comp,
           "p2p_sends_a_rank": sends, "wire_bytes_a_rank": wire,
           "seconds": secs, "peak_gb": peak,
           "launches": launches}
    log(f"{what}: {p} ranks bit-equal to aggregate_blocks; {sends} sends "
        f"a rank, {wire / 1e9:.3f} GB on the wire a rank; {secs:.3f} s; "
        f"peak {peak:.2f} GB; launches {launches}")
    if cuda:
        free_cuda()
    return row


def check_transport_refusals() -> dict:
    """The process-group transport refuses a tensor on the wrong kind of
    device: a CUDA tensor on a gloo group, a CPU tensor on an NCCL
    group (one-rank groups in this process; no collective runs)."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.dist import torrent
    out = {}
    root = ROOT / "build" / "rendezvous"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for backend, wrong in (("gloo", "cuda"), ("nccl", "cpu")):
        dist.init_process_group(backend, init_method=f"file://{root}/"
                                f"{backend}", rank=0, world_size=1)
        try:
            transport = torrent.GroupTransport(dist.group.WORLD, [0], 0)
            t = torch.zeros(8, device=wrong)
            try:
                transport.shift([[t]], [[t]])
                refused = None
            except ValueError as e:
                refused = str(e)
        finally:
            dist.destroy_process_group()
        check(refused is not None,
              f"a {wrong} tensor travelled over a {backend} group")
        out[backend] = refused
        log(f"{backend} group refuses a {wrong} tensor: {refused}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def run_ring_local() -> dict:
    """The ring_local phase: ``RING_LOCAL_CASES`` compressed and not,
    then the transport's refusals."""
    t0 = time.perf_counter()
    rows = [ring_local_case(label, d, p, nb, comp)
            for label, d, p, nb in RING_LOCAL_CASES
            for comp in (False, True)]
    refusals = check_transport_refusals()
    out = {"phase": "ring_local", "rows": rows, "refusals": refusals,
           "phase_s": time.perf_counter() - t0}
    log(f"ring_local phase: {out['phase_s']:.1f} s")
    return out


def check_moe_ep_local(device="cuda", tokens: int = MOE_EP_TOKENS) -> dict:
    """olmoe-1b-7b's MoE FFN at full width (d_model 2048, 64 experts of
    1024, top 8, bf16, the config's capacity factor) on ``tokens``
    seeded tokens: the bf16 sum of ``ms`` virtual model ranks'
    ``_moe_local_block`` outputs (what the expert-parallel path's
    ``all_reduce`` adds), for each ``MOE_EP_RANKS``, against
    ``_moe_ffn`` within 1e-2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import (_moe_ffn, _moe_local_block,
                                           init_layer)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = get_config("olmoe-1b-7b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    p = init_layer(cfg, "moe", gen, dev)
    x = torch.randn((tokens, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    out = {"phase": "moe_ep_local", "tokens": tokens,
           "capacity_factor": cfg.capacity_factor, "ranks": {}}

    def ffn():
        return _moe_ffn(cfg, p, x.view(1, tokens, -1)).view(tokens, -1)

    def ranks_sum(ms: int):
        """The bf16 sum of ms ranks' local blocks, as the all_reduce."""
        e_loc = cfg.n_experts // ms
        got = None
        for g in range(ms):
            mine = slice(g * e_loc, (g + 1) * e_loc)
            y = _moe_local_block(cfg, x, p["router"], p["moe_gate"][mine],
                                 p["moe_up"][mine], p["moe_down"][mine], g)
            got = y if got is None else got + y
        return got

    with torch.no_grad():
        want = ffn()
        out["moe_ffn_ms"] = time_ms(ffn) if cuda else None
        for ms in MOE_EP_RANKS:
            got = ranks_sum(ms)
            err = _close_err(got, want, MOE_EP_TOL, MOE_EP_TOL,
                             f"olmoe expert-parallel MoE over {ms} ranks")
            t = time_ms(lambda: ranks_sum(ms)) if cuda else None
            out["ranks"][ms] = {"max_abs_err": err, "all_ranks_ms": t}
            log(f"olmoe MoE over {ms} virtual model ranks "
                f"({cfg.n_experts // ms} experts each, {tokens} tokens): "
                f"max abs err {err:.3e} against _moe_ffn; all ranks' "
                f"local blocks {t} ms (_moe_ffn {out['moe_ffn_ms']} ms; "
                "CUDA events, median of 10)")
    del p, x, want, got
    if cuda:
        free_cuda()
    return out


def check_remat_binding(device="cuda") -> dict:
    """The model's checkpoints (``layers.checkpointed``) carry the
    ``axis_rules`` binding into the recomputation, which autograd runs
    on a device thread of its own for CUDA tensors, where a plain
    checkpoint's recomputation finds no binding (and the MoE would
    choose its route anew).  Returns the threads and the meshes seen."""
    import threading

    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.layers import checkpointed
    from repro_torch.sharding.api import (DEFAULT_RULES, axis_rules,
                                          current_rules)
    mesh = "stand-in mesh"

    def seen_by(ckpt):
        seen = []

        def fn(x):
            state = current_rules()
            seen.append((threading.get_ident(),
                         None if state is None else state[1]))
            return x.sin()

        x = torch.ones(8, device=device, requires_grad=True)
        with axis_rules(DEFAULT_RULES, mesh):       # as the FL step
            ckpt(fn, x).sum().backward()
        check(len(seen) == 2, f"checkpoint ran its function {len(seen)} "
              "times, not twice")
        return seen

    ours = seen_by(checkpointed)
    plain = seen_by(lambda f, x: checkpoint(f, x, use_reentrant=False))
    out = {"recompute_on_another_thread": ours[1][0] != ours[0][0],
           "checkpointed_binding": ours[1][1] == mesh,
           "plain_checkpoint_binding": plain[1][1] == mesh}
    log(f"remat binding: {out}")
    check(ours[0][1] == mesh and ours[1][1] == mesh,
          f"checkpointed's recomputation lost the axis_rules binding: {out}")
    return out


def ring_nccl_rank(rank: int, world: int, tmp: str, device: str = "cuda",
                   reduced: bool = False) -> None:
    """One rank of the ring_nccl phase (a process of its own): the pod
    ring of ``torrent_fedavg(mesh=)`` and ``RING_NCCL_STEPS`` pod-parallel
    steps of qwen3-1.7b, written to ``tmp/rank<r>.json``; rank 0 also
    runs the single-device path on its device and compares."""
    import os

    sys.path.insert(0, str(ROOT / "src"))
    os.environ["LOCAL_RANK"] = str(rank)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import torrent
    from repro_torch.dist.fl_step import make_fl_train_step
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_pod_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant_lr
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(device, init_method=f"file://{tmp}/rendezvous",
                           rank=rank, world_size=world)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    mesh = make_pod_mesh(world)
    log(f"rank {rank}: {dev}, {dist.get_backend()}, {mesh}")
    out: dict = {"rank": rank, "device": str(dev), "ring": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = 4096 if reduced else RING_NCCL_D
    ups = {"u": torch.randn((world, d), generator=gen, device=dev)}
    w, a = _ring_weights(world, dev)
    for comp in (False, True):
        torrent.reset_p2p()
        sync()
        t0 = time.perf_counter()
        agg = torrent.torrent_fedavg(ups, w, a, mesh=mesh,
                                     n_blocks=TORRENT_BLOCKS, compress=comp)
        sync()
        secs = time.perf_counter() - t0
        single = torrent.torrent_fedavg(ups, w, a, n_blocks=TORRENT_BLOCKS,
                                        compress=comp)
        out["ring"][str(comp)] = {
            "equal_single": bool(torch.equal(agg["u"], single["u"])),
            "sum": float(agg["u"].double().sum()),
            "p2p": [torrent.P2P["send", rank], torrent.P2P["recv", rank]],
            "seconds": secs}
        log(f"rank {rank}: ring compress={comp} {out['ring'][str(comp)]}")
    del ups, agg, single

    cfg = get_config("qwen3-1.7b", reduced=reduced)
    b_local, seq = (2, 16) if reduced else (1, 512)

    def steps(m):
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        params = init_params(cfg, g)
        opt = adamw_init(params)
        step = make_fl_train_step(cfg, m, lr_schedule=constant_lr(1e-4),
                                  n_pods=world,
                                  torrent_blocks=TORRENT_BLOCKS)
        rng = np.random.default_rng(1)
        ones = torch.ones(world, device=dev)
        losses, secs = [], []
        for _ in range(RING_NCCL_STEPS):
            batch = train.synthetic_batch(rng, world, b_local, seq,
                                          cfg.vocab, device=dev)
            sync()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch, ones, ones)
            losses.append(float(met["loss"]))
            sync()
            secs.append(time.perf_counter() - t0)
            log(f"rank {rank}: {'ring' if m else 'single-device'} step "
                f"loss {losses[-1]:.4f}, {secs[-1]:.3f} s")
        # params and the f32 master, m and v: m and v carry the
        # aggregated gradients themselves
        return (params, opt.master, opt.m, opt.v), losses, secs

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, secs = steps(mesh)
    out["steps"] = {"losses": losses, "seconds": secs,
                    "sum": [sum(float(l.double().sum()) for l in leaves(t))
                            for t in state]}
    if dev.type == "cuda":
        out["steps"]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if rank == 0:
        # the ring's state waits on the host while the single-device
        # path, which holds all P rows, runs on the card
        state = [x.cpu() for x in leaves(state)]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref, ref_losses, _ = steps(None)
        out["single"] = {
            "losses": ref_losses,
            "max_abs_diff": max(float((x.to(dev).float() - y.float())
                                      .abs().max())
                                for x, y in zip(state, leaves(ref)))}
        del ref
    del state
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank process; once one fails or ``timeout``
    seconds pass, kill the rest (a rank blocked in a collective whose
    peer died would wait out the process group's own timeout).
    Returns the exit codes, None for a rank killed at the timeout."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if (all(c is not None for c in codes)
                    or any(c not in (None, 0) for c in codes)
                    or time.monotonic() > deadline):
                return codes
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_ring_nccl(device: str = "cuda", ranks: int | None = None,
                  reduced: bool = False) -> dict:
    """The ring_nccl phase: with two or more GPUs, min(count, 4) NCCL
    ranks, one process a GPU (``ring_nccl_rank``), each held to the
    single-device path; with one, a line that says it did not run.
    ``device="cpu"`` with ``ranks`` rehearses it over gloo ranks."""
    import shutil

    import torch
    gpus = torch.cuda.device_count() if device == "cuda" else 0
    if ranks is None:
        if gpus < 2:
            out = {"phase": "ring_nccl", "ran": False, "gpus": gpus}
            log(json.dumps(out))
            return out
        ranks = min(gpus, NCCL_MAX_RANKS)
    tmp = ROOT / "build" / "ring_nccl"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(ranks)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c.ring_nccl_rank({r}, {ranks}, {str(tmp)!r}, {device!r}, "
             f"{reduced})"], cwd=str(ROOT), stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(ranks)]
        codes = wait_ranks(procs, RING_NCCL_TIMEOUT)
    finally:
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        check(code == 0, f"ring_nccl rank {r} exited {code}:\n"
              + (tmp / f"rank{r}.log").read_text()[-3000:])
    res = [json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(ranks)]
    shutil.rmtree(tmp, ignore_errors=True)
    sends = (ranks - 1) * TORRENT_BLOCKS
    for comp in ("False", "True"):
        rows = [r["ring"][comp] for r in res]
        check(all(x["equal_single"] for x in rows),
              f"ring_nccl compress={comp}: a rank's torrent_fedavg(mesh=) "
              "differs from the single-device path")
        check(len({x["sum"] for x in rows}) == 1,
              f"ring_nccl compress={comp}: ranks' aggregates differ")
        want = sends + (ranks - 1) * (comp == "True")
        check(all(x["p2p"] == [want, want] for x in rows),
              f"ring_nccl compress={comp}: P2P {[x['p2p'] for x in rows]}, "
              f"not {want}")
    check(len({tuple(r["steps"]["sum"]) for r in res}) == 1,
          "ring_nccl: ranks' params or optimizer states differ after the "
          "pod-parallel steps")
    check(len({tuple(r["steps"]["losses"]) for r in res}) == 1,
          "ring_nccl: ranks' losses differ")
    single = res[0]["single"]
    got = res[0]["steps"]["losses"]
    check(all(math.isfinite(x) for x in got), f"ring_nccl losses {got}")
    # Each rank runs the single-device path's kernels on the same rows,
    # fills the ring's buffer in the same order and aggregates it with
    # the same fedavg_reduce: the losses, params and f32 optimizer
    # states are the single-device ones bit for bit.  (Adam normalises
    # its step to about lr an element, so a tolerance on the params
    # alone would pass any gradient.)
    check(got == single["losses"],
          f"ring_nccl losses {got} against single-device "
          f"{single['losses']}")
    check(single["max_abs_diff"] == 0.0,
          "ring_nccl params or optimizer state differ from the "
          f"single-device path by {single['max_abs_diff']:.3e}")
    out = {"phase": "ring_nccl", "ran": True, "gpus": gpus,
           "ranks": ranks, "backend": "nccl" if device == "cuda" else "gloo",
           "ring": {c: [r["ring"][c] for r in res]
                    for c in ("False", "True")},
           "steps": [r["steps"] for r in res], "single": single,
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(out))
    return out


# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------

DRYRUN_ARCH = "qwen3-1.7b"
DRYRUN_BATCH = 2                # sequences of one pod's fidelity step
DRYRUN_SEQ = 4096
DRYRUN_MEM_TOL = 0.10           # forecast peak vs max_memory_allocated
DRYRUN_LIMIT_S = 120            # the phase's share of the script's time
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16


def run_dryrun_paths(device: str = "cuda", reduced: bool = False,
                     cell: bool = True) -> dict:
    """The dryrun phase: the fake trace of one pod's step against the
    same step on the card (counts equal, peak forecast within
    ``DRYRUN_MEM_TOL``), its achieved TFLOP/s, then one production
    cell.  ``device="cpu", reduced=True`` rehearses it on the CPU (the
    memory check then holds the two counters' peaks equal)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import dryrun
    from repro_torch.launch.flops import model_flops

    t0 = time.perf_counter()
    cuda = device == "cuda"
    cfg = get_config(DRYRUN_ARCH, reduced=reduced)
    shape = ShapeSpec("fidelity", 64 if reduced else DRYRUN_SEQ,
                      DRYRUN_BATCH, "train")
    if cuda:
        free_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    res = dryrun.fake_and_real(cfg, shape, device=device)
    fake, real = res["fake"], res["real"]
    peak = (torch.cuda.max_memory_allocated() - base if cuda
            else real.peak_bytes)
    for what, a, b in (("flops", fake.costs.flops, real.costs.flops),
                       ("hbm bytes", fake.costs.hbm_bytes,
                        real.costs.hbm_bytes),
                       ("ops", fake.n_ops, real.n_ops),
                       ("collectives", fake.costs.coll_counts,
                        real.costs.coll_counts)):
        check(a == b, f"dryrun fidelity: fake {what} {a} != real {b}")
    forecast = fake.peak_bytes
    mem_err = abs(forecast - peak) / peak
    check(mem_err <= DRYRUN_MEM_TOL,
          f"dryrun fidelity: forecast peak {forecast} vs the card's "
          f"{peak} ({mem_err:.1%} off)")
    step, args, counted_s = res["step"], res["real_args"], res["step_s"]
    del res
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = step(*args)
    if cuda:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    loss = float(out[2]["loss"])
    check(math.isfinite(loss), f"dryrun fidelity: loss {loss}")
    del out, args, step
    mf = model_flops(cfg, shape)
    terms = ca.roofline_terms(fake.costs, model_flops_global=mf, n_chips=1)
    bound_s = max(terms["t_compute_s"], terms["t_memory_s"],
                  terms["t_collective_s"])
    card = card_line() if cuda else "cpu"
    fid = {"arch": DRYRUN_ARCH, "tokens": shape.global_batch
           * shape.seq_len, "flops": fake.costs.flops,
           "hbm_bytes": fake.costs.hbm_bytes, "ops": fake.n_ops,
           "forecast_peak_bytes": forecast, "peak_bytes": peak,
           "peak_err": mem_err, "counted_step_s": counted_s,
           "step_s": step_s, "loss": loss, "model_flops": mf,
           "achieved_tflops": mf / step_s / 1e12,
           "share_of_989": mf / step_s / BF16_FLOPS_PER_S,
           "roofline_bound_s": bound_s, "dominant": terms["dominant"],
           "bound_over_measured": bound_s / step_s, "card": card}
    log(json.dumps({"phase": "dryrun_fidelity", **fid}))
    del fake, real
    if cuda:
        free_cuda()
    rec = None
    if cell:
        rec = dryrun.run_cell(DRYRUN_ARCH, "train_4k", True, device=device,
                              verbose=False)
        check(rec["status"] == "ok", f"dryrun cell: {rec}")
        log(json.dumps({"phase": "dryrun_cell", **rec}))
    secs = time.perf_counter() - t0
    log(f"dryrun phase: {secs:.1f} s")
    if cuda:
        check(secs <= DRYRUN_LIMIT_S,
              f"dryrun phase took {secs:.1f} s > {DRYRUN_LIMIT_S} s")
    return {"fidelity": fid, "cell": None if rec is None else {
        k: rec[k] for k in ("arch", "shape", "mesh", "n_chips",
                            "trace_seconds", "memory", "cost")}
        | {"roofline": {k: rec["roofline"][k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "roofline_fraction", "useful_mfu_bound")}},
        "seconds": secs}


def main() -> int:
    t_start = time.perf_counter()
    try:
        setup()
        import torch
        card = card_line()
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"python {sys.version.split()[0]}")
        log(f"kernel build: {build():.1f} s")
        check_small()
        check_small_serving()
        check_small_mlstm()
        check_small_slots()
        check_small_slot_rounds()
        train_counts = {arch: run_train_path(arch, d, steps, comp)
                        for arch, d, steps, comp in TRAIN_PATHS}
        serve_counts, served = run_serving_path()
        check_serving_vs_plain(served)
        rows = check_full_shapes(train_counts)
        rows += check_full_shapes_serving(serve_counts)
        rows += check_full_shape_rglru(serve_counts)
        rows += check_full_shape_mlstm(serve_counts)
        check_full_moe_ffn()
        check_small_step_vs_cpu()
        check_small_serve_vs_cpu()
        check_swarm_goldens()
        run_swarm_paper_scale()
        _, swarm_rows = run_swarm_path()
        rows += swarm_rows
        slot, slot_rows = run_slot_engine_paths()
        rows += slot_rows
        event = run_event_paths()
        fl = run_fl_paths()
        ring = run_ring_local()
        moe_ep = check_moe_ep_local()
        moe_ep["remat_binding"] = check_remat_binding()
        dry = run_dryrun_paths()
        nccl = run_ring_nccl()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"slot_engine": slot, "card": card}))
    log(json.dumps({"event_paths": event, "card": card}))
    log(json.dumps({"fl_paths": fl, "card": card}))
    log(json.dumps({"ring_local": ring, "card": card}))
    log(json.dumps({"moe_ep_local": moe_ep, "card": card}))
    log(json.dumps({"ring_nccl": nccl, "card": card}))
    log(json.dumps({"dryrun": dry, "card": card}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
