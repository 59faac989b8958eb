#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port (``src/repro_torch``)
and imports nothing of the JAX package:

1. prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/torch_kernels/`` and prints how long that took; beside that
   build it compiles ``csrc/attention.cu`` and ``csrc/mlstm.cu`` each
   alone with ``-Xptxas -v`` and prints their registers, shared memory
   and spills, then the number of ``HGMMA`` instructions in each
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
   C, n and m) and bf16 (3e-2), all finite;
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
   granite's D; ``torch.mul`` for
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
8. prints one ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

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


PTXAS_SOURCES = ("attention.cu", "mlstm.cu", "rglru.cu")


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
        for line in reports[src].splitlines():
            if "C7519" in line:          # ptxas fenced a wgmma's registers
                injected += 1
            elif any(w in line for w in ("entry function", "registers",
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

    from repro_torch.kernels import fedavg, quantize, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = []

    # fedavg over the gathered (P, D) f32 buffer
    for arch, d, _, _ in TRAIN_PATHS:
        n = PODS
        u = torch.randn((n, d), generator=gen, device=dev)
        w = torch.tensor([3.0, 1.0], device=dev)
        a = torch.ones(n, device=dev)
        got = fedavg.fedavg_reduce(u, w, a)
        # the plain version column block by column block (it is
        # separable over D), so its temporaries stay small
        cols = [slice(s0, s0 + (1 << 28)) for s0 in range(0, d, 1 << 28)]
        err = 0.0
        for c in cols:
            err = max(err, _close_err(got[c],
                                      ref.fedavg_reduce(u[:, c], w, a),
                                      FEDAVG_TOL, FEDAVG_TOL,
                                      f"fedavg full {arch}"))

        def plain_fedavg():
            for c in cols:
                ref.fedavg_reduce(u[:, c], w, a)

        wn = ref.masked_normalized_weights(w, a)
        ms = time_ms(lambda: fedavg.fedavg_reduce(u, w, a))
        plain = time_ms(plain_fedavg, runs=3)
        lib = time_ms(lambda: torch.matmul(wn, u), runs=10)
        nbytes = 4.0 * n * d + 4.0 * d
        ops = 2.0 * n * d                      # a multiply-add per value
        row = _row("fedavg_reduce", "csrc/fedavg.cu",
                   "src/repro/kernels/fedavg.py:60", train_counts[arch], err,
                   ms, plain, bound_ms(nbytes, ops), lib)
        row["shape"] = f"{arch}: ({n}, {d}) f32"
        rows.append(row)
        log(f"fedavg_reduce {arch} ({n}, {d}) f32: {ms:.3f} ms, "
            f"{nbytes / ms / 1e6:.1f} GB/s "
            f"({100 * bound_ms(nbytes)[0] / ms:.1f}% of HBM peak, bound "
            f"{bound_ms(nbytes)[0]:.3f} ms); plain {plain:.3f} ms; wn @ "
            f"updates {lib:.3f} ms; max err {err:.3e}")
        del u, got
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
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
