#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port (``src/repro_torch``)
and imports nothing of the JAX package:

1. prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/torch_kernels/`` and prints how long that took;
3. holds every kernel against its plain PyTorch version on the card:
   first at small and odd shapes and edge cases (zero mass, a masked
   NaN row, bf16 updates, ties, an all-zero row, non-finite rows), then
   at the federated train step's own shapes for qwen3-1.7b at full
   width with P = 2: fedavg over (2, 1,720,574,976) and quantize /
   dequantize over (8, 430,143,744).  Codes, scales and dequantized
   values must be equal; fedavg agrees to atol = rtol = 2e-5.  Each
   kernel is timed there with CUDA events (median of 10 runs after a
   warm-up) beside its bound (bytes it must move over the card's HBM
   rate), its plain version and, where there is one, the one PyTorch
   call that computes the same function (``wn @ updates`` for fedavg,
   ``torch.mul(q, s, out=...)`` for dequantize; none for quantize).
   These full-shape checks run after step 4, so their launches are not
   counted as the main path's;
4. sets the launch counters to 0 and runs the main path: the train
   driver for 4 uncompressed steps at full width and depth (P = 2,
   batch 8, seq 512), then 2 compressed steps of ``ElasticFLStep``; all
   losses must be finite and each kernel must have launched;
5. checks the step against a reference on a small input: the reduced
   qwen3 config trained 2 compressed steps on the card agrees with the
   same steps run on the CPU's plain versions;
6. prints one ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line is printed.  With
no CUDA device, or outside a checkout of the repository, it exits
non-zero at once.
"""
from __future__ import annotations

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
FULL_D = 1_720_574_976          # qwen3-1.7b parameter count
PODS = 2
TORRENT_BLOCKS = 4
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--full", "--pods", str(PODS),
             "--steps", "4", "--batch", "8", "--seq", "512"]
FEDAVG_TOL = 2e-5
BF16_TOL = 1e-2


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


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.extension()
    return time.perf_counter() - t0


# ----------------------------------------------------------------------
# timing helpers
# ----------------------------------------------------------------------

def time_ms(fn, runs: int = 10) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: the larger of its bytes (each input read
    once, each output written once) over the HBM rate and its f32
    operations over the card's f32 rate; and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_full_shapes(counts: dict) -> list[dict]:
    """Each kernel at the train step's shapes: compare, time, bound."""
    import torch

    from repro_torch.kernels import fedavg, quantize, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = []

    # fedavg over the gathered (P, D) f32 buffer
    n, d = PODS, FULL_D
    u = torch.randn((n, d), generator=gen, device=dev)
    w = torch.tensor([3.0, 1.0], device=dev)
    a = torch.ones(n, device=dev)
    got = fedavg.fedavg_reduce(u, w, a)
    # the plain version column block by column block (it is separable
    # over D), so its temporaries stay small
    cols = [slice(s0, s0 + (1 << 28)) for s0 in range(0, d, 1 << 28)]
    err = 0.0
    for c in cols:
        err = max(err, _close_err(got[c], ref.fedavg_reduce(u[:, c], w, a),
                                  FEDAVG_TOL, FEDAVG_TOL, "fedavg full"))

    def plain_fedavg():
        for c in cols:
            ref.fedavg_reduce(u[:, c], w, a)

    wn = ref.masked_normalized_weights(w, a)
    ms = time_ms(lambda: fedavg.fedavg_reduce(u, w, a))
    plain = time_ms(plain_fedavg, runs=3)
    lib = time_ms(lambda: torch.matmul(wn, u), runs=10)
    nbytes = 4.0 * n * d + 4.0 * d
    ops = 2.0 * n * d                      # a multiply-add per value
    rows.append(_row("fedavg_reduce", "csrc/fedavg.cu",
                     "src/repro/kernels/fedavg.py:60", counts, err, ms,
                     plain, bound_ms(nbytes, ops), lib))
    log(f"fedavg_reduce ({n}, {d}) f32: {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s "
        f"({100 * bound_ms(nbytes)[0] / ms:.1f}% of HBM peak); plain "
        f"{plain:.3f} ms; wn @ updates {lib:.3f} ms; max err {err:.3e}")
    del u, got
    free_cuda()

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
    log(f"chunk_quantize ({nq}, {e}) f32: {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s "
        f"({100 * bound_ms(nbytes)[0] / ms:.1f}% of HBM peak); plain "
        f"{plain:.3f} ms; codes and scales equal")

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

def run_main_path() -> dict:
    """Train driver (4 steps) + 2 compressed ElasticFLStep steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.fl_step import ElasticFLStep
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models import init_params, param_count
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant_lr

    dev = torch.device("cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hist: list = []
    train.main(MAIN_ARGV, history=hist)
    check(len(hist) == 4, f"train driver ran {len(hist)} steps, not 4")
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"non-finite loss in {[h['loss'] for h in hist]}")
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    log("train driver: losses "
        + ", ".join(f"{h['loss']:.4f}" for h in hist) + "; step s "
        + ", ".join(f"{h['seconds']:.3f}" for h in hist)
        + f"; peak memory {peak_a:.2f} GB")
    free_cuda()

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen3-1.7b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = init_params(cfg, gen)
    check(param_count(params) == FULL_D,
          f"qwen3-1.7b has {param_count(params)} params, not {FULL_D}")
    opt = adamw_init(params)
    step = ElasticFLStep(cfg, lr_schedule=constant_lr(1e-4),
                         torrent_blocks=TORRENT_BLOCKS, compress=True)
    rng = np.random.default_rng(1)
    ones = torch.ones(PODS, device=dev)
    comp = []
    for _ in range(2):
        batch = train.synthetic_batch(rng, PODS, 4, 512, cfg.vocab,
                                      device=dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, ones, ones)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        comp.append((loss, time.perf_counter() - t0))
    check(all(math.isfinite(l) for l, _ in comp),
          f"non-finite compressed loss in {comp}")
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    log("compressed ElasticFLStep: losses "
        + ", ".join(f"{l:.4f}" for l, _ in comp) + "; step s "
        + ", ".join(f"{t:.3f}" for _, t in comp)
        + f"; peak memory {peak_b:.2f} GB")
    counts = dict(LAUNCHES)
    del params, opt, step
    free_cuda()
    for name in ("fedavg_reduce", "chunk_quantize", "chunk_dequantize"):
        check(counts.get(name, 0) > 0,
              f"{name} never launched on the main path: {counts}")
    log(f"launches on the main path: {counts}")
    return counts


def check_small_step_vs_cpu() -> None:
    """Reduced qwen3, 2 compressed steps: the card (CUDA kernels)
    against the CPU (plain versions) from the same parameters."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.fl_step import make_fl_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant_lr
    from repro_torch.tree import tree_map

    cfg = get_config("qwen3-1.7b", reduced=True)
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
              f"reduced step on the card {runs['cuda']} vs CPU "
              f"{runs['cpu']}")
    log(f"reduced qwen3 P=3 compressed steps: card {runs['cuda']} == "
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
        counts = run_main_path()
        rows = check_full_shapes(counts)
        check_small_step_vs_cpu()
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
