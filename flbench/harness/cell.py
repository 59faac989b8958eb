"""One run of a cell on one device: set-up, the checked first rounds,
the measured window, the traced rounds, and the reference's check.

Set-up builds one program object (weights from the seed, AdamW state,
the ``ElasticFLStep``) and drives it through ``FIRST_ROUNDS`` rounds of
the window's own call and feed; those rounds warm every shape the
window uses and are the ones the reference follows.  The window then
runs back-to-back rounds until ``seconds`` have passed and closes with
the round in flight, so every round counted has finished.  Once the
window has closed and the peak memory is read, the program's state is
freed and the reference runs the first rounds again in f32.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from harness import check, flops, traffic, weights
from harness.tracing import Calls, Spans, patched, read_trace
from reference import fl_round

FIRST_ROUNDS = 3
TRACED_ROUNDS = 2
FL_STEP = "repro_torch.dist.fl_step"


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    chips: int
    tokens_per_round: int
    flops_per_round: float
    setup_s: float = 0.0
    rounds: int = 0
    window_s: float = 0.0
    peak_bytes: int = 0
    span_ms: dict = field(default_factory=dict)   # span -> [ms a round]
    trace: dict = field(default_factory=dict)     # tracing.read_trace
    calls: dict = field(default_factory=dict)     # key -> [[(shape, size)]]


def arch_config(arch: dict):
    from repro_torch.models import ArchConfig
    a = dict(arch)
    a["pattern"] = tuple(a["pattern"])
    return ArchConfig(**a)


class Program:
    """The system under test, built once from the seed."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.dist.fl_step import ElasticFLStep
        from repro_torch.optim import adamw_init
        from repro_torch.optim.schedules import constant_lr
        tr = cell.traffic
        if tr["weights"] != "equal" or tr["active"] != "all":
            raise ValueError("the harness drives equal weights, all pods "
                             "active")
        self.device = device
        self.seed = seed
        self.cfg = arch_config(cell.config["arch"])
        self.meta, self.specs = weights.layout(self.cfg)
        self.params = weights.tree(
            self.meta, weights.make_leaves(self.specs, seed, device))
        self.opt = adamw_init(self.params)
        self.step = ElasticFLStep(
            self.cfg, lr_schedule=constant_lr(tr["lr"]),
            mesh_factory=lambda p: None,
            torrent_blocks=tr["torrent_blocks"], compress=tr["compress"])
        self.ones = torch.ones(tr["pods"], device=device)
        self.pool = [{"inputs": torch.as_tensor(x, device=device),
                      "labels": torch.as_tensor(y, device=device)}
                     for x, y in traffic.batch_pool(tr, self.cfg.vocab,
                                                    seed)]
        self.n = 0

    def round(self) -> float:
        """One FL round on the next batch of the pool; its loss."""
        batch = self.pool[self.n % len(self.pool)]
        self.n += 1
        self.params, self.opt, m = self.step(self.params, self.opt, batch,
                                             self.ones, self.ones)
        return float(m["loss"])

    def first_rounds(self) -> tuple[dict, float]:
        """Drive the first rounds; the readings the reference's are
        compared with, and the seconds spent taking them."""
        from reference.fl_round import leaf_norms
        from reference.model import leaves
        pods, spent = [], []

        def take_rows(orig):
            def aggregate(blocks, meta, *args, **kw):
                # each pod's gradient row as the torrent takes it in
                t = time.perf_counter()
                like = leaves(self.params)
                pods.extend(leaf_norms(r, like)
                            for r in blocks.view(blocks.shape[0], -1))
                spent.append(time.perf_counter() - t)
                return orig(blocks, meta, *args, **kw)
            return aggregate

        with patched(FL_STEP, "aggregate_blocks", take_rows):
            loss = [self.round()]
        t = time.perf_counter()
        # the first m is (1 - b1) times the clipped gradient
        grad = [float(m.double().norm()) / (1 - fl_round.B1)
                for m in leaves(self.opt.m)]
        spent.append(time.perf_counter() - t)
        loss += [self.round() for _ in range(FIRST_ROUNDS - 1)]
        t = time.perf_counter()
        change = weights.change_norms(self.specs, self.seed,
                                      leaves(self.opt.master), self.device)
        spent.append(time.perf_counter() - t)
        return {"loss": loss, "pod_grad_norm": pods, "grad_norm": grad,
                "change_norm": change}, sum(spent)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_readings(cell, seed: int, device,
                       precision: str = "f32") -> dict:
    """The reference's readings of the first rounds, in f32 with TF32
    off (``precision="fp8"``: the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    cfg = arch_config(cell.config["arch"])
    meta, specs = weights.layout(cfg)
    params = weights.tree(meta, weights.make_leaves(specs, seed, device))
    pool = traffic.batch_pool(tr, cfg.vocab, seed)[:FIRST_ROUNDS]
    batches = [(torch.as_tensor(x, device=device),
                torch.as_tensor(y, device=device)) for x, y in pool]
    ones = [1.0] * tr["pods"]
    return fl_round.run_rounds(
        cell.config["arch"], params, batches, weights=ones, active=ones,
        n_blocks=tr["torrent_blocks"], compress=tr["compress"],
        lr=tr["lr"], precision=precision)


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, readers: dict) -> dict:
    """One run; returns the result line's fields (``checks`` last)."""
    tr = cell.traffic
    run = Run(chips=cell.chips, tokens_per_round=traffic.round_tokens(tr),
              flops_per_round=flops.train_flops(
                  cell.config["arch"], tr["pods"] * tr["rows_per_pod"],
                  tr["seq"]))
    spans, calls = Spans(device), Calls()
    hooks = []
    if trace:
        for mod in readers.values():
            for span, targets in getattr(mod, "SPANS", {}).items():
                hooks += [(m, f, spans.wrap(span)) for m, f in targets]
            hooks += [(m, f, calls.wrap(f"{m}:{f}"))
                      for m, f in getattr(mod, "CALLS", ())]
    with contextlib.ExitStack() as stack:
        for m, f, make in hooks:
            stack.enter_context(patched(m, f, make))
        prog = Program(cell, seed, device)
        prog_read, spent = prog.first_rounds()
        sync(device)
        run.setup_s = time.perf_counter() - t_start - spent
        spans.rounds, spans.pending = [], []
        failed, ends = 0, []
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("flbench.round"):
                loss = prog.round()
            ends.append(time.perf_counter())
            spans.end_round()
            run.rounds += 1
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        run.window_s = time.perf_counter() - t0
        print("round seconds (host clock, loss read):",
              [round(b - a, 4) for a, b in zip([t0] + ends, ends)],
              file=sys.stderr)
        if device.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(device)
        run.span_ms = spans.per_round_ms()
        if trace:
            run.trace, run.calls = _profile(prog, calls, device)
        del prog
    free(device)
    ref = reference_readings(cell, seed, device)
    found = check.gaps(prog_read, ref)
    ok, checks = check.judge(found, cell.limits)
    metrics = {}
    entries = cell.per_layer if trace else cell.end_to_end
    for m in entries:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": ok and failed == 0, "attempted": run.rounds,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        ops = sorted(run.trace["kernels"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [list(kv) for kv in ops[:10]],
                            "idle_gaps": run.trace["idle_gaps"]}
    checks["failed_rounds"] = {"value": failed, "limit": 0}
    out["checks"] = checks
    return out


def _profile(prog, calls: Calls, device) -> tuple[dict, dict]:
    """``TRACED_ROUNDS`` more rounds under ``torch.profiler``, the chosen
    calls' arguments kept; the trace's reading and the calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    calls.on = True
    with profile(activities=acts) as prof:
        for _ in range(TRACED_ROUNDS):
            with torch.profiler.record_function("flbench.round"):
                prog.round()
        sync(device)
    calls.on = False
    return read_trace(prof), calls.seen
