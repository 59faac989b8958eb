"""The benchmark's spans around calls into the program, the arguments
of chosen calls, and the reading of a ``torch.profiler`` trace.

A span wraps a function the program looks up by module global (so the
program's own calls go through it): on a CUDA device it records a CUDA
event before and after the call on the current stream (stream time,
read once the window has synchronised), on the CPU the host clock; it
also opens ``record_function("flbench.<span>")`` so that a profiler
trace shows what the host was in.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
import time

import torch

ANNOTATION = "flbench."


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    """Replace ``module.attr`` by ``make(original)`` for the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


class Spans:
    """Per-round stream time of named spans."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: list = []        # (span, start, end) of this round
        self.rounds: list = []         # one list of pending per round

    def wrap(self, name: str):
        def make(fn):
            def timed(*args, **kw):
                with torch.profiler.record_function(ANNOTATION + name):
                    if self.cuda:
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        a.record()
                        out = fn(*args, **kw)
                        b.record()
                    else:
                        a = time.perf_counter()
                        out = fn(*args, **kw)
                        b = time.perf_counter()
                self.pending.append((name, a, b))
                return out
            return timed
        return make

    def end_round(self) -> None:
        self.rounds.append(self.pending)
        self.pending = []

    def per_round_ms(self) -> dict:
        """span -> [ms of each round] (the span's calls summed); call
        after the device has synchronised."""
        names = {n for r in self.rounds for n, _, _ in r}
        out = {n: [] for n in names}
        for r in self.rounds:
            tot = dict.fromkeys(names, 0.0)
            for n, a, b in r:
                tot[n] += (a.elapsed_time(b) if self.cuda
                           else (b - a) * 1e3)
            for n in names:
                out[n].append(tot[n])
        return out


class Calls:
    """The tensor shapes, dtypes and element sizes of each call of
    chosen functions, while ``on``."""

    def __init__(self):
        self.on = False
        self.seen: dict = {}

    def wrap(self, key: str):
        def make(fn):
            def recorded(*args, **kw):
                if self.on:
                    self.seen.setdefault(key, []).append(
                        [(tuple(a.shape), a.element_size())
                         for a in list(args) + list(kw.values())
                         if isinstance(a, torch.Tensor)])
                return fn(*args, **kw)
            return recorded
        return make


def kernel_name(full: str) -> str:
    """``void (anonymous namespace)::fedavg_reduce_kernel<float>(...)``
    -> ``fedavg_reduce_kernel``."""
    s = full.removeprefix("void ").replace("(anonymous namespace)", "anon")
    for sep in "(<":
        s = s.split(sep)[0]
    return s.split("::")[-1].strip() or full


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(prof) -> dict:
    """Device activity of a profiled stretch, from the profiler's Chrome
    trace: the union of device intervals within the benchmark's
    outermost ``flbench.round`` annotations (busy seconds, the stretch's
    seconds), device seconds by kernel name, and the idle gaps, each
    named by the benchmark span and the host operation the host was in
    when the gap began.  Empty when the trace holds no device event."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, ann, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(iv + (cat,))
        elif cat == "user_annotation" and e["name"].startswith(ANNOTATION):
            ann.append(iv)
        elif cat == "cpu_op":
            ops.append(iv)
    rounds = [a for a in ann if a[2] == ANNOTATION + "round"]
    if not dev or not rounds:
        return {}
    t0 = min(a[0] for a in rounds)
    t1 = max(a[1] for a in rounds)
    kernels: dict = {}
    for s, e, name, cat in dev:
        key = kernel_name(name) if cat == "kernel" else cat
        kernels[key] = kernels.get(key, 0.0) + (e - s) * 1e-6
    busy, gaps = 0.0, []
    cur = t0
    for s, e, _, _ in sorted(dev):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if e > cur:
            busy += e - cur
            cur = e
    if cur < t1:
        gaps.append((cur, t1))

    def inner(ivs, t, strip=0):
        """The shortest interval holding t: what the host was in."""
        hits = [(e - s, name) for s, e, name in ivs if s <= t < e]
        return min(hits)[1][strip:] if hits else "-"

    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[f"{inner(ann, s, len(ANNOTATION))} | {inner(ops, s)}",
              (e - s) * 1e-6] for s, e in gaps[:10]]
    return {"busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "kernels": kernels, "idle_gaps": named}
