"""Multi-pod dry run: trace every (arch x shape x mesh) cell on one rank.

Port of ``repro/launch/dryrun.py``.  For each non-skipped cell the
dry run

    1. makes this process rank 0 of the production world (256 ranks for
       the 16 x 16 mesh, 512 for 2 x 16 x 16) on the ``fake`` backend
       (``launch.mesh.fake_world``): the counterpart of JAX's
       placeholder host devices;
    2. builds the step and its inputs as fake DTensors placed by the
       cell's specs (``launch.specs.build_cell``) under
       ``FakeTensorMode``, so nothing is allocated;
    3. runs the step once under ``launch.cost_analysis.CostCounter``:
       this rank's program, on its shards, with every collective it
       issues.  Success proves the placements are coherent (the
       counterpart of ``lower().compile()``); the counter gives the
       per-rank FLOPs, HBM bytes, collective bytes and the peak of live
       memory (the fits-per-device proof), and
    4. derives the three roofline terms at the H100's rates.

The traced path is the configurations' default (``attn_impl`` and
``rnn_impl`` "xla", the port's plain PyTorch path), which is what the
JAX dry run traces: attention takes the two-block sliding-window route
where JAX's does and recomputes its q blocks in backward as JAX's
``jax.checkpoint`` does (``kernels.ops.attention``).  Each cell is written to
``<out>/<arch>__<shape>__<mesh>.json``; a cell that fails is recorded
with ``status: fail`` and its error, and the run exits 1.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --device cpu \\
        --jobs 6

Without ``--device cpu`` the fake tensors claim the GPU, and with no
GPU the command raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no GPU: the dry run claims the GPU by default; "
                           "pass --device cpu to trace on the CPU")
    return dev


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             rules=None, sp: bool = False, microbatch: int = 0,
             torrent_blocks: int = 4, compress: bool = False,
             verbose: bool = True, cfg_overrides: dict | None = None,
             save_hlo: str = "", device: str = "cuda",
             shape=None, reduced: bool = False, mesh_shape=None) -> dict:
    """Trace one cell; returns its record.

    ``shape`` (a ``ShapeSpec``), ``reduced`` and ``mesh_shape`` (the
    (pod, data, model) sizes of a small mesh) size a cell down for
    tests; by default the cell is ``SHAPES[shape_name]`` of the full
    configuration on the production mesh.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, cell_skip_reason, get_config
    from repro_torch.launch.cost_analysis import CostCounter, roofline_terms
    from repro_torch.launch.flops import model_flops
    from repro_torch.launch.mesh import (fake_world, make_pod_mesh,
                                         make_production_mesh)
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding.api import DEFAULT_RULES, axis_rules

    mesh_name = "multi" if multi_pod else "single"
    skip = cell_skip_reason(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    dev = _device(device)
    cfg = get_config(arch, reduced=reduced)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name] if shape is None else shape
    if mesh_shape is None:
        n_chips = 512 if multi_pod else 256
    else:
        n_chips = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    use_rules = dict(DEFAULT_RULES if rules is None else rules)
    if sp:
        use_rules["seq"] = "model"   # Megatron-style sequence parallel
    t0 = time.time()
    with fake_world(n_chips, dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        else:
            mesh = make_pod_mesh(mesh_shape[0], data=mesh_shape[1],
                                 model=mesh_shape[2])
        # the device meshes hold real rank tensors: build them first
        mesh.dtensor_mesh
        mesh.submesh(("data", "model"))
        with FakeTensorMode():
            with axis_rules(use_rules, mesh):
                cell = build_cell(cfg, shape, mesh, rules=use_rules,
                                  microbatch=microbatch,
                                  torrent_blocks=torrent_blocks,
                                  compress=compress, device=dev)
            counter = CostCounter(fake=True, device=dev)
            counter.add_arguments(cell["args"])
            with counter, axis_rules(use_rules, mesh):
                out = cell["step"](*cell["args"])
            mem = counter.memory()
            del out, cell
    trace_s = time.time() - t0

    costs = counter.costs
    mf = model_flops(cfg, shape)
    terms = roofline_terms(costs, model_flops_global=mf, n_chips=n_chips)
    if save_hlo:
        with open(save_hlo, "w") as f:
            json.dump(counter.op_counts, f, indent=1, sort_keys=True)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips, "status": "ok",
        "trace_seconds": round(trace_s, 1),
        "memory": mem,
        "cost": {"flops": costs.flops,
                 "transcendentals": costs.transcendentals,
                 "hbm_bytes": costs.hbm_bytes,
                 "coll_bytes": costs.coll_bytes,
                 "coll_counts": costs.coll_counts,
                 "coll_bytes_by_link": costs.coll_bytes_by_link,
                 "n_ops": counter.n_ops},
        "roofline": terms,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "knobs": {"microbatch": microbatch,
                  "torrent_blocks": torrent_blocks,
                  "compress": compress,
                  "cache_dtype": cfg.cache_dtype or cfg.dtype,
                  "sp": sp, "device": dev.type,
                  "overrides": cfg_overrides or {}},
    }
    if verbose:
        gb = mem["total_per_device_bytes"] / 2**30
        print(f"[{mesh_name}] {arch} x {shape_name}: OK "
              f"({trace_s:.0f}s trace, {gb:.2f} GiB/device, "
              f"dominant={terms['dominant']}, "
              f"roofline_frac={terms['roofline_fraction']:.3f})",
              flush=True)
        print(f"  memory: {mem}", flush=True)
        print(f"  per device: flops={costs.flops:.3e} "
              f"hbm={costs.hbm_bytes:.3e} coll={costs.coll_bytes:.3e} "
              f"colls={costs.coll_counts}", flush=True)
    return rec


def fake_and_real(cfg, shape, *, device, seed: int = 0,
                  mesh=None) -> dict:
    """One pod's training step, traced under fake tensors and then run
    for real, each under a ``CostCounter``.

    The fidelity check of the dry run: the two counts must be equal,
    and the fake run's peak is the forecast of the real run's.  The
    real step gets random weights and tokens from ``seed``.  ``mesh``
    (default: one device) is a one-pod ``launch.mesh.DeviceMesh`` of
    this world; on a ``data`` x ``model`` grid both runs take DTensor
    parameters placed by the cell's specs, the real ones holding the
    local shards of the seeded weights.  Returns
    {"fake": counter, "real": counter, "step_s": seconds of the real
    step, "real_args": its inputs} (the caller frees the inputs, and
    reads the device's own peak around this call).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.api import (DEFAULT_RULES, axis_rules,
                                          distribute_tree)

    if shape.kind != "train":
        raise ValueError("the fidelity check runs a training step")
    dev = torch.device(device)
    mesh = make_pod_mesh(1) if mesh is None else mesh
    rules = dict(DEFAULT_RULES)
    # the device meshes hold real rank tensors: build them first
    submesh = mesh.submesh(("data", "model"))
    with FakeTensorMode():
        with axis_rules(rules, mesh):
            cell = build_cell(cfg, shape, mesh, device=dev)
        fake = CostCounter(fake=True, device=dev)
        fake.add_arguments(cell["args"])
        with fake, axis_rules(rules, mesh):
            out = cell["step"](*cell["args"])
        fake.final_memory = fake.memory()
        del out
    step, pspecs = cell["step"], cell["in_specs"][0]
    del cell

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = distribute_tree(init_params(cfg, gen), pspecs, submesh)
    opt = adamw_init(params)
    tokens = torch.randint(0, cfg.vocab, (1, shape.global_batch,
                                          shape.seq_len + 1),
                           generator=gen, device=dev)
    batch = {"inputs": tokens[..., :-1].contiguous(),
             "labels": tokens[..., 1:].contiguous()}
    ones = torch.ones((1,), dtype=torch.float32, device=dev)
    args = (params, opt, batch, ones, ones.clone())
    real = CostCounter(fake=False, device=dev)
    real.add_arguments(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with real, axis_rules(rules, mesh):
        out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    real.final_memory = real.memory()
    del out
    return {"fake": fake, "real": real, "step": step, "step_s": step_s,
            "real_args": args}


def _tag(arch, shape, multi) -> str:
    return f"{arch}__{shape}__{'multi' if multi else 'single'}"


def _record(args, arch, shape, multi) -> dict:
    """Run one cell in this process; a failure is recorded, not raised."""
    try:
        ov = ({"cache_dtype": args.cache_dtype}
              if args.cache_dtype else None)
        return run_cell(arch, shape, multi, sp=args.sp,
                        microbatch=args.microbatch,
                        torrent_blocks=args.torrent_blocks,
                        compress=args.compress, cfg_overrides=ov,
                        save_hlo=args.save_hlo, device=args.device)
    except Exception as e:   # record failures: they are bugs
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if multi else "single",
                "status": "fail", "error": repr(e)}


def _child_argv(args, arch, shape, multi) -> list:
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape,
            "--mesh", "multi" if multi else "single", "--out", args.out,
            "--microbatch", str(args.microbatch),
            "--torrent-blocks", str(args.torrent_blocks),
            "--device", args.device, "--child"]
    if args.compress:
        argv.append("--compress")
    if args.cache_dtype:
        argv += ["--cache-dtype", args.cache_dtype]
    if args.sp:
        argv.append("--sp")
    return argv


def table(out_dir: str) -> str:
    """A markdown table of the records in ``out_dir``: one row a cell,
    the 16 x 16 and 2 x 16 x 16 meshes side by side (GB a device,
    TFLOPs, HBM TB and collective GB a device, the dominant roofline
    term, the roofline fraction, trace seconds); skips and failures by
    name."""
    from repro_torch.configs import all_cells

    def rec(arch, shape, mesh):
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        return json.load(open(path)) if os.path.exists(path) else None

    def pair(arch, shape, fn):
        vals = []
        for mesh in ("single", "multi"):
            r = rec(arch, shape, mesh)
            vals.append("—" if r is None else r["status"]
                        if r["status"] != "ok" else fn(r))
        return " / ".join(vals)

    rows = ["| Arch | Shape | GB a device | TFLOP a device | HBM TB a "
            "device | Collective GB a device | Dominant | Roofline "
            "fraction | Trace s |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    skipped = []
    for arch, shape, skip in all_cells():
        if skip:
            skipped.append(f"{arch} {shape}")
            continue
        rows.append("| " + " | ".join([
            arch, shape,
            pair(arch, shape, lambda r: "%.2f" % (
                r["memory"]["total_per_device_bytes"] / 1e9)),
            pair(arch, shape, lambda r: "%.3g" % (r["cost"]["flops"]
                                                   / 1e12)),
            pair(arch, shape, lambda r: "%.3g" % (r["cost"]["hbm_bytes"]
                                                   / 1e12)),
            pair(arch, shape, lambda r: "%.3g" % (r["cost"]["coll_bytes"]
                                                   / 1e9)),
            pair(arch, shape, lambda r: r["roofline"]["dominant"]),
            pair(arch, shape, lambda r: "%.3f" % (
                r["roofline"]["roofline_fraction"])),
            pair(arch, shape, lambda r: "%.0f" % r["trace_seconds"]),
        ]) + " |")
    return "\n".join(rows) + "\n\nSkipped on both meshes: " + \
        "; ".join(skipped) + ".\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--torrent-blocks", type=int, default=4)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--save-hlo", default="",
                    help="write the traced op counts (JSON) here")
    ap.add_argument("--cache-dtype", default="")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism: shard the residual "
                         "stream seq dim over model")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim (cuda or cpu)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)   # one cell for a --jobs run
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table "
                         "and stop")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out), end="")
        return 0
    _device(args.device)

    from repro_torch.configs import all_cells

    if args.all:
        cells = [(a, s) for a, s, _ in all_cells()]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = [(a, s, m) for a, s in cells for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    recs = {}
    if args.jobs > 1 and len(todo) > 1:
        # one process a cell, so each has a fake world of its own; its
        # output goes to <out>/<tag>.log and is echoed when it ends.
        # The longest first: cells whose step loops over T in Python
        # (the sLSTM's recurrence) outside decode.
        from repro_torch.configs import SHAPES, get_config

        def slow(cell):
            return ("slstm" in get_config(cell[0]).pattern
                    and SHAPES[cell[1]].kind != "decode")
        running: list = []
        queue = sorted(todo, key=lambda c: not slow(c))
        while queue or running:
            while queue and len(running) < args.jobs:
                cell = queue.pop(0)
                log = open(os.path.join(args.out, _tag(*cell) + ".log"),
                           "w")
                running.append((cell, log, subprocess.Popen(
                    _child_argv(args, *cell), stdout=log,
                    stderr=subprocess.STDOUT, text=True)))
            done = [r for r in running if r[2].poll() is not None]
            if not done:
                time.sleep(0.5)
                continue
            for cell, log, proc in done:
                running.remove((cell, log, proc))
                log.close()
                path = os.path.join(args.out, _tag(*cell) + ".json")
                with open(log.name) as f:
                    print("".join(ln for ln in f if not ln.startswith(
                        ("[rank0]:W", "  warnings.warn"))), end="",
                        flush=True)
                recs[cell] = (json.load(open(path))
                              if os.path.exists(path)
                              and proc.returncode in (0, 1) else
                              {"arch": cell[0], "shape": cell[1],
                               "mesh": "multi" if cell[2] else "single",
                               "status": "fail",
                               "error": f"exit {proc.returncode}"})
    else:
        for cell in todo:
            recs[cell] = _record(args, *cell)
            with open(os.path.join(args.out, _tag(*cell) + ".json"),
                      "w") as f:
                json.dump(recs[cell], f, indent=1)
    if args.child:
        return 1 if recs[todo[0]]["status"] == "fail" else 0
    ok = skipped = failed = 0
    for arch, shape, multi in todo:
        rec = recs[arch, shape, multi]
        st = rec["status"]
        ok += st == "ok"
        skipped += st == "skip"
        failed += st == "fail"
        if st == "skip":
            print(f"[{rec['mesh']}] {arch} x {shape}: SKIP "
                  f"({rec['reason']})", flush=True)
        elif st == "fail":
            print(f"[{rec['mesh']}] {arch} x {shape}: FAIL "
                  f"({rec.get('error')})", flush=True)
    print(f"\ndry-run summary: {ok} ok / {skipped} skip / {failed} fail",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
