"""End-to-end FL training driver on one device (GPU by default).

Port of ``repro/launch/train.py`` with the same CLI plus ``--device``
(default ``cuda``; with no GPU present the driver raises unless
``--device cpu`` is given).  It runs real FL rounds: per-pod local
gradients -> torrent aggregate (int8 round trip + masked FedAvg, on the
CUDA kernels on a GPU) -> AdamW, with round-boundary checkpointing and
restart (``--resume`` semantics: the latest checkpoint in ``--ckpt``).

On one card the P pods share the device through the single-device
torrent path, so there is no device-count check and the mesh factory
returns ``None``: a re-mesh is a new pod count for ``ElasticFLStep``.

``--drop-pod`` is the recovery drill: at ``--drop-at`` (default
steps/2) the run checkpoints, shrinks the collective from P to P-1
pods, reloads the checkpoint and continues, asserting loss continuity.
``--join-pod N`` is its growth twin: N fresh pods join at
``--join-at`` (default steps/2).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --full --pods 2 --steps 4 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --pods 4 \
        --drop-pod 2 --reduced --steps 12 --batch 8 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --arch granite-moe-1b-a400m --device cpu --pods 2 --steps 4 \
        --batch 4 --seq 32

Any arch of ``repro_torch.configs`` trains, the moe archs among them
(granite-moe-1b-a400m, olmoe-1b-7b; at full width one H100 holds
granite's training state, not olmoe's).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch


def synthetic_batch(rng: np.random.Generator, n_pods: int, b_local: int,
                    seq: int, vocab: int, *, frames: int = 0,
                    device=None):
    """Deterministic LM stream: next-token-predictable structured data.

    Draws the same numbers from ``rng`` as the JAX driver's
    ``synthetic_batch``, so both drivers see the same batches.
    """
    if frames:
        x = rng.normal(size=(n_pods, b_local, seq, frames)).astype(
            np.float32)
        y = rng.integers(0, vocab, size=(n_pods, b_local, seq))
        return {"inputs": torch.as_tensor(x, device=device),
                "labels": torch.as_tensor(y, device=device)}
    base = rng.integers(0, vocab, size=(n_pods, b_local, 1))
    step = rng.integers(1, 7, size=(n_pods, b_local, 1))
    seqs = (base + step * np.arange(seq + 1)) % vocab
    return {"inputs": torch.as_tensor(seqs[..., :-1], device=device),
            "labels": torch.as_tensor(seqs[..., 1:], device=device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, history: list | None = None):
    """Run the driver; returns the final loss, as the JAX driver does.

    ``history`` has no counterpart in ``repro/launch/train.py``: when it
    is a list, one dict per executed step (step, loss, lr, pods,
    seconds) is appended to it, so a caller such as ``chip_smoke.py``
    can read every step's loss and time without parsing the log.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--drop-pod", type=int, default=-1,
                    help="mid-run pod failure: checkpoint, shrink "
                         "P->P-1, continue (loss continuity asserted)")
    ap.add_argument("--drop-at", type=int, default=-1,
                    help="step of the pod failure (default steps/2)")
    ap.add_argument("--join-pod", type=int, default=0,
                    help="mid-run pod growth: N pods join, checkpoint, "
                         "grow P->P+N, continue (loss continuity "
                         "asserted)")
    ap.add_argument("--join-at", type=int, default=-1,
                    help="step of the pod join (default steps/2)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.checkpoint import (latest_round, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.dist.fl_step import ElasticFLStep
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import linear_warmup_cosine

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    n_pods = args.pods if args.pods > 1 else 1
    peak = n_pods + max(args.join_pod, 0)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    opt = adamw_init(params)
    start = 0
    active_pods = n_pods
    if args.ckpt:
        r = latest_round(args.ckpt)
        if r is not None:
            (params, opt), meta = load_checkpoint(args.ckpt, r,
                                                  (params, opt))
            start = r + 1
            # A checkpoint written after a drop records the shrunken
            # collective; resuming must not silently re-expand it.
            active_pods = int(meta.get("pods", n_pods))
            print(f"resumed from round {r} ({active_pods} pods)",
                  flush=True)

    def mesh_factory(p: int):
        return None                     # every pod on this one device

    step_fn = ElasticFLStep(
        cfg, lr_schedule=linear_warmup_cosine(
            args.lr, 10, max(args.steps, 20)),
        mesh_factory=mesh_factory)
    rng = np.random.default_rng(0)
    b_local = max(args.batch // n_pods, 1)
    frames = cfg.d_model if not cfg.has_embedding else 0

    drop_at = args.drop_at if args.drop_at >= 0 else args.steps // 2
    join_at = args.join_at if args.join_at >= 0 else args.steps // 2
    prev_loss = None
    check_continuity = False
    m = None
    t0 = time.perf_counter()
    for it in range(start, args.steps):
        if (args.drop_pod >= 0 and it == drop_at and active_pods > 1):
            # §III-E recovery drill: durable state at the boundary,
            # shrink the collective, continue.
            if args.ckpt:
                save_checkpoint(args.ckpt, it - 1, (params, opt),
                                meta={"arch": args.arch,
                                      "pods": active_pods - 1})
                (params, opt), _ = load_checkpoint(args.ckpt, it - 1,
                                                   (params, opt))
            active_pods -= 1
            check_continuity = True
            print(f"step {it:5d}  pod {args.drop_pod % n_pods} dropped: "
                  f"re-meshing {active_pods + 1} -> {active_pods} pods",
                  flush=True)
        if (args.join_pod > 0 and it == join_at
                and active_pods + args.join_pod <= peak):
            # §III-E growth drill, the drop's symmetric twin.
            if args.ckpt:
                save_checkpoint(args.ckpt, it - 1, (params, opt),
                                meta={"arch": args.arch,
                                      "pods": active_pods + args.join_pod})
                (params, opt), _ = load_checkpoint(args.ckpt, it - 1,
                                                   (params, opt))
            active_pods += args.join_pod
            check_continuity = True
            print(f"step {it:5d}  {args.join_pod} pod(s) joined: "
                  f"re-meshing {active_pods - args.join_pod} -> "
                  f"{active_pods} pods", flush=True)
        batch = synthetic_batch(rng, active_pods, b_local, args.seq,
                                cfg.vocab, frames=frames, device=device)
        ts = time.perf_counter()
        ones = torch.ones((active_pods,), device=device)
        params, opt, m = step_fn(params, opt, batch, ones, ones)
        loss = float(m["loss"])
        _sync(device)
        step_s = time.perf_counter() - ts
        if history is not None:
            history.append({"step": it, "loss": loss, "lr": float(m["lr"]),
                            "pods": active_pods, "seconds": step_s})
        if check_continuity:
            # Continuity across the re-mesh: same params, resized
            # collective; anything beyond noise means recovery broke.  A
            # re-mesh on the first executed step has nothing to compare.
            if prev_loss is not None:
                if not math.isfinite(loss) or loss > 3.0 * prev_loss + 0.5:
                    raise RuntimeError(
                        f"loss continuity broken across re-mesh: "
                        f"{prev_loss:.4f} -> {loss:.4f}")
                print(f"step {it:5d}  re-mesh continuity ok "
                      f"({prev_loss:.4f} -> {loss:.4f})", flush=True)
            check_continuity = False
        prev_loss = loss
        if it % args.log_every == 0 or it == args.steps - 1:
            print(f"step {it:5d}  loss {loss:.4f}  "
                  f"lr {float(m['lr']):.2e}  pods {active_pods}  "
                  f"step {step_s:.3f}s  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.ckpt and (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, it, (params, opt),
                            meta={"arch": args.arch, "pods": active_pods})
    if m is None:
        raise SystemExit(f"nothing to run: start step {start} >= "
                         f"--steps {args.steps}")
    final_loss = float(m["loss"])
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps - 1, (params, opt),
                        meta={"arch": args.arch, "pods": active_pods,
                              "final": True})
    print(f"done: final loss {final_loss:.4f}", flush=True)
    return final_loss


if __name__ == "__main__":
    main()
