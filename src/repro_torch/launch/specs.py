"""Per-cell step functions, placed stand-in inputs, and placement specs.

Port of ``repro/launch/specs.py``.  ``build_cell(cfg, shape, mesh)``
returns everything the dry run needs:

    step        — the function to run (train / prefill / serve)
    args        — stand-in inputs, each placed by its spec
                  (``sharding.distribute_tree``): fake tensors when
                  called under ``FakeTensorMode``, so nothing is
                  allocated
    in_specs    — the matching placement-spec tree (tuples mirroring
                  ``PartitionSpec``), from ``cell_specs``
    out_specs   — or None
    meta        — kind, pod count, tokens

Input layouts per shape kind (as in the JAX package):
    train    batch = {inputs (P, B/P, T) i64, labels same} + params/opt
    prefill  inputs (B, T) i64 (hubert: (B, T, D) frames)
    decode   caches @ seq_len, tokens (B,) i64, pos (an int)

Where JAX's ``to_shardings`` turns specs into ``NamedSharding``s for
``jax.jit``, the port places the stand-ins themselves as DTensors over
the mesh's ``torch.distributed`` device mesh.  Parameters are placed
on the full mesh, except in a train cell: there the pod-parallel step
holds each pod's replica on the pod's ``data`` x ``model`` sub-mesh
(``param_specs`` never names ``pod``), as JAX's ``shard_map`` over
``pod`` does.  The train batch is the full token batch on every rank
(the step takes its pod's and its data shard's rows), as the port's
step takes it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.fl_step import make_fl_train_step, make_serve_step
from repro_torch.launch.mesh import pod_axis_size
from repro_torch.models import (ArchConfig, forward, init_decode_cache,
                                init_params, prefill)
from repro_torch.models.common import torch_dtype
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import OptState
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.sharding.api import (DEFAULT_RULES, _filter_axes,
                                      axis_sizes, distribute,
                                      distribute_tree, param_specs)
from repro_torch.tree import flatten_with_paths, unflatten


def _batch_axes(mesh, size: int):
    """Mesh axes for a batch dim of ``size`` (pod+data, filtered)."""
    return _filter_axes(mesh, ("pod", "data"), size)


def _data_axes(mesh, size: int):
    return _filter_axes(mesh, "data", size)


def opt_state_specs(pspecs):
    """The optimizer state's specs: the parameters' for master, m and
    v; the step counter replicated."""
    return OptState(step=(), master=pspecs, m=pspecs, v=pspecs)


def cache_specs(cfg: ArchConfig, caches, mesh, batch: int):
    """Placement specs for a decode-cache tree (leaves need a shape).

    KV caches: shard batch over (pod, data); shard kv-heads over model
    when divisible, else fall back to sharding head_dim over model
    (GQA with few kv heads: attention then contracts a split dim and
    sums the scores over ``model``).  Recurrent state: shard the
    feature dim over model.
    """
    b_ax = _batch_axes(mesh, batch)
    paths, leaves, treedef = flatten_with_paths(caches)
    out = []
    for keys, leaf in zip(paths, leaves):
        keys = [str(k) for k in keys]
        name = keys[-1]
        stacked = keys[0] == "cycles"
        off = 1 if stacked else 0
        shape = tuple(leaf.shape)
        lead = (None,) if stacked else ()
        if name in ("k", "v"):                    # (B, kv, S, dh)
            kv_ax = _filter_axes(mesh, "model", shape[off + 1])
            dh_ax = None
            if kv_ax is None:
                dh_ax = _filter_axes(mesh, "model", shape[off + 3])
            spec = (*lead, b_ax, kv_ax, None, dh_ax)
        elif name == "h" and len(shape) == off + 2:   # rglru (B, dr)
            spec = (*lead, b_ax, _filter_axes(mesh, "model",
                                              shape[off + 1]))
        elif name == "conv":                       # (B, w-1, D)
            spec = (*lead, b_ax, None,
                    _filter_axes(mesh, "model", shape[off + 2]))
        elif name == "C":                          # (B, H, dh, dh)
            spec = (*lead, b_ax, None, None,
                    _filter_axes(mesh, "model", shape[off + 3]))
        elif name in ("n", "m", "c"):              # (B, H[, dh])
            spec = (*lead, b_ax, *([None] * (len(shape) - off - 1)))
        elif name == "h":                          # slstm (B, H, dh)
            spec = (*lead, b_ax, None, None)
        else:
            spec = (None,) * len(shape)
        out.append(tuple(spec))
    return unflatten(treedef, out)


def decode_rules(cfg: ArchConfig, mesh, rules: dict) -> dict:
    """Serving's rules: ZeRO off when the TP-only weight replica fits.

    Serving has no optimizer state, so ZeRO/FSDP sharding of weights
    would gather them on every token step; weights stay TP-sharded
    only, unless the TP-only replica (bf16) is over 512 MiB a device
    (chameleon-34b), in which case weight streaming stays sharded.
    """
    tp = int(axis_sizes(mesh).get("model", 1))
    if cfg.param_count() * 2 / max(tp, 1) <= 512 * 2 ** 20:
        rules = dict(rules)
        rules["zero"] = None
    return rules


@functools.lru_cache(maxsize=16)
def _meta_params(cfg: ArchConfig) -> dict:
    """The parameter tree's shapes and dtypes (``meta`` tensors, which
    hold no data; callers read shapes only)."""
    return init_params(cfg, torch.Generator(), device="meta")


@functools.lru_cache(maxsize=16)
def _meta_caches(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    return init_decode_cache(cfg, batch, max_len, device="meta")


def cell_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               rules: dict | None = None) -> dict:
    """The placement specs of one cell, with no tensor allocated:
    ``in_specs``, ``out_specs`` and the parameter specs (``pspecs``).
    Reads only ``mesh.axis_names`` and ``mesh.devices.shape``."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    n_pods = pod_axis_size(mesh)
    params = _meta_params(cfg)
    if shape.kind == "decode":
        rules = decode_rules(cfg, mesh, rules)
    pspecs = param_specs(params, mesh, rules)
    if shape.kind == "train":
        b_local = shape.global_batch // n_pods
        nd = 2 if cfg.has_embedding else 3
        batch = {
            "inputs": ("pod" if n_pods > 1 else None,
                       _data_axes(mesh, b_local), *([None] * (nd - 1))),
            "labels": ("pod" if n_pods > 1 else None,
                       _data_axes(mesh, b_local), None),
        }
        ospecs = opt_state_specs(pspecs)
        return dict(pspecs=pspecs,
                    in_specs=(pspecs, ospecs, batch, (), ()),
                    out_specs=(pspecs, ospecs, {"loss": (), "lr": ()}))
    b = shape.global_batch
    b_ax = _batch_axes(mesh, b)
    if shape.kind == "prefill":
        in_sp = (b_ax, None) if cfg.has_embedding else (b_ax, None, None)
        return dict(pspecs=pspecs, in_specs=(pspecs, in_sp), out_specs=None)
    if shape.kind == "decode":
        cspecs = cache_specs(cfg, _meta_caches(cfg, b, shape.seq_len),
                             mesh, b)
        return dict(pspecs=pspecs, in_specs=(pspecs, cspecs, (b_ax,), ()),
                    out_specs=None)
    raise ValueError(shape.kind)


def _lr_schedule():
    """The JAX dry run's schedule; a fake step counter (a dry run's)
    reads as step 0, which runs the same ops."""
    from torch._subclasses.fake_tensor import is_fake
    sched = linear_warmup_cosine(3e-4, 100, 10000)
    return lambda step: sched(0 if is_fake(step) else step)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               rules: dict | None = None, microbatch: int = 0,
               torrent_blocks: int = 4, compress: bool = False,
               ce_chunk: int = 512, device="cpu"):
    """Returns dict(step, args, in_specs, out_specs, meta).

    ``mesh`` is a ``launch.mesh.DeviceMesh`` of this world (a fake one
    in a dry run); its DTensor mesh must be built outside any fake
    mode (``mesh.dtensor_mesh`` builds it on first use).  Call under
    ``FakeTensorMode`` for stand-ins that allocate nothing; ``device``
    is the device they claim.
    """
    rules = dict(DEFAULT_RULES if rules is None else rules)
    n_pods = pod_axis_size(mesh)
    sp = cell_specs(cfg, shape, mesh, rules=rules)
    pspecs = sp["pspecs"]
    dev = torch.device(device)
    meta = _meta_params(cfg)
    dt = torch_dtype(cfg.dtype)

    def placed(x, spec, pmesh=mesh):
        return distribute(x, spec, pmesh, fill="empty", device=dev)

    if shape.kind == "train":
        submesh = mesh.submesh(("data", "model")) if mesh.is_member \
            else None
        params = distribute_tree(meta, pspecs, submesh, fill="empty",
                                 device=dev)
        opt = adamw_init(params)
        b_local = shape.global_batch // n_pods
        feat = () if cfg.has_embedding else (cfg.d_model,)
        inp = torch.empty((n_pods, b_local, shape.seq_len, *feat),
                          dtype=torch.int64 if cfg.has_embedding else dt,
                          device=dev)
        lab = torch.empty((n_pods, b_local, shape.seq_len),
                          dtype=torch.int64, device=dev)
        step = make_fl_train_step(
            cfg, mesh, lr_schedule=_lr_schedule(), n_pods=n_pods,
            rules=rules, torrent_blocks=torrent_blocks, compress=compress,
            microbatch=microbatch, ce_chunk=ce_chunk)
        args = (params, opt, {"inputs": inp, "labels": lab},
                torch.empty((n_pods,), dtype=torch.float32, device=dev),
                torch.empty((n_pods,), dtype=torch.float32, device=dev))
        return dict(step=step, args=args, in_specs=sp["in_specs"],
                    out_specs=sp["out_specs"],
                    meta=dict(kind="train", n_pods=n_pods,
                              tokens=shape.global_batch * shape.seq_len))

    params = distribute_tree(meta, pspecs, mesh, fill="empty", device=dev)
    b = shape.global_batch
    if shape.kind == "prefill":
        in_sp = sp["in_specs"][1]
        if cfg.has_embedding:
            x = placed(torch.empty((b, shape.seq_len), dtype=torch.int64,
                                   device="meta"), in_sp)
        else:
            x = placed(torch.empty((b, shape.seq_len, cfg.d_model),
                                   dtype=dt, device="meta"), in_sp)
        if cfg.causal:
            cmeta = _meta_caches(cfg, b, shape.seq_len)
            cspecs = cache_specs(cfg, cmeta, mesh, b)

            @torch.no_grad()
            def step(p, x):
                # the caches prefill fills, placed as decode reads them
                caches = distribute_tree(cmeta, cspecs, mesh, fill="empty",
                                         device=dev)
                return prefill(cfg, p, x, max_len=shape.seq_len,
                               caches=caches)
        else:
            @torch.no_grad()
            def step(p, x):
                return forward(cfg, p, x)
        return dict(step=step, args=(params, x), in_specs=sp["in_specs"],
                    out_specs=None,
                    meta=dict(kind="prefill", n_pods=n_pods,
                              tokens=b * shape.seq_len))

    if shape.kind == "decode":
        cspecs = sp["in_specs"][1]
        caches = distribute_tree(_meta_caches(cfg, b, shape.seq_len),
                                 cspecs, mesh, fill="empty", device=dev)
        tokens = placed(torch.empty((b,), dtype=torch.int64,
                                    device="meta"), sp["in_specs"][2])
        serve = torch.no_grad()(make_serve_step(cfg))
        pos = shape.seq_len - 1          # the cache's last slot
        return dict(step=serve, args=(params, caches, tokens, pos),
                    in_specs=sp["in_specs"], out_specs=None,
                    meta=dict(kind="decode", n_pods=n_pods, tokens=b))

    raise ValueError(shape.kind)


__all__ = ["build_cell", "cache_specs", "cell_specs", "decode_rules",
           "opt_state_specs"]
