"""Per-rank cost and memory analysis of the ops one rank dispatches.

Counterpart of ``repro/launch/hlo_analysis.py``.  The JAX package
parses the compiled, partitioned HLO of a step; eager PyTorch has no
HLO, so ``CostCounter`` (a ``TorchDispatchMode``) counts the aten ops
that this rank runs on its local shards while the step executes, on
fake tensors (a dry run) or on real ones:

* **flops**           — matmuls and convolutions by
                        ``torch.utils.flop_counter``'s formulas (2MNK,
                        batch-aware); an elementwise op and a reduction
                        each 1 a result element, as ``analyze`` counts
                        them (``hlo_analysis.py:233``, ``:356``).
* **transcendentals** — exp, log, tanh, sigmoid, rsqrt, ... apart, one
                        a result element, as JAX counts them.
* **hbm_bytes**       — each op reads its operands and writes its
                        results; views are free.  Eager PyTorch fuses
                        nothing, so this is an upper bound on what a
                        fused program moves (XLA keeps a fusion's
                        intermediates on chip).
* **coll_bytes**      — per-rank bytes over the interconnect with JAX's
                        ring factors (``hlo_analysis.py:178-196``) on the
                        group each collective runs on: all-gather
                        (p-1)/p of the output, all-reduce twice that,
                        reduce-scatter out * p * (p-1)/p, all-to-all
                        (p-1)/p, a P2P send its buffer.  Both DTensor's
                        ``_c10d_functional`` ops and the port's own
                        ``c10d`` collectives and ring sends count.

Only this rank's own work counts.  A DTensor op is not counted itself
(the counter declines it, and DTensor then dispatches the op on the
local shards, which the counter sees); the ops DTensor runs on fake
tensors to propagate shardings (on global shapes) are not counted,
cached or not, so the same op twice counts twice the same.  In a fake
run only fake tensors count; host-side bookkeeping (a device mesh's
rank tensors) never does.

The counter also tracks memory: every storage this rank creates, held
live until it is freed (``weakref`` on the storage), beside the
arguments registered before the step.  The peak of the live bytes is
the forecast of ``torch.cuda.max_memory_allocated``: parameters,
optimizer state, batch shards, activations saved for the backward and
the temporaries.

``roofline_terms`` keeps JAX's keys with the H100 SXM 80GB's data-sheet
rates in place of the TPU's.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.sharding.api import is_dtensor

# ----------------------------------------------------------------------
# Op classes
# ----------------------------------------------------------------------

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "tan", "atan2",
    "erf", "erfc", "erfinv", "logit", "_softmax", "_log_softmax",
    "logsumexp", "softplus", "silu", "gelu", "logaddexp",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
    "argmax", "argmin", "var", "var_mean", "std", "norm",
    "linalg_vector_norm", "cumsum", "cumprod", "cummax", "cummin",
    "logsumexp", "_softmax", "_log_softmax",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset",
               "is_same_size"}
# a Python constant becoming a tensor: no device work, and real and
# fake tensors dispatch it differently
_CONSTANTS = {"lift_fresh", "lift_fresh_copy"}
# (packet name) -> JAX-style collective name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "send": "send",
    "recv_": "recv",
    "recv_any_source_": "recv",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d")
# a collective's result handed back to autograd, on real tensors only:
# the same tensor, no device work
_BOOKKEEPING = {"_wrap_tensor_autograd"}


def dtype_bytes(dtype: torch.dtype) -> int:
    """Bytes of one element of ``dtype``."""
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_bytes(kind: str, out_bytes: float, p: int) -> float:
    """Per-rank interconnect bytes of one collective on a group of
    ``p`` ranks whose result holds ``out_bytes`` (JAX's ring model)."""
    frac = (p - 1) / p if p > 1 else 0.0
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * p * frac
    if kind in ("all-to-all", "broadcast"):
        return out_bytes * frac
    if kind == "send":
        return out_bytes
    return 0.0                        # a receive: its sender counts it


# ----------------------------------------------------------------------
# Roofline constants: H100 SXM 80GB data sheet
# ----------------------------------------------------------------------

PEAK_FLOPS = 989e12            # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12               # HBM3 bytes/s
NVLINK_BW = 450e9              # NVLink 4, one way, bytes/s a GPU
NETWORK_BW = 50e9              # one 400 Gb/s NIC a GPU, bytes/s
NODE_GPUS = 8                  # GPUs of one NVLink node
LINK_RATES = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def link_of(ranks) -> str:
    """``"nvlink"`` for a group inside one node of ``NODE_GPUS`` GPUs
    (ranks numbered node by node), else ``"network"``."""
    if not ranks:
        return "network"
    return "nvlink" if len({r // NODE_GPUS for r in ranks}) == 1 \
        else "network"


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    # interconnect bytes by link ("nvlink" / "network")
    coll_bytes_by_link: dict = dataclasses.field(default_factory=dict)


def roofline_terms(costs: Costs, *, model_flops_global: float = 0.0,
                   n_chips: int = 256) -> dict:
    """The three roofline terms of per-rank ``costs`` on H100s, with the
    keys of JAX's ``roofline_terms``; ``model_flops_global`` is the
    analytic 6ND.  Collective time sums each link's bytes over its rate
    (``coll_bytes`` without a link split go at the network's)."""
    t_compute = costs.flops / PEAK_FLOPS
    t_memory = costs.hbm_bytes / HBM_BW
    by_link = dict(costs.coll_bytes_by_link) or (
        {"network": costs.coll_bytes} if costs.coll_bytes else {})
    t_coll = sum(b / LINK_RATES[k] for k, b in by_link.items())
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_per_device": costs.flops,
        "hlo_bytes_per_device": costs.hbm_bytes,
        "coll_bytes_per_device": costs.coll_bytes,
        "coll_counts": costs.coll_counts,
        "coll_bytes_by_link": by_link,
        "link_rates": {k: LINK_RATES[k] for k in by_link},
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "network_bw": NETWORK_BW,
                      "source": "H100 SXM 80GB data sheet"},
    }
    if model_flops_global > 0:
        out["model_flops_global"] = model_flops_global
        hlo_global = costs.flops * n_chips
        out["useful_flops_ratio"] = (model_flops_global / hlo_global
                                     if hlo_global else 0.0)
        out["useful_mfu_bound"] = (
            (model_flops_global / n_chips / PEAK_FLOPS) / bound
            if bound > 0 else 0.0)
    return out


# ----------------------------------------------------------------------
# The counter
# ----------------------------------------------------------------------

_PROP = threading.local()


def _in_propagation() -> bool:
    return getattr(_PROP, "depth", 0) > 0


class _MarkPropagation:
    """While active, DTensor's sharding propagation (the op run on fake
    global-shape tensors to learn its output's metadata) is marked, so
    the counter skips it.  Nested counters share one patch."""

    _users = 0
    _orig = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        if _MarkPropagation._users == 0:
            orig = SP._propagate_tensor_meta_non_cached

            def marked(self_, *a, **k):
                _PROP.depth = getattr(_PROP, "depth", 0) + 1
                try:
                    return orig(self_, *a, **k)
                finally:
                    _PROP.depth -= 1
            _MarkPropagation._orig = orig
            SP._propagate_tensor_meta_non_cached = marked
        _MarkPropagation._users += 1
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        _MarkPropagation._users -= 1
        if _MarkPropagation._users == 0:
            SP._propagate_tensor_meta_non_cached = _MarkPropagation._orig
        return False


def _is_group(a) -> bool:
    """A process group as an op argument: a functional op's group name
    is checked by the caller; a ``c10d`` op gets the group boxed as a
    ``ScriptObject``."""
    return isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
        a._type().qualified_name())


def _group_info(group) -> tuple[int, list | None]:
    """(size, global ranks or None) of a process group (boxed or not)
    or its name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if isinstance(group, str):
        pg = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):
        pg = dist.ProcessGroup.unbox(group)
    else:
        pg = group
    try:
        ranks = dist.get_process_group_ranks(pg)
    except Exception:                      # not a registered group
        ranks = None
    return (len(ranks) if ranks else int(pg.size())), ranks


class CostCounter(TorchDispatchMode):
    """Counts this rank's ops (``Costs``) and tracks its live memory.

    ``fake`` True counts fake tensors only (a dry run), False real ones
    only; ``device`` (a device type) further restricts counting to
    tensors there.  Use as a context around the step, after
    ``add_arguments`` of what the step takes::

        with CostCounter(fake=True, device="cuda") as cc:
            cc.add_arguments(params, opt, batch)
            step(params, opt, batch, w, a)
        cc.costs, cc.memory()
    """

    def __init__(self, *, fake: bool, device=None):
        super().__init__()
        self.fake = fake
        self.device_type = (None if device is None
                            else torch.device(device).type)
        self.costs = Costs()
        self.n_ops = 0
        self.op_counts: dict = {}         # counted ops by name
        self._live: dict = {}            # storage key -> bytes
        self._arg_keys: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._mark = _MarkPropagation()

    def __enter__(self):
        self._mark.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._mark.__exit__(*exc)

    # -- memory --------------------------------------------------------

    def _track(self, t: torch.Tensor, *, argument: bool = False) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            if argument and key not in self._arg_keys:
                self._arg_keys.add(key)
                self.argument_bytes += self._live[key]
            return
        nb = st.nbytes()
        self._live[key] = nb
        if argument:
            self._arg_keys.add(key)
            self.argument_bytes += nb
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        nb = self._live.pop(key, 0)
        self.live_bytes -= nb

    def add_arguments(self, *trees) -> None:
        """Register the step's inputs (DTensors by their local shards)
        as live argument memory."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if is_dtensor(t) else t
                if self._counts(t):
                    self._track(t, argument=True)

    def memory(self) -> dict:
        """JAX's ``memory_analysis`` fields for the step so far:
        arguments, outputs (storages made in the step and still live),
        peak temporaries above both, and the per-device total (the
        peak of live bytes)."""
        live_args = sum(self._live.get(k, 0) for k in self._arg_keys)
        out = self.live_bytes - live_args
        return {
            "argument_size_in_bytes": int(self.argument_bytes),
            "output_size_in_bytes": int(out),
            "temp_size_in_bytes": int(max(0, self.peak_bytes
                                          - self.argument_bytes - out)),
            "total_per_device_bytes": int(self.peak_bytes),
        }

    # -- counting ------------------------------------------------------

    def _counts(self, t: torch.Tensor) -> bool:
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(t) != self.fake:
            return False
        return self.device_type is None or t.device.type == self.device_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(is_dtensor(a) for a in flat):
            return NotImplemented          # DTensor runs it on the shards
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if not all(self._counts(t) for t in ins + outs):
            return out
        name = func.overloadpacket.__name__
        if name in _BOOKKEEPING or (
                func.namespace not in _COLL_NAMESPACES and (
                    not outs or func.namespace == "prim"
                    or name in _CONSTANTS)):
            return out            # metadata, a host read, a constant
        self.n_ops += 1
        key = str(func)
        self.op_counts[key] = self.op_counts.get(key, 0) + 1
        for o in outs:
            self._track(o)
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        c = self.costs
        name = func.overloadpacket.__name__
        if func.namespace in _COLL_NAMESPACES and name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], func, args, ins, outs)
            return
        if func.namespace in _COLL_NAMESPACES:
            return                         # wait_tensor, barrier, ...
        if func.is_view or name in _NO_TRAFFIC:
            return
        from torch.utils.flop_counter import flop_registry
        packet = func.overloadpacket
        n_out = sum(o.numel() for o in outs)
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _TRANSCENDENTAL:
            c.transcendentals += n_out
            if name in ("_softmax", "_log_softmax", "logsumexp"):
                c.flops += 2 * sum(i.numel() for i in ins[:1])
        elif name in _REDUCTIONS or torch.Tag.reduction in func.tags:
            c.flops += n_out
        elif torch.Tag.pointwise in func.tags:
            c.flops += n_out
        c.hbm_bytes += sum(_nbytes(t) for t in ins + outs)

    def _collective(self, kind, func, args, ins, outs) -> None:
        c = self.costs
        # functional ops name their group last; c10d ops pass it
        groups = [a for a in args if isinstance(a, str) or _is_group(a)]
        group = groups[-1] if groups else None
        p, ranks = _group_info(group) if group is not None else (1, None)
        if func.namespace == "c10d":
            # in-place: the buffers are the tensor arguments (for a
            # gather, the first list holds the outputs)
            bufs = [t for t in tree_leaves(args[0])
                    if isinstance(t, torch.Tensor)]
        else:
            bufs = outs
        nb = float(sum(_nbytes(t) for t in bufs))
        moved = collective_bytes(kind, nb, p)
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        if moved:
            link = link_of(ranks)
            c.coll_bytes += moved
            c.coll_bytes_by_link[link] = (
                c.coll_bytes_by_link.get(link, 0.0) + moved)


__all__ = ["Costs", "CostCounter", "HBM_BW", "NETWORK_BW", "NODE_GPUS",
           "NVLINK_BW", "PEAK_FLOPS", "collective_bytes", "dtype_bytes",
           "link_of", "roofline_terms"]
