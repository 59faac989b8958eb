"""Logical-axis sharding rules and parameter placements, by path name.

Port of ``repro/sharding/api.py``.  The model code never names mesh
axes: parameters get placements derived from their *path names*
(``spec_for_path``), and the launcher binds logical axes to mesh axes
with ``axis_rules``:

    with axis_rules(DEFAULT_RULES, mesh):
        step(params, opt, batch, weights, active)

Default binding (mesh axes ``pod`` / ``data`` / ``model``):

    batch  -> (pod, data)     # DP across pods and within a pod
    vocab/heads/kv/ffn/expert/rnn -> model   # TP / EP
    ZeRO: largest remaining param dim -> data (FSDP + sharded opt state)

Every rule is divisibility-checked against the mesh, so the same rules
hold on any mesh; non-divisible dims are left unsharded rather than
erroring, which is what makes elastic re-meshing across FL rounds
possible.

A mesh here is duck-typed: anything with ``axis_names`` and a
``devices`` array whose shape gives the axis sizes
(``repro_torch.launch.mesh.DeviceMesh`` or a plain description).  A
placement spec is a tuple with one entry per dimension, mirroring
``jax.sharding.PartitionSpec``: ``None``, a mesh axis name, or a tuple
of names.

Specs are applied as DTensor placements (``to_placements``,
``distribute_tree``) over the ``torch.distributed`` device mesh a
``DeviceMesh`` carries (``DeviceMesh.dtensor_mesh``: its axes of size
> 1, with the same names).  ``logical_constraint`` redistributes a
DTensor activation as JAX's ``with_sharding_constraint`` pins one, and
``local_map`` runs plain tensor code (a recurrence, a head-parallel
attention, a vocabulary-parallel loss) on each rank's local shards.
On plain tensors all of these are the identity: a model that is given
plain tensors computes exactly what it computed without a mesh.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from collections.abc import Sequence

import torch

from repro_torch.tree import flatten, flatten_with_paths, unflatten

_CTX = threading.local()

# ZeRO/FSDP sharding applies only to params with at least this many
# elements (2M ~ a 1448^2 matrix); smaller tensors replicate.
ZERO_MIN_ELEMS = 2 ** 21

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "expert": "model",
    "rnn": "model",
    "d_model": None,
    "zero": "data",           # FSDP / optimizer-state axis
}


@contextlib.contextmanager
def axis_rules(rules: dict, mesh=None):
    """Bind logical axes to ``mesh``'s axes for the calls inside; the
    binding is per thread, as in the JAX package."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (dict(rules), mesh)
    try:
        yield
    finally:
        _CTX.state = prev


def current_rules():
    """``(rules, mesh)`` of the innermost ``axis_rules``, or None."""
    return getattr(_CTX, "state", None)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in name)
    return int(axis_sizes(mesh).get(name, 1))


def _filter_axes(mesh, name, dim_size: int):
    """Drop mesh axes that don't exist / don't divide dim_size."""
    if name is None:
        return None
    names = name if isinstance(name, (tuple, list)) else (name,)
    kept = []
    prod = 1
    for a in names:
        if a not in mesh.axis_names:
            continue
        sz = _axis_size(mesh, a)
        if dim_size % (prod * sz) == 0:
            kept.append(a)
            prod *= sz
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def logical_constraint(x, *axes):
    """Pin a DTensor activation's placements by logical axis names.

    Port of JAX's ``logical_constraint`` (``with_sharding_constraint``
    by logical names): under ``axis_rules`` with a mesh, each dim gets
    its rule's mesh axes, divisibility-filtered against the global
    shape, and a DTensor is redistributed to those placements.  A plain
    tensor, no rules, no mesh, or an all-``None`` result leave ``x`` as
    it is, as JAX's leaves it unconstrained.
    """
    state = current_rules()
    if state is None or not is_dtensor(x):
        return x
    rules, mesh = state
    if mesh is None:
        return x
    parts = []
    for i, a in enumerate(axes):
        name = rules.get(a) if a else None
        parts.append(_filter_axes(mesh, name, x.shape[i]))
    if all(p is None for p in parts):
        return x
    target = to_placements(tuple(parts), x.device_mesh)
    return _Constrain.apply(x, target)


def constrain(x, placements):
    """A DTensor laid out as ``placements``, its gradient too (the
    redistribution ``logical_constraint`` makes); a plain tensor
    passes."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, tuple(placements))


def unshard_zero(x):
    """A DTensor parameter gathered along the ZeRO axis of the current
    rules (FSDP's unshard before use): its ``zero`` mesh dims replicate,
    its tensor-parallel split stays.  The gradient flows back
    reduce-scattered onto the ZeRO split.  Anything else passes."""
    state = current_rules()
    zero = None if state is None else state[0].get("zero")
    if zero is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    axes = zero if isinstance(zero, (tuple, list)) else (zero,)
    target = tuple(Replicate() if n in axes else pl for n, pl in
                   zip(x.device_mesh.mesh_dim_names, x.placements))
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


class _Constrain(torch.autograd.Function):
    """A DTensor laid out as ``placements``, and its gradient too, as
    JAX's sharding constraint transposes to one on the cotangent (left
    to itself, DTensor would lay the gradient out as whatever op made
    it chose)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


# ----------------------------------------------------------------------
# Placements as DTensor placements
# ----------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _torch_mesh(mesh):
    """The ``torch.distributed`` device mesh of ``mesh``: a port
    ``DeviceMesh``'s ``dtensor_mesh``, or ``mesh`` itself."""
    return getattr(mesh, "dtensor_mesh", mesh)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements, one a mesh dim, of a placement spec.

    ``spec`` has one entry per tensor dim (``None``, an axis name or a
    tuple of names); ``mesh`` is a port ``DeviceMesh`` or a
    ``torch.distributed`` device mesh.  A tensor dim on several axes is
    ``Shard(d)`` on each of them, the first named outermost, as a
    ``PartitionSpec`` means (``("pod", "data")``: pod major); the axes
    must then come in the mesh's order.  Axes the mesh lacks (a port
    mesh's axes of size 1) are dropped: splitting by 1 is no split.
    """
    from torch.distributed.tensor import Replicate, Shard
    tm = _torch_mesh(mesh)
    names = tuple(tm.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, placements, tmesh) -> tuple:
    """This rank's shard shape of a global ``shape`` (even splits)."""
    out = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = tmesh.size(i)
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split over {n} ranks")
            out[pl.dim] //= n
    return tuple(out)


def _local_chunk(x: torch.Tensor, placements, tmesh) -> torch.Tensor:
    """This rank's shard of a full tensor, mesh dims outermost first."""
    coords = tmesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            x = x.chunk(tmesh.size(i), dim=pl.dim)[coords[i]]
    return x


def distribute(x: torch.Tensor, spec, mesh, *, fill=None, device=None):
    """A DTensor of the full tensor ``x`` under placement ``spec``.

    Every rank holds the same ``x``; each keeps a contiguous copy of
    its own shard, so no collective runs.  With ``fill`` (``"empty"``)
    ``x`` needs only a shape, dtype and device (a ``meta`` tensor, a
    fake one) and the shard is allocated empty on ``device`` (default
    ``x``'s): a dry run's stand-in.  A mesh with no axis of size > 1
    returns ``x`` unchanged (an empty one with ``fill``).
    """
    from torch.distributed.tensor import DTensor
    tm = _torch_mesh(mesh)
    dev = x.device if device is None else device
    if tm is None:
        return (torch.empty(x.shape, dtype=x.dtype, device=dev)
                if fill == "empty" else x)
    pl = to_placements(spec, tm)
    if fill == "empty":
        local = torch.empty(local_shape(x.shape, pl, tm), dtype=x.dtype,
                            device=dev)
    else:
        local = _local_chunk(x.detach(), pl, tm).contiguous().clone()
    return DTensor.from_local(local, tm, pl, run_check=False,
                              shape=tuple(x.shape),
                              stride=_contiguous_stride(x.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def distribute_tree(tree, specs, mesh, *, fill=None, device=None):
    """``distribute`` of every leaf of ``tree`` by the matching leaf of
    ``specs`` (``param_specs``' tree)."""
    leaves, treedef = flatten(tree)
    spec_leaves = _spec_leaves(specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(spec_leaves)} "
                         "specs")
    return unflatten(treedef, [distribute(x, s, mesh, fill=fill,
                                          device=device)
                               for x, s in zip(leaves, spec_leaves)])


def _spec_leaves(specs) -> list:
    """The placement specs of a spec tree, in leaf order (a spec is a
    tuple, so the tree's own flattening would split it)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list) or (isinstance(node, tuple)
                                        and hasattr(type(node), "_fields")):
            for c in node:
                walk(c)
        else:
            out.append(tuple(node))
    walk(specs)
    return out


def replicate_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t``, a plain tensor every rank computes alike (positions, a
    RoPE table), as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor; else ``t`` itself."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    tm = x.device_mesh
    return DTensor.from_local(t, tm, (Replicate(),) * tm.ndim,
                              run_check=False)


def placements_like(x, batch_dim=0, model_dim=None) -> tuple:
    """Placements over ``x``'s mesh that split ``batch_dim`` as ``x``
    splits its dim 0, and put ``model_dim`` (or nothing) on ``model``.

    Each mesh dim other than ``model`` gives ``Shard(batch_dim)`` where
    ``x`` has ``Shard(0)`` and replicates otherwise (``batch_dim`` None:
    replicates); ``model`` shards ``model_dim``.  The layout of a
    per-example, per-head (or per-channel) computation.
    """
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if name == "model":
            out.append(Replicate() if model_dim is None
                       else Shard(model_dim))
        else:
            out.append(Shard(batch_dim) if (pl == Shard(0) and
                                            batch_dim is not None)
                       else Replicate())
    return tuple(out)


def model_size(x) -> int:
    """The size of the ``model`` axis of a DTensor's mesh (1 without)."""
    tm = x.device_mesh
    names = tuple(tm.mesh_dim_names)
    return tm.size(names.index("model")) if "model" in names else 1


def local_map(fn, args, in_placements, out_placements, tmesh):
    """``fn(*local shards)`` wrapped back into DTensors.

    Each DTensor of ``args`` is redistributed to its entry of
    ``in_placements`` and passed as its local shard; other args, and
    those whose entry is None, pass as they are.  The output becomes a DTensor with ``out_placements``
    (a placement tuple); several outputs take a list of them, with None
    for an output that is not to be wrapped.
    A replicated input's gradient is ``Partial`` on every mesh dim on
    which an output is split (the ranks used it for different outputs),
    replicated otherwise.
    """
    from torch.distributed.tensor import DTensor, Partial
    single = not isinstance(out_placements, list)
    outs_pl = (out_placements,) if single else out_placements
    varies = [any(p is not None and not p[i].is_replicate()
                  for p in outs_pl) for i in range(tmesh.ndim)]
    local = []
    for a, pl in zip(args, in_placements):
        if is_dtensor(a) and pl is not None:
            a = a.redistribute(tmesh, pl)
            grad = tuple(Partial() if (p.is_replicate() and varies[i])
                         else p for i, p in enumerate(pl))
            a = a.to_local(grad_placements=grad)
        local.append(a)
    res = fn(*local)
    res_t = (res,) if single else res

    def wrap(t, pl):
        if pl is None or t is None:
            return t
        return DTensor.from_local(t, tmesh, pl, run_check=False)
    out = tuple(wrap(t, pl) for t, pl in zip(res_t, outs_pl))
    return out[0] if single else out


# ----------------------------------------------------------------------
# Parameter placements by path name
# ----------------------------------------------------------------------

# (regex on the param's dot-joined path) -> logical axes per trailing dim.
# Stacked cycle params have a leading cycle dim handled separately.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("vocab", "d_model")),
    (r"head$", ("d_model", "vocab")),
    (r"adapter_in$", ("d_model", "d_model")),
    (r"(wq|wk|wv)$", ("d_model", "heads")),     # flattened head dims
    (r"wo$", ("heads", "d_model")),
    (r"(w_gate|w_up)$", ("d_model", "ffn")),
    (r"w_down$", ("ffn", "d_model")),
    (r"router$", ("d_model", "expert")),
    (r"(moe_gate|moe_up)$", ("expert", "d_model", "ffn")),
    (r"moe_down$", ("expert", "ffn", "d_model")),
    (r"(rg_in|rg_gate)$", ("d_model", "rnn")),
    (r"rg_out$", ("rnn", "d_model")),
    (r"conv_w$", (None, "rnn")),
    (r"(lam|a_gate_w|i_gate_w)$", ("rnn",)),
    (r"(up_l|up_r)$", ("d_model", "rnn")),
    (r"(wq_i|wk_i|wv_i)$", ("rnn", "rnn")),
    (r"(wi|wf|wo_gate)$", ("rnn", "heads")),
    (r"down$", ("rnn", "d_model")),
    (r"w4$", ("d_model", "heads")),             # sLSTM fused gates
    (r"r4$", ("heads", None, None)),            # block-diag recurrent
    (r"b4$", ("heads",)),
    (r"(q_norm|k_norm|ln1|ln2|post_ln1|post_ln2|final_norm|norm)$",
     None),
]


def spec_for_path(path: str, shape: tuple, mesh, rules: dict,
                  stacked: bool, zero: bool = True) -> tuple:
    """Placement of one param: one entry per dim; TP rules, then ZeRO."""
    logical = None
    for pat, ax in _PARAM_RULES:
        if re.search(pat, path):
            logical = ax
            break
    ndim = len(shape)
    parts: list = [None] * ndim
    off = 1 if stacked else 0
    used: set = set()

    def _dedup(f):
        """Drop mesh axes already used by an earlier dim of this param."""
        if f is None:
            return None
        names = f if isinstance(f, tuple) else (f,)
        kept = tuple(a for a in names if a not in used)
        if not kept or kept != names:
            return None          # partial use would break divisibility
        used.update(kept)
        return kept if len(kept) > 1 else kept[0]

    if logical is not None:
        for i, a in enumerate(logical):
            j = off + i
            if j >= ndim or a is None:
                continue
            parts[j] = _dedup(_filter_axes(mesh, rules.get(a), shape[j]))
    if zero and math.prod(shape or (1,)) >= ZERO_MIN_ELEMS:
        # ZeRO only pays for big tensors: sharding a 1k-element norm
        # scale costs a gather at every use for no memory saved.
        zaxis = rules.get("zero")
        if zaxis is not None:
            # largest still-unsharded dim (excluding the stack dim).
            order = sorted(range(off, ndim), key=lambda i: -shape[i])
            for i in order:
                if parts[i] is None:
                    f = _dedup(_filter_axes(mesh, zaxis, shape[i]))
                    if f is not None:
                        parts[i] = f
                        break
    return tuple(parts)


def param_specs(params, mesh, rules: dict | None = None, *,
                stacked_prefixes: Sequence[str] = ("cycles",),
                zero: bool = True):
    """Tree of placements matching a params tree, by path names.

    A path joins dict keys and list indices with dots, as the JAX
    package joins ``jax.tree_util`` key paths (``cycles.slot0.wq``,
    ``tail.0.w_up``).  Leaves need only a ``shape``: tensors on the
    ``meta`` device size a full configuration without its weights.
    """
    rules = dict(DEFAULT_RULES if rules is None else rules)
    paths, leaves, treedef = flatten_with_paths(params)
    specs = []
    for keys, leaf in zip(paths, leaves):
        path = ".".join(str(k) for k in keys)
        stacked = any(path.startswith(pfx) for pfx in stacked_prefixes)
        specs.append(spec_for_path(path, tuple(leaf.shape), mesh, rules,
                                   stacked, zero))
    return unflatten(treedef, specs)


__all__ = ["DEFAULT_RULES", "ZERO_MIN_ELEMS", "axis_rules", "axis_sizes",
           "constrain", "current_rules", "distribute", "distribute_tree",
           "is_dtensor",
           "local_map", "local_shape", "logical_constraint", "model_size",
           "param_specs",
           "placements_like", "replicate_like", "spec_for_path",
           "to_placements", "unshard_zero"]
