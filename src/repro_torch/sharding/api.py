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
placement is a tuple with one entry per dimension, mirroring
``jax.sharding.PartitionSpec``: ``None``, a mesh axis name, or a tuple
of names.  The port computes placements but does not apply the dense
tensor-parallel and ZeRO ones yet: dense parameters stay replicated,
which computes the same function; only the expert-parallel MoE
(``models.layers``) splits work over the ``model`` axis.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from collections.abc import Sequence

from repro_torch.tree import flatten_with_paths, unflatten

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
    """The identity.

    The JAX package pins an activation's sharding here
    (``with_sharding_constraint``) and lets GSPMD redistribute it.
    PyTorch has no such partitioner, and the port redistributes no
    activation through this call: a collective it needs is written
    where it runs (the torrent ring, the expert-parallel MoE).
    """
    return x


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
           "current_rules", "logical_constraint", "param_specs",
           "spec_for_path"]
