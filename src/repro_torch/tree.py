"""Nested-container flattening in ``jax.tree_util`` leaf order.

The port keeps the JAX package's parameter trees (nested dicts, lists
and NamedTuples of tensors), and several results depend on the order
of their leaves: ``dist.torrent`` concatenates leaves in that order, so
it decides which values share a quantization block, and the checkpoint
format stores leaves by index.  ``jax.tree_util`` visits dict keys in
sorted order, lists/tuples and NamedTuple fields in position order, and
treats ``None`` as an empty subtree; so does this module.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TreeDef:
    kind: str                 # "leaf" | "none" | "dict" | "list" | "tuple" | "namedtuple"
    aux: object               # dict keys / NamedTuple type
    children: tuple

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


_LEAF = TreeDef("leaf", None, ())
_NONE = TreeDef("none", None, ())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


# The recursions are module-level functions, not closures: a nested
# function that calls itself is a reference cycle, which would keep the
# leaves it collected (full-width tensors) alive until the cyclic
# garbage collector happened to run.

def _flatten_into(node, leaves: list) -> TreeDef:
    if node is None:
        return _NONE
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys,
                       tuple(_flatten_into(node[k], leaves) for k in keys))
    if _is_namedtuple(node):
        return TreeDef("namedtuple", type(node),
                       tuple(_flatten_into(c, leaves) for c in node))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, None,
                       tuple(_flatten_into(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


def flatten(tree) -> tuple[list, TreeDef]:
    leaves: list = []
    treedef = _flatten_into(tree, leaves)
    return leaves, treedef


def _unflatten_from(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_unflatten_from(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.aux, kids))
    if td.kind == "namedtuple":
        return td.aux(*kids)
    return kids if td.kind == "list" else tuple(kids)


def unflatten(treedef: TreeDef, leaves) -> object:
    it = iter(leaves)
    out = _unflatten_from(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    ls, td = flatten(tree)
    others = []
    for r in rest:
        rl, rtd = flatten(r)
        if rtd != td:
            raise ValueError("tree structures differ")
        others.append(rl)
    return unflatten(td, [fn(*xs) for xs in zip(ls, *others)])
