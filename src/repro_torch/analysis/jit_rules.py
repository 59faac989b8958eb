"""Host-sync / CUDA-graph-capture readiness rules (family ``jit``).

The JAX package's jit rules read, for torch, as one hazard: a value
read back to the host inside a hot path.  Each such read — a Python
``if``/``while`` on a tensor's value, ``float()``/``int()``/``bool()``/
``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, a Python loop over a
data-dependent index set (``torch.nonzero``, ``torch.unique``, ...) —
blocks the host until the device drains, stalls asynchronous dispatch,
and makes the function impossible to capture in a CUDA graph.  The
targets are the port's counterparts of the JAX package's jit-slated
functions: the bitplane state helpers, the budgeted-round matching
engine, the fair-share water-fill, the slot engine's rounds and rank
search.  Numpy host code in a target counts the same way (its array
values are what a device version would have to read back).

Findings here are ``warning`` severity: they are a *worklist* (emitted
as the scorecard), not bugs — each target function is correct today and
baselined with that justification.
"""
from __future__ import annotations

import ast

from .findings import Finding
from .registry import AnalyzerRule, register_rule
from .resolve import call_name, import_aliases, unparse_trim

# The port's counterparts of the JAX package's 13 jit-slated functions:
# module-path suffix -> final qualname segments.  One row each, where
# the function lives in the port (the slot engine's rank search and the
# fair-share fill moved to kernels/).
JIT_TARGETS = {
    "repro_torch/core/state.py": (
        "owner_windows", "eligible_supply", "candidate_columns"),
    "repro_torch/core/schedulers.py": (
        "_schedule_centralized_batched", "_count_rows",
        "_extract_prefix"),
    "repro_torch/net/fairshare.py": ("maxmin_rates", "transport"),
    "repro_torch/kernels/fairshare.py": ("_maxmin_fill",),
    "repro_torch/core/jit_engine.py": ("_slot_rounds",),
    "repro_torch/kernels/slots.py": ("_rank_counts", "_extract_ranked",
                                     "_kth_set_bit"),
}

_ARRAY_METHODS = {"any", "all", "sum", "min", "max", "item", "argmax",
                  "argmin", "nonzero", "prod", "mean"}
_ARRAY_PROPS = {"size", "shape", "ndim"}
# Host read-backs: a method call that copies a tensor's value out.
_READBACKS = {"item", "tolist", "cpu", "numpy"}
_DATA_ITER = {"numpy.flatnonzero", "numpy.nonzero", "numpy.argwhere",
              "numpy.unique", "numpy.where",
              "torch.nonzero", "torch.argwhere", "torch.unique"}
# Tensor methods that make the same data-dependent index sets.
_DATA_ITER_METHODS = {"nonzero", "argwhere", "unique"}


def jit_targets(ctx):
    """Yield (path, qualname, FunctionDef) for every slated function
    present in the analyzed set.  Under ``assume_library`` every module
    is matched against the union of slated names (rule fixtures)."""
    all_names = {n for names in JIT_TARGETS.values() for n in names}
    for path, tree in ctx.modules.items():
        if ctx.assume_library:
            wanted = all_names
        else:
            wanted = {n for suffix, names in JIT_TARGETS.items()
                      if path.endswith(suffix) for n in names}
        if not wanted:
            continue
        for qual, fn in ctx.walk_functions(tree):
            if qual.rsplit(".", 1)[-1] in wanted:
                yield path, qual, fn


def _array_tainted_names(fn, aliases) -> set:
    """One-level taint: locals assigned from an array-smelling
    expression (``t = min(tu.min(), td.min())``)."""
    tainted: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _smells_array(
                node.value, aliases, tainted):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tainted.add(tgt.id)
    return tainted


def _smells_array(node, aliases, tainted=frozenset()) -> bool:
    """Does this expression read an array value (method reductions,
    shape/size props, numpy or torch calls, or tainted scalars)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            if sub.attr in _ARRAY_PROPS:
                return True
            # reduction METHOD call: x.any() — the Call parent decides,
            # but seeing the attribute inside a call test is enough
            if sub.attr in _ARRAY_METHODS:
                return True
        elif isinstance(sub, ast.Call):
            if call_name(sub, aliases).startswith(("numpy.", "torch.")):
                return True
        elif isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


def _index_set(call, aliases) -> bool:
    """Does this call build a data-dependent index set?  numpy's
    ``where`` counts with any arity (as the JAX package's rule has it);
    ``torch.where`` only in its one-argument, ``nonzero`` form."""
    name = call_name(call, aliases)
    if name in _DATA_ITER:
        return True
    if name == "torch.where":
        return len(call.args) == 1 and not call.keywords
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in _DATA_ITER_METHODS)


class _JitRuleBase(AnalyzerRule):
    family = "jit"
    severity = "warning"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            aliases = import_aliases(tree)
            seen: set = set()
            for tpath, qual, fn in jit_targets(ctx):
                if tpath != path or (path, qual) in seen:
                    continue
                seen.add((path, qual))
                tainted = _array_tainted_names(fn, aliases)
                out.extend(self.check_function(path, qual, fn, aliases,
                                               tainted))
        return out

    def check_function(self, path, qual, fn, aliases, tainted):
        raise NotImplementedError

    def _finding(self, path, node, qual, kind, message, hint):
        return Finding(
            rule=self.rule, severity=self.severity, path=path,
            line=node.lineno, scope=qual,
            detail=f"{kind}:{unparse_trim(node, 40)}",
            message=message, hint=hint)


@register_rule
class ArrayBranchRule(_JitRuleBase):
    """JIT101: Python ``if`` branching on an array value inside a
    target — a host sync, and no CUDA graph can hold the branch."""

    rule = "JIT101"
    title = "Python if on array value in a hot-path target"

    def check_function(self, path, qual, fn, aliases, tainted):
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.If) and _smells_array(
                    node.test, aliases, tainted):
                out.append(self._finding(
                    path, node.test, qual, "if",
                    f"{qual}: `if {unparse_trim(node.test)}` branches "
                    f"on an array value — a host sync that stalls "
                    f"async dispatch and breaks CUDA-graph capture",
                    "compute both sides and select with torch.where / "
                    "a mask, or move the branch into the kernel"))
        return out


@register_rule
class HostCoercionRule(_JitRuleBase):
    """JIT102: ``float()``/``int()``/``bool()``/``.item()`` host
    round-trips of computed (array-derived) values, and torch's other
    read-backs: ``.tolist()``, ``.cpu()``, ``.numpy()``."""

    rule = "JIT102"
    title = "host read-back in a hot-path target"

    def check_function(self, path, qual, fn, aliases, tainted):
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node, aliases)
            is_cast = (name in ("float", "int", "bool")
                       and len(node.args) == 1)
            is_item = (isinstance(node.func, ast.Attribute)
                       and node.func.attr in _READBACKS)
            if is_cast:
                arg = node.args[0]
                computed = not isinstance(arg, (ast.Constant, ast.Name)) \
                    or (isinstance(arg, ast.Name) and arg.id in tainted)
                if not computed:
                    continue
            elif not is_item:
                continue
            out.append(self._finding(
                path, node, qual, "coerce",
                f"{qual}: `{unparse_trim(node)}` forces a device->host "
                f"sync — stalls async dispatch, breaks CUDA-graph "
                f"capture",
                "keep the value as a 0-d tensor on the device (mask with "
                "torch.where) or move the loop into the kernel; read "
                "back once, at the call's end"))
        return out


@register_rule
class DataDependentLoopRule(_JitRuleBase):
    """JIT103: data-dependent Python loops (``while`` on array state,
    ``while True``, ``for`` over nonzero/unique index sets)."""

    rule = "JIT103"
    title = "data-dependent Python loop in a hot-path target"

    def check_function(self, path, qual, fn, aliases, tainted):
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.While):
                is_true = (isinstance(node.test, ast.Constant)
                           and node.test.value is True)
                if is_true or _smells_array(node.test, aliases, tainted):
                    out.append(self._finding(
                        path, node.test, qual, "while",
                        f"{qual}: `while {unparse_trim(node.test)}` — "
                        f"trip count depends on array data (a host "
                        f"read an iteration)",
                        "move the loop into the kernel, or run a "
                        "bounded loop with masking and read back once"))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                it = node.iter
                if isinstance(it, ast.Call) and _index_set(it, aliases):
                    out.append(self._finding(
                        path, it, qual, "for",
                        f"{qual}: `for … in {unparse_trim(it)}` — "
                        f"iteration set is data-dependent",
                        "vectorize over the full axis with a mask "
                        "(torch.where) instead of gathering indices"))
        return out


def scorecard(ctx, findings) -> list:
    """Per-target readiness rows: (path, qualname, {rule: count},
    ready?).  Functions with zero jit findings read nothing back to the
    host: graph-capture ready."""
    by_scope: dict = {}
    for f in findings:
        if f.rule.startswith("JIT"):
            by_scope.setdefault((f.path, f.scope), {}).setdefault(
                f.rule, 0)
            by_scope[(f.path, f.scope)][f.rule] += 1
    rows = []
    for path, qual, _fn in sorted(jit_targets(ctx)):
        counts = by_scope.get((path, qual), {})
        rows.append((path, qual, counts, not counts))
    return rows
