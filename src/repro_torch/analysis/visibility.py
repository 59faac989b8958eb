"""Visibility-escape rule (family ``visibility``).

The port's ``core/policy.py`` gates what a :class:`SlotView` reveals by the
policy's declared tier (``"none"`` < ``"neighborhood"`` < ``"full"``)
— but only at *runtime*, so an over-reaching plugin that no test
executes ships silently.  VIS001 turns the gate into a lint-time
guarantee: it derives the accessor tier table from ``SlotView``'s own
source (every ``self._require(VISIBILITY_X, ...)`` call), resolves
every registered/derived ``SchedulerPolicy`` subclass, and walks the
``schedule()`` call graph with the view object tainted through
assignments, helper calls, and ``self.*`` methods.  Any reachable
accessor whose tier exceeds the declared visibility is a finding.

``_engine_state`` carries no ``_require`` gate (it is the audited
backend door for the equivalence-locked built-in engines) and is
pinned to the ``"full"`` tier here — a plugin reaching it escapes the
tier system entirely.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding
from .registry import AnalyzerRule, register_rule
from .resolve import import_aliases

TIER_LEVELS = {"none": 0, "neighborhood": 1, "full": 2}
_VIS_NAMES = {"VISIBILITY_FULL": "full",
              "VISIBILITY_NEIGHBORHOOD": "neighborhood",
              "VISIBILITY_NONE": "none"}
_ROOT_CLASS = "SchedulerPolicy"
_MAX_DEPTH = 6


def _policy_source(ctx):
    """(path, source) of the port's core/policy.py — from the analyzed
    set if present, else from this package's sibling tree (so analyzing
    only ``examples/`` still gets the real tier table)."""
    for path, src in ctx.sources.items():
        if path.endswith("repro_torch/core/policy.py"):
            return path, src
    p = Path(__file__).resolve().parent.parent / "core" / "policy.py"
    return p.as_posix(), p.read_text(encoding="utf-8")


def _tier_expr(node) -> str:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in TIER_LEVELS else ""
    name = ""
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return _VIS_NAMES.get(name, "")


def slotview_tiers(src: str) -> dict:
    """Accessor name -> required tier, derived from SlotView's AST.

    A method/property is gated at the tier its ``self._require(...)``
    call names; everything else is ungated (``"none"``).  The audited
    ``_engine_state`` door is pinned ``"full"``.
    """
    tree = ast.parse(src)
    tiers: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "SlotView":
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if item.name in ("_require", "__init__"):
                    continue
                tier = "none"
                for call in ast.walk(item):
                    if (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "_require"
                            and call.args):
                        got = _tier_expr(call.args[0])
                        if got:
                            tier = got
                tiers[item.name] = tier
    tiers["_engine_state"] = "full"
    return tiers


class _ClassInfo:
    def __init__(self, path, node, bases):
        self.path = path
        self.node = node
        self.bases = bases                    # base-name tails
        self.methods = {m.name: m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}


def _class_table(ctx) -> dict:
    table: dict = {}
    for path, tree in ctx.modules.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        bases.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        bases.append(b.attr)
                # First definition wins; policy classes have unique
                # names in practice.
                table.setdefault(node.name, _ClassInfo(path, node, bases))
    return table


def _is_policy(name, table, seen=None) -> bool:
    if name == _ROOT_CLASS:
        return True
    seen = seen or set()
    if name in seen or name not in table:
        return False
    seen.add(name)
    return any(_is_policy(b, table, seen) for b in table[name].bases)


def _mro(name, table):
    """Linearized class chain (the class, then bases, breadth-first)."""
    out, queue, seen = [], [name], set()
    while queue:
        cur = queue.pop(0)
        if cur in seen or cur not in table:
            seen.add(cur)
            continue
        seen.add(cur)
        out.append(table[cur])
        queue.extend(table[cur].bases)
    return out


def _declared_visibility(name, table) -> str:
    for info in _mro(name, table):
        for item in info.node.body:
            if isinstance(item, ast.Assign):
                for tgt in item.targets:
                    if (isinstance(tgt, ast.Name)
                            and tgt.id == "visibility"):
                        tier = _tier_expr(item.value)
                        if tier:
                            return tier
            elif (isinstance(item, ast.AnnAssign)
                  and isinstance(item.target, ast.Name)
                  and item.target.id == "visibility"
                  and item.value is not None):
                tier = _tier_expr(item.value)
                if tier:
                    return tier
    return "full"                 # SchedulerPolicy's own default


def _module_functions(tree) -> dict:
    return {f.name: f for f in tree.body
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _resolve_free_function(ctx, cur_path, name, aliases):
    """(path, FunctionDef) for a called module-level function, resolved
    in the current module or across analyzed modules via imports."""
    funcs = _module_functions(ctx.modules[cur_path])
    if name in funcs:
        return cur_path, funcs[name]
    target = aliases.get(name, "")
    if "." in target:
        mod_tail, fn_name = target.rsplit(".", 1)
        mod_file = mod_tail.replace(".", "/") + ".py"
        for path, tree in ctx.modules.items():
            if path.endswith(mod_file) or path.endswith(
                    "/" + mod_tail.split(".")[-1] + ".py"):
                cand = _module_functions(tree)
                if fn_name in cand:
                    return path, cand[fn_name]
    return None, None


@register_rule
class VisibilityEscapeRule(AnalyzerRule):
    """VIS001: a policy's schedule() call graph reaches a SlotView
    accessor above its declared visibility tier."""

    rule = "VIS001"
    family = "visibility"
    severity = "error"
    title = "policy call graph escapes its declared visibility tier"

    def check(self, ctx):
        _, policy_src = _policy_source(ctx)
        tiers = slotview_tiers(policy_src)
        table = _class_table(ctx)
        out = []
        for name, info in table.items():
            if name == _ROOT_CLASS or not _is_policy(name, table):
                continue
            entry = None
            for cls_info in _mro(name, table):
                if "schedule" in cls_info.methods:
                    entry = cls_info
                    break
            if entry is None:
                continue
            # Report on the class that *declares* the tier; inherited
            # schedule() bodies are analyzed in the subclass's context
            # only when the subclass re-declares nothing — skip the
            # duplicate walk when the defining class is itself a policy
            # with the same declared tier (its own row covers it).
            declared = _declared_visibility(name, table)
            if (entry.node.name != name
                    and _declared_visibility(entry.node.name, table)
                    == declared):
                continue
            self._walk_policy(ctx, name, declared, entry, table, tiers,
                              out)
        return out

    # -- call-graph taint walk ------------------------------------------
    def _walk_policy(self, ctx, cls_name, declared, entry, table, tiers,
                     out):
        lvl = TIER_LEVELS[declared]
        visited = set()
        hits: dict = {}     # accessor -> (path, line, func qualname)

        def visit(path, fn, tainted, depth, qual, owner):
            key = (path, fn.lineno, frozenset(tainted))
            if depth > _MAX_DEPTH or key in visited:
                return
            visited.add(key)
            aliases = import_aliases(ctx.modules[path])
            local = set(tainted)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if (isinstance(node.value, ast.Name)
                            and node.value.id in local):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                local.add(tgt.id)
                elif isinstance(node, ast.Attribute):
                    if (isinstance(node.value, ast.Name)
                            and node.value.id in local
                            and node.attr in tiers
                            and TIER_LEVELS[tiers[node.attr]] > lvl):
                        hits.setdefault(
                            node.attr, (path, node.lineno, qual))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                t_args = [
                    isinstance(a, ast.Name) and a.id in local
                    for a in node.args]
                t_kw = {kw.arg: isinstance(kw.value, ast.Name)
                        and kw.value.id in local
                        for kw in node.keywords if kw.arg}
                callee = path2 = None
                self_call = (isinstance(node.func, ast.Attribute)
                             and isinstance(node.func.value, ast.Name)
                             and node.func.value.id == "self")
                if self_call and owner is not None:
                    for cls_info in _mro(owner, table):
                        if node.func.attr in cls_info.methods:
                            callee = cls_info.methods[node.func.attr]
                            path2 = cls_info.path
                            break
                elif isinstance(node.func, ast.Name):
                    path2, callee = _resolve_free_function(
                        ctx, path, node.func.id, aliases)
                if callee is None:
                    continue
                params = [p.arg for p in (*callee.args.posonlyargs,
                                          *callee.args.args)]
                if self_call and params and params[0] == "self":
                    params = params[1:]
                nxt = {p for p, t in zip(params, t_args) if t}
                nxt |= {p for p, t in t_kw.items() if t}
                if not nxt and not self_call:
                    continue       # no view flows in; nothing to find
                visit(path2, callee, nxt, depth + 1,
                      f"{qual}->{callee.name}",
                      owner if self_call else None)

        sched = entry.methods["schedule"]
        params = [p.arg for p in (*sched.args.posonlyargs,
                                  *sched.args.args)]
        seed = {p for p in params[1:]} & {"view"}
        if not seed and len(params) > 1:
            seed = {params[1]}
        visit(entry.path, sched, seed, 0, f"{cls_name}.schedule",
              cls_name)

        aliases = {v: k for k, v in _VIS_NAMES.items()}
        for accessor, (path, line, qual) in sorted(hits.items()):
            need = tiers[accessor]
            out.append(Finding(
                rule=self.rule, severity=self.severity,
                path=path, line=line, scope=cls_name, detail=accessor,
                message=f"{cls_name} declares visibility "
                        f"{declared!r} but {qual} reaches SlotView."
                        f"{accessor} (requires {need!r})"
                        + (" — the ungated engine door"
                           if accessor == "_engine_state" else ""),
                hint=f"use accessors at or below "
                     f"{aliases.get(declared, declared)} tier "
                     f"(e.g. availability_union/resolve_requests), or "
                     f"declare visibility={need!r} honestly"))
