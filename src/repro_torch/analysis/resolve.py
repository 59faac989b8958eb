"""Import-aware name resolution shared by the rule families.

Turns an ``ast`` call target back into a canonical dotted path
(``np.random.default_rng`` -> ``numpy.random.default_rng``;
``from time import perf_counter`` + ``perf_counter()`` ->
``time.perf_counter``) so rules match on what is actually called, not
on whatever alias a module picked.
"""
from __future__ import annotations

import ast


def import_aliases(tree: ast.Module) -> dict:
    """Local name -> canonical dotted origin, from a module's imports.

    ``import numpy as np``            np   -> numpy
    ``import numpy.random``           numpy -> numpy (root binding)
    ``from numpy import random as r`` r    -> numpy.random
    ``from datetime import datetime`` datetime -> datetime.datetime
    Relative imports keep their bare module tail (enough to recognise
    in-package targets like ``.policy``).
    """
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                out[local] = f"{mod}.{a.name}" if mod else a.name
    return out


def dotted(node: ast.AST, aliases: dict) -> str:
    """Canonical dotted path of a Name/Attribute chain, or ``""``.

    The chain's root is translated through ``aliases``; unknown roots
    pass through verbatim (so ``self.rng.choice`` still yields
    ``self.rng.choice`` for structural matching).
    """
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    parts.reverse()
    parts[0] = aliases.get(parts[0], parts[0])
    return ".".join(parts)


def call_name(call: ast.Call, aliases: dict) -> str:
    return dotted(call.func, aliases)


def is_constant_expr(node: ast.AST) -> bool:
    """Literal-only expression (constants, containers of constants,
    unary minus) — i.e. a hard-coded seed."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return is_constant_expr(node.operand)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(is_constant_expr(e) for e in node.elts)
    return False


def unparse_trim(node: ast.AST, width: int = 48) -> str:
    try:
        s = ast.unparse(node)
    except Exception:   # pragma: no cover - very old constructs
        s = type(node).__name__
    s = " ".join(s.split())
    return s if len(s) <= width else s[: width - 1] + "…"
