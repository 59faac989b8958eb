"""Analyzer rule registry — the ``register_policy`` idiom for lint rules.

A rule is one class with a stable ``rule`` id, a ``family``
(``"rng"`` / ``"visibility"`` / ``"jit"``), a default severity, and a
``check(ctx)`` returning :class:`~repro_torch.analysis.findings.Finding`
lists over the parsed-module :class:`AnalysisContext`.  Rules
self-register under :func:`register_rule`, mirroring
``repro_torch.core.policy.register_policy``, so adding an invariant is one
class — it shows up in the CLI, the baseline keys, and the unit-test
matrix without touching the CLI.
"""
from __future__ import annotations

import ast
from pathlib import Path

FAMILIES = ("rng", "visibility", "jit", "obs")


class AnalysisContext:
    """Parsed view of the files under analysis.

    ``modules`` maps repo-relative posix paths to parsed ``ast.Module``
    trees; ``sources`` to raw text.  Helpers classify layers the rule
    families scope to (``core/``, ``net/``, ``fl/`` of the port are the
    simulation-determinism layers; everything under ``src/repro_torch``
    is library code).
    """

    def __init__(self, root: Path, assume_library: bool = False):
        self.root = Path(root)
        self.modules: dict[str, ast.Module] = {}
        self.sources: dict[str, str] = {}
        self.errors: list[str] = []
        # Treat every analyzed file as library + sim-layer code (rule
        # fixtures and ad-hoc runs outside the src tree).
        self.assume_library = assume_library
        self._scope_cache: dict[str, dict] = {}

    # -- construction ---------------------------------------------------
    def add_paths(self, paths) -> "AnalysisContext":
        for p in paths:
            p = Path(p)
            if not p.is_absolute():
                p = self.root / p
            files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
            for f in files:
                self.add_file(f)
        return self

    def add_file(self, f: Path):
        f = Path(f)
        try:
            rel = f.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        if rel in self.modules:
            return
        src = f.read_text(encoding="utf-8")
        try:
            self.modules[rel] = ast.parse(src, filename=rel)
        except SyntaxError as e:
            self.errors.append(f"{rel}: syntax error: {e}")
            return
        self.sources[rel] = src

    # -- layer classification -------------------------------------------
    def is_library(self, path: str) -> bool:
        if self.assume_library:
            return True
        return ("src/repro_torch/" in f"/{path}"
                or path.startswith("repro_torch/"))

    def is_sim_layer(self, path: str) -> bool:
        """core/, net/, fl/ — the layers whose determinism the slot/event
        parity and golden-schedule tests rely on."""
        if self.assume_library:
            return True
        return any(f"repro_torch/{layer}/" in path
                   for layer in ("core", "net", "fl"))

    def scopes(self, path: str) -> dict:
        """Memoized lineno -> enclosing-qualname map for a module."""
        if path not in self._scope_cache:
            self._scope_cache[path] = self.enclosing_scopes(
                self.modules[path])
        return self._scope_cache[path]

    def walk_functions(self, tree: ast.Module):
        """Yield ``(qualname, FunctionDef)`` for every def in a module."""
        def rec(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    yield q, child
                    yield from rec(child, q + ".")
                elif isinstance(child, ast.ClassDef):
                    yield from rec(child, f"{prefix}{child.name}.")
        yield from rec(tree, "")

    def enclosing_scopes(self, tree: ast.Module) -> dict:
        """lineno -> qualname of the innermost enclosing def/class."""
        spans = []
        for q, fn in self.walk_functions(tree):
            spans.append((fn.lineno, fn.end_lineno, q))
        out = {}
        for lo, hi, q in sorted(spans, key=lambda s: (s[0], -s[1])):
            for ln in range(lo, (hi or lo) + 1):
                out[ln] = q         # inner defs overwrite outer spans
        return out


class AnalyzerRule:
    """One static invariant check (see module docstring)."""

    rule: str = ""
    family: str = ""
    severity: str = "error"
    title: str = ""

    def check(self, ctx: AnalysisContext):
        raise NotImplementedError

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"{type(self).__name__}(rule={self.rule!r}, "
                f"family={self.family!r}, severity={self.severity!r})")


_REGISTRY: dict[str, type] = {}


def register_rule(cls: type) -> type:
    """Class decorator: make ``cls`` resolvable by its ``rule`` id."""
    if not issubclass(cls, AnalyzerRule):
        raise TypeError(f"{cls!r} is not an AnalyzerRule")
    if not cls.rule:
        raise ValueError(f"{cls.__name__} must set a non-empty .rule")
    if cls.family not in FAMILIES:
        raise ValueError(f"{cls.__name__}.family must be one of "
                         f"{FAMILIES}, got {cls.family!r}")
    if cls.rule in _REGISTRY and _REGISTRY[cls.rule] is not cls:
        raise ValueError(f"duplicate rule id {cls.rule!r}")
    _REGISTRY[cls.rule] = cls
    return cls


def rule_ids() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_rules(families=None) -> list:
    """Fresh instances of every registered rule (optionally one
    family)."""
    out = []
    for rid in rule_ids():
        cls = _REGISTRY[rid]
        if families is None or cls.family in families:
            out.append(cls())
    return out
