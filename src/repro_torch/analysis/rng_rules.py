"""Determinism / rng-discipline rules (family ``rng``).

The simulation's headline invariant is ONE threaded stream: every draw
that can influence a schedule, a trace or a parameter flows through an
rng parameter seeded exactly once at an entry point
(``SwarmConfig.seed``, ``FLConfig.seed``) — an ``np.random.Generator``
in the host modules, a ``torch.Generator`` (``gen``) in the models and
the slot engine — with derived streams split off via salted
``SeedSequence``s.  These rules flag the ways that contract silently
breaks: process-global streams (numpy's legacy module calls, torch's
draws without ``generator=`` and its global seeding), generators seeded
from OS entropy or from constants inside library code, unordered-set
iteration feeding loop order, identity-based sorts, and wall-clock
reads inside the simulation layers.
"""
from __future__ import annotations

import ast

from .findings import Finding
from .registry import AnalyzerRule, register_rule
from .resolve import (call_name, dotted, import_aliases,
                      is_constant_expr, unparse_trim)

# Legacy process-global numpy RNG surface (np.random.<fn> module calls).
_NP_LEGACY = {
    "rand", "randn", "random", "random_sample", "ranf", "sample",
    "choice", "seed", "shuffle", "permutation", "permuted", "randint",
    "random_integers", "uniform", "normal", "standard_normal",
    "binomial", "poisson", "beta", "gamma", "exponential", "bytes",
    "get_state", "set_state",
}

# torch's draws from its process-global default generator unless given
# ``generator=`` (torch.<fn> module calls).
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson", "torch.rand_like", "torch.randn_like",
    "torch.randint_like",
}

# torch calls that seed, reseed or read the process-global generators.
_TORCH_GLOBAL = {
    "torch.manual_seed", "torch.seed",
    "torch.get_rng_state", "torch.set_rng_state",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.random.get_rng_state", "torch.random.set_rng_state",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.cuda.get_rng_state", "torch.cuda.set_rng_state",
    "torch.cuda.get_rng_state_all", "torch.cuda.set_rng_state_all",
}

# In-place Tensor samplers (and torch.nn.init's of the same names):
# the global stream unless given ``generator=``.
_TORCH_INPLACE = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
}

# numpy generator constructors whose seeding discipline RNG003/RNG004
# police; torch's generator is matched separately (its seed is not a
# constructor argument).
_GEN_CTORS = {"numpy.random.default_rng", "numpy.random.SeedSequence"}
_TORCH_GEN = "torch.Generator"
# torch's process-global generators, reached as objects.
_TORCH_GLOBAL_GENS = {"torch.default_generator",
                      "torch.cuda.default_generators"}

# Parameter names that mark a function as rng-threaded.
_RNG_PARAMS = {"rng", "key", "prng", "prng_key", "rngs", "generator",
               "gen"}

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}


def _calls(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _param_names(fn) -> set:
    a = fn.args
    names = [p.arg for p in
             (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _no_generator(call: ast.Call) -> bool:
    """No ``generator=`` keyword, or ``generator=None``: torch's
    process-global stream."""
    for kw in call.keywords:
        if kw.arg == "generator":
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value is None)
        if kw.arg is None:          # **kwargs may carry one
            return False
    return True


def _is_torch_gen_ctor(node, aliases) -> bool:
    return (isinstance(node, ast.Call)
            and call_name(node, aliases) == _TORCH_GEN)


def _gen_value(node, aliases) -> bool:
    """A ``torch.Generator(...)`` expression: the constructor itself or
    a ``.manual_seed(...)`` chained on one (which returns it)."""
    while (isinstance(node, ast.Call)
           and isinstance(node.func, ast.Attribute)
           and node.func.attr == "manual_seed"):
        node = node.func.value
    return _is_torch_gen_ctor(node, aliases)


def _generator_names(ctx, path, tree, aliases) -> dict:
    """Enclosing scope -> names bound to a ``torch.Generator`` there."""
    scopes = ctx.scopes(path)
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _gen_value(node.value,
                                                      aliases):
            sc = scopes.get(node.lineno, "<module>")
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(sc, set()).add(tgt.id)
    return out


def _is_generator(node, names, aliases) -> bool:
    """Is ``node`` a torch generator: built here, bound to one of
    ``names``, or one of torch's global generators?"""
    if _gen_value(node, aliases):
        return True
    if isinstance(node, ast.Name) and node.id in names:
        return True
    if isinstance(node, ast.Subscript):
        node = node.value
    return dotted(node, aliases) in _TORCH_GLOBAL_GENS


@register_rule
class StdlibRandomRule(AnalyzerRule):
    """RNG001: any stdlib ``random.*`` call in library code."""

    rule = "RNG001"
    family = "rng"
    severity = "error"
    title = "stdlib random.* call (process-global, unseeded stream)"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_library(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if name.startswith("random.") and name.count(".") == 1:
                    out.append(Finding(
                        rule=self.rule, severity=self.severity,
                        path=path, line=call.lineno,
                        scope=scopes.get(call.lineno, "<module>"),
                        detail=name,
                        message=f"stdlib {name}() draws from the "
                                f"process-global Mersenne stream",
                        hint="thread the shared np.random.Generator "
                             "(view.rng / a cfg-seeded stream) or "
                             "torch.Generator (gen) instead"))
        return out


@register_rule
class NumpyGlobalRngRule(AnalyzerRule):
    """RNG002: process-global streams — legacy ``np.random.<fn>`` module
    calls, torch's draws without ``generator=`` (``torch.rand``, ...,
    and the in-place ``Tensor.uniform_``, ...), and torch's global
    seeding (``torch.manual_seed``, ``torch.cuda.manual_seed_all``,
    ...)."""

    rule = "RNG002"
    family = "rng"
    severity = "error"
    title = "process-global RNG call (legacy numpy / torch default stream)"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_library(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if (name.startswith("numpy.random.")
                        and name.rsplit(".", 1)[1] in _NP_LEGACY):
                    detail = name
                    message = (f"{name}() mutates/reads numpy's "
                               f"process-global RNG state")
                    hint = ("use a threaded np.random.Generator method "
                            "on the shared stream")
                elif name in _TORCH_GLOBAL:
                    detail = name
                    message = (f"{name}() seeds/reads torch's "
                               f"process-global generator")
                    hint = ("seed a torch.Generator at the entry point "
                            "and thread it (gen=) instead")
                elif name in _TORCH_DRAWS and _no_generator(call):
                    detail = name
                    message = (f"{name}() without generator= draws from "
                               f"torch's process-global stream")
                    hint = "pass the threaded torch.Generator (generator=gen)"
                elif (isinstance(call.func, ast.Attribute)
                      and call.func.attr in _TORCH_INPLACE
                      and _no_generator(call)):
                    detail = (name if name.startswith("torch.")
                              else f"Tensor.{call.func.attr}")
                    message = (f"{detail}() without generator= draws "
                               f"from torch's process-global stream")
                    hint = "pass the threaded torch.Generator (generator=gen)"
                else:
                    continue
                out.append(Finding(
                    rule=self.rule, severity=self.severity,
                    path=path, line=call.lineno,
                    scope=scopes.get(call.lineno, "<module>"),
                    detail=detail, message=message, hint=hint))
        return out


@register_rule
class UnseededGeneratorRule(AnalyzerRule):
    """RNG003: ``default_rng()`` / ``SeedSequence()`` with no seed, or
    ``<gen>.seed()`` on a ``torch.Generator``, in library code — fresh
    OS entropy, unreproducible by construction.  A bare
    ``torch.Generator()`` is not: it starts from torch's fixed default
    seed, a constant (RNG004's business)."""

    rule = "RNG003"
    family = "rng"
    severity = "error"
    title = "generator seeded from OS entropy in library code"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_library(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            gens = _generator_names(ctx, path, tree, aliases)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if call.args or call.keywords:
                    continue
                sc = scopes.get(call.lineno, "<module>")
                if name in _GEN_CTORS:
                    short = name.rsplit(".", 1)[1]
                    detail = f"{short}()"
                elif (isinstance(call.func, ast.Attribute)
                      and call.func.attr == "seed"
                      and _is_generator(call.func.value,
                                        gens.get(sc, ()), aliases)):
                    detail = "Generator.seed()"
                else:
                    continue
                out.append(Finding(
                    rule=self.rule, severity=self.severity,
                    path=path, line=call.lineno, scope=sc,
                    detail=detail,
                    message=f"{detail} seeds from OS entropy — "
                            f"every run differs",
                    hint="seed from cfg.seed (or a salted "
                         "SeedSequence) or accept a threaded rng "
                         "parameter"))
        return out


def _seeded_names(fn) -> tuple:
    """(names given ``.manual_seed(<constant>)``, names given any other
    seeding) inside ``fn``: ``.manual_seed(<expr>)``, ``.seed()`` or
    ``.set_state(...)``."""
    const, other = set(), set()
    for call in ast.walk(fn):
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)):
            continue
        attr, who = call.func.attr, call.func.value.id
        if attr == "manual_seed" and call.args and all(
                is_constant_expr(a) for a in call.args):
            const.add(who)
        elif attr in ("manual_seed", "seed", "set_state"):
            other.add(who)
    return const, other


@register_rule
class ConstantSeedShadowRule(AnalyzerRule):
    """RNG004: a generator built from a hard-coded constant seed inside
    a function that already takes a threaded rng/gen parameter — the
    classic silent-fallback bug: every un-threaded call returns the
    SAME 'random' result while the call site looks seeded.  For torch:
    ``torch.Generator(...).manual_seed(<constant>)``, the same split
    over a bound name, and a bare ``torch.Generator()`` never seeded
    (torch's fixed default seed)."""

    rule = "RNG004"
    family = "rng"
    severity = "error"
    title = "constant-seeded generator shadows a threaded rng param"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_library(path):
                continue
            aliases = import_aliases(tree)
            for qual, fn in ctx.walk_functions(tree):
                if not (_param_names(fn) & _RNG_PARAMS):
                    continue
                for call, detail in self._constant_seeds(fn, aliases):
                    short = detail.split("(", 1)[0]
                    out.append(Finding(
                        rule=self.rule, severity=self.severity,
                        path=path, line=call.lineno, scope=qual,
                        detail=detail,
                        message=f"{short} built from a constant "
                                f"seed inside {qual}(), which "
                                f"takes a threaded rng parameter "
                                f"— unthreaded calls all produce "
                                f"identical draws",
                        hint="require the rng parameter (raise "
                             "when None) instead of a constant-"
                             "seed fallback"))
        return out

    @staticmethod
    def _constant_seeds(fn, aliases):
        """(call, detail) of each constant-seeded generator in ``fn``."""
        const, other = _seeded_names(fn)
        # Constructors that a chained .manual_seed(...) seeds.
        chained = set()
        bound = {}                  # id(ctor) -> the name it is bound to
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "manual_seed"
                    and _is_torch_gen_ctor(node.func.value, aliases)):
                chained.add(id(node.func.value))
            elif isinstance(node, ast.Assign) and _is_torch_gen_ctor(
                    node.value, aliases):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        bound[id(node.value)] = tgt.id
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            name = call_name(call, aliases)
            if name in _GEN_CTORS:
                if call.args and all(is_constant_expr(a)
                                     for a in call.args):
                    short = name.rsplit(".", 1)[1]
                    yield call, (f"{short}("
                                 f"{unparse_trim(call.args[0], 24)})")
            elif (isinstance(call.func, ast.Attribute)
                  and call.func.attr == "manual_seed"
                  and _is_torch_gen_ctor(call.func.value, aliases)):
                if call.args and all(is_constant_expr(a)
                                     for a in call.args):
                    yield call, (f"Generator.manual_seed("
                                 f"{unparse_trim(call.args[0], 24)})")
            elif (isinstance(call.func, ast.Attribute)
                  and call.func.attr == "manual_seed"
                  and isinstance(call.func.value, ast.Name)
                  and call.func.value.id in const
                  and call.func.value.id in bound.values()):
                yield call, (f"Generator.manual_seed("
                             f"{unparse_trim(call.args[0], 24)})")
            elif name == _TORCH_GEN and id(call) not in chained:
                who = bound.get(id(call))
                if who is None or who not in const | other:
                    yield call, "Generator()"


@register_rule
class SetIterationRule(AnalyzerRule):
    """RNG005: iterating a ``set``/``frozenset`` in the simulation
    layers — set order is hash-salt/insertion dependent, so any loop
    over one can reorder scheduling decisions or trace rows."""

    rule = "RNG005"
    family = "rng"
    severity = "error"
    title = "unordered-set iteration in a simulation layer"

    def _is_set_expr(self, node, aliases) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            return call_name(node, aliases) in ("set", "frozenset")
        return False

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_sim_layer(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            # Names bound to set-producing expressions, per enclosing
            # scope (module level keys on "<module>").
            tainted: dict = {}
            for node in ast.walk(tree):
                if (isinstance(node, ast.Assign)
                        and self._is_set_expr(node.value, aliases)):
                    sc = scopes.get(node.lineno, "<module>")
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.setdefault(sc, set()).add(tgt.id)

            def iter_exprs(node):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    yield node.iter
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    for gen in node.generators:
                        yield gen.iter

            for node in ast.walk(tree):
                for it in iter_exprs(node):
                    sc = scopes.get(node.lineno, "<module>")
                    bad = self._is_set_expr(it, aliases) or (
                        isinstance(it, ast.Name)
                        and it.id in tainted.get(sc, ()))
                    if bad:
                        what = (it.id if isinstance(it, ast.Name)
                                else "set-literal")
                        out.append(Finding(
                            rule=self.rule, severity=self.severity,
                            path=path, line=node.lineno, scope=sc,
                            detail=what,
                            message=f"iteration over unordered set "
                                    f"{what!r} — order is undefined "
                                    f"across runs/salts",
                            hint="iterate sorted(...) or keep an "
                                 "ordered container (list / np array)"))
        return out


@register_rule
class IdSortRule(AnalyzerRule):
    """RNG006: ``sorted(..., key=id)`` / ``.sort(key=id)`` — object
    addresses vary per process, the order is noise."""

    rule = "RNG006"
    family = "rng"
    severity = "error"
    title = "id()-keyed sort"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_library(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if not (name == "sorted" or name.endswith(".sort")):
                    continue
                for kw in call.keywords:
                    if (kw.arg == "key" and isinstance(kw.value, ast.Name)
                            and kw.value.id == "id"):
                        out.append(Finding(
                            rule=self.rule, severity=self.severity,
                            path=path, line=call.lineno,
                            scope=scopes.get(call.lineno, "<module>"),
                            detail=name,
                            message="sort keyed on id() orders by "
                                    "memory address — different every "
                                    "process",
                            hint="sort on a stable field (index, name, "
                                 "tuple of values)"))
        return out


@register_rule
class WallClockRule(AnalyzerRule):
    """RNG007: wall-clock reads inside ``core/``, ``net/``, ``fl/`` —
    simulated time must come from the slot counter / event engine
    clock, never the host."""

    rule = "RNG007"
    family = "rng"
    severity = "error"
    title = "wall-clock read in a simulation layer"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_sim_layer(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if name in _WALLCLOCK:
                    out.append(Finding(
                        rule=self.rule, severity=self.severity,
                        path=path, line=call.lineno,
                        scope=scopes.get(call.lineno, "<module>"),
                        detail=name,
                        message=f"{name}() reads the host clock inside "
                                f"a simulation layer",
                        hint="use the engine clock (EventEngine.t / "
                             "slot index); wall-clock belongs in "
                             "benchmarks only"))
        return out
