"""repro_torch.analysis, the port's swarmlint, held to repro.analysis.

On the JAX package's own fixtures (tests/static_fixtures/) both
analyzers must give the same findings; on torch fixtures
(tests/static_fixtures_torch/) each planted hazard fires the rule its
``# RULE`` marker names, on its line, and nothing else fires.  Then the
registry and baseline mechanics of tests/test_analysis.py against the
port's classes, and the shipped tree under the port's own baseline,
``analysis_baseline_torch.json``.
"""
import ast
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from collections import Counter
from contextlib import redirect_stdout
from pathlib import Path

import pytest

import repro.analysis as ref
import repro_torch.analysis as port
from repro_torch.analysis import (AnalysisContext, AnalyzerRule, Baseline,
                                  Finding, collect_findings, register_rule,
                                  rule_ids, scorecard, split_by_baseline,
                                  write_baseline)
from repro_torch.analysis.registry import _REGISTRY
from test_torch_analysis import DOORS

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "static_fixtures"
TORCH_FIXTURES = REPO / "tests" / "static_fixtures_torch"
MARK = re.compile(r"#\s*((?:(?:RNG|JIT|OBS|VIS)\d{3}\s*)+)$")


def _run(pkg, files, families=None, assume_library=True):
    ctx = pkg.AnalysisContext(REPO, assume_library=assume_library)
    ctx.add_paths(files)
    assert not ctx.errors, ctx.errors
    return pkg.collect_findings(ctx, families)


def _keys(found):
    return sorted((f.rule, f.path, f.line, f.scope, f.detail)
                  for f in found)


def _marked(path: Path) -> Counter:
    """(rule, line) of every ``# RULE`` marker in a torch fixture."""
    want = Counter()
    for i, line in enumerate(path.read_text().splitlines(), 1):
        m = MARK.search(line)
        if m:
            for rule in m.group(1).split():
                want[(rule, i)] += 1
    return want


def _main(argv, cwd=REPO):
    """The port's CLI in this process: (exit code, stdout)."""
    buf, here = io.StringIO(), os.getcwd()
    os.chdir(cwd)
    try:
        with redirect_stdout(buf):
            rc = port.main(argv)
    finally:
        os.chdir(here)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# parity with repro.analysis on the JAX package's fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in
                                        FIXTURES.glob("*.py")))
def test_fixture_findings_equal_the_reference(name):
    want = _keys(_run(ref, [FIXTURES / name]))
    got = _keys(_run(port, [FIXTURES / name]))
    assert got == want
    if name.endswith("_bad.py"):
        assert got                      # the parity is not vacuous


def test_rule_ids_and_families_equal_the_reference():
    assert port.rule_ids() == ref.rule_ids()
    assert port.FAMILIES == ref.FAMILIES
    assert ({(r.rule, r.family, r.severity) for r in port.get_rules()}
            == {(r.rule, r.family, r.severity) for r in ref.get_rules()})


def test_list_rules_columns_equal_the_reference():
    """``--list-rules`` names the same ids, families and severities; the
    titles of RNG002, RNG003 and the jit family say torch's meaning."""
    def columns(main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--list-rules"]) == 0
        return [line.split("]")[0] + "] " + line.split("]")[1].split()[0]
                for line in buf.getvalue().splitlines()]
    got = columns(port.main)
    assert got == columns(ref.main)
    assert len(got) == 13


# ---------------------------------------------------------------------------
# torch fixtures: each planted hazard at its line, the good twins silent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["rng", "jit"])
def test_torch_hazards_fire_at_their_lines(family):
    path = TORCH_FIXTURES / f"{family}_bad.py"
    want = _marked(path)
    assert want
    found = _run(port, [path], families=(family,))
    assert Counter((f.rule, f.line) for f in found) == want


@pytest.mark.parametrize("family", ["rng", "jit"])
def test_torch_good_fixtures_are_silent(family):
    assert _run(port, [TORCH_FIXTURES / f"{family}_good.py"]) == []


def test_bare_generator_is_not_os_entropy():
    path = TORCH_FIXTURES / "rng_bad.py"
    lines = path.read_text().splitlines()
    (bare,) = [i for i, ln in enumerate(lines, 1)
               if ln.strip().startswith("g = torch.Generator()")]
    found = _run(port, [path], families=("rng",))
    assert not [f for f in found if f.line == bare]
    details = {f.detail for f in found if f.rule == "RNG003"}
    assert details == {"Generator.seed()"}


def test_constant_seed_shadows_name_the_threaded_function():
    found = _run(port, [TORCH_FIXTURES / "rng_bad.py"], families=("rng",))
    shadows = {(f.scope, f.detail) for f in found if f.rule == "RNG004"}
    assert shadows == {("chained_shadow", "Generator.manual_seed(0)"),
                       ("split_shadow", "Generator.manual_seed(1234)"),
                       ("bare_shadow", "Generator()")}


def test_reference_analyzer_misses_the_torch_forms():
    """Why the port needs rules of its own: the JAX package's analyzer
    sees none of torch's rng hazards and only the value branches of its
    host syncs."""
    assert _run(ref, [TORCH_FIXTURES / "rng_bad.py"]) == []
    jit = _run(ref, [TORCH_FIXTURES / "jit_bad.py"])
    assert len(jit) < sum(_marked(TORCH_FIXTURES / "jit_bad.py").values())


def test_torch_jit_kinds_and_severity():
    found = _run(port, [TORCH_FIXTURES / "jit_bad.py"], families=("jit",))
    assert all(f.severity == "warning" for f in found)
    coerced = {f.detail for f in found if f.rule == "JIT102"}
    assert {"coerce:rates.tolist()", "coerce:rates.cpu()",
            "coerce:host.numpy()", "coerce:rem.min().item()"} <= coerced
    assert {f.detail.split(":", 1)[0] for f in found
            if f.rule == "JIT103"} == {"while", "for"}


# ---------------------------------------------------------------------------
# registry (as tests/test_analysis.py, on the port's classes)
# ---------------------------------------------------------------------------

def test_registry_rejects_non_rule_and_anonymous_rule():
    with pytest.raises(TypeError):
        register_rule(object)

    class NoId(AnalyzerRule):
        family = "rng"
    with pytest.raises(ValueError, match="non-empty"):
        register_rule(NoId)

    class BadFamily(AnalyzerRule):
        rule = "XXX999"
        family = "nope"
    with pytest.raises(ValueError, match="family"):
        register_rule(BadFamily)


def test_registry_rejects_duplicate_rule_id():
    class Clash(AnalyzerRule):
        rule = "RNG001"
        family = "rng"
    with pytest.raises(ValueError, match="duplicate"):
        register_rule(Clash)
    assert _REGISTRY["RNG001"] is not Clash
    assert _REGISTRY is not ref.registry._REGISTRY


def test_all_four_families_registered():
    ids = rule_ids()
    assert ids == tuple(sorted(ids))
    assert {"RNG001", "RNG002", "RNG003", "RNG004", "RNG005", "RNG006",
            "RNG007", "VIS001", "JIT101", "JIT102", "JIT103",
            "OBS001", "OBS002"} <= set(ids)


@pytest.mark.parametrize("path, library, sim", [
    ("src/repro_torch/core/state.py", True, True),
    ("src/repro_torch/net/fairshare.py", True, True),
    ("src/repro_torch/fl/runner.py", True, True),
    ("src/repro_torch/launch/serve.py", True, False),
    ("repro_torch/kernels/slots.py", True, False),
    ("src/repro/core/state.py", False, False),
    ("examples/quickstart_torch.py", False, False),
])
def test_layers_are_the_ports(path, library, sim):
    ctx = AnalysisContext(REPO)
    assert ctx.is_library(path) is library
    assert ctx.is_sim_layer(path) is sim
    every = AnalysisContext(REPO, assume_library=True)
    assert every.is_library(path) and every.is_sim_layer(path)


def test_tier_table_comes_from_the_analyzed_policy(tmp_path):
    """The port's ``core/policy.py`` in the analyzed set gives the tier
    table, not the installed fallback: an accessor only it gates
    fires."""
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "policy.py").write_text(
        "VISIBILITY_FULL = 'full'\n\n\n"
        "class SlotView:\n"
        "    def peek(self):\n"
        "        self._require(VISIBILITY_FULL, 'peek')\n\n\n"
        "class SchedulerPolicy:\n"
        "    visibility = VISIBILITY_FULL\n\n\n"
        "class Peeker(SchedulerPolicy):\n"
        "    visibility = 'none'\n\n"
        "    def schedule(self, view):\n"
        "        return view.peek()\n")
    ctx = AnalysisContext(tmp_path).add_paths([tmp_path / "src"])
    found = collect_findings(ctx, ("visibility",))
    assert [(f.scope, f.detail) for f in found] == [("Peeker", "peek")]


def test_scorecard_separates_ready_from_worklist():
    ctx = AnalysisContext(REPO, assume_library=True)
    ctx.add_paths([TORCH_FIXTURES / "jit_bad.py",
                   TORCH_FIXTURES / "jit_good.py"])
    rows = scorecard(ctx, collect_findings(ctx, ("jit",)))
    status = {(Path(p).name, q): ready for p, q, _c, ready in rows}
    assert status[("jit_bad.py", "transport")] is False
    assert status[("jit_good.py", "transport")] is True
    assert status[("jit_bad.py", "maxmin_rates")] is False
    assert status[("jit_good.py", "maxmin_rates")] is True


# ---------------------------------------------------------------------------
# baseline mechanics
# ---------------------------------------------------------------------------

def _finding(**kw):
    base = dict(rule="RNG002", severity="error", path="a.py", line=3,
                message="m", scope="f", detail="torch.rand")
    base.update(kw)
    return Finding(**base)


def test_finding_key_is_line_stable():
    assert _finding(line=3).key == _finding(line=99).key
    assert _finding().key == "RNG002:a.py:f:torch.rand"


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps(
        {"version": 1,
         "entries": [{"key": "RNG002:a.py:f:torch.rand",
                      "justification": "  "}]}))
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(p)


def test_baseline_split_and_stale(tmp_path):
    f1, f2 = _finding(), _finding(detail="Tensor.normal_")
    p = tmp_path / "b.json"
    write_baseline(p, [f1])
    bl = Baseline.load(p)
    new, old = split_by_baseline([f1, f2], bl)
    assert old == [f1] and new == [f2]
    assert bl.unused([f2]) == [f1.key]


def test_write_baseline_preserves_justifications(tmp_path):
    p = tmp_path / "b.json"
    write_baseline(p, [_finding()])
    raw = json.loads(p.read_text())
    raw["entries"][0]["justification"] = "reviewed: fine"
    p.write_text(json.dumps(raw))
    prev = Baseline.load(p)
    write_baseline(p, [_finding(), _finding(detail="Tensor.normal_")],
                   prev)
    entries = {e["key"]: e["justification"]
               for e in json.loads(p.read_text())["entries"]}
    assert entries[_finding().key] == "reviewed: fine"
    assert entries[_finding(detail="Tensor.normal_").key].startswith(
        "TODO")


# ---------------------------------------------------------------------------
# the shipped tree under the port's own baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped():
    ctx = AnalysisContext(REPO)
    ctx.add_paths([REPO / "src" / "repro_torch", REPO / "examples"])
    assert not ctx.errors, ctx.errors
    return ctx, collect_findings(ctx)


@pytest.mark.parametrize("family", ["rng", "obs"])
def test_shipped_port_is_clean(shipped, family):
    """No rng finding in the port's library code and no obs finding in
    its core/, net/ and fl/: nothing hides behind the baseline."""
    _, found = shipped
    rules = {r.rule for r in port.get_rules((family,))}
    hits = [f.render() for f in found if f.rule in rules]
    assert not hits, "\n".join(hits)


def test_shipped_visibility_exactly_the_doors(shipped):
    _, found = shipped
    vis = [f for f in found if f.rule == "VIS001"]
    assert {(f.path, f.scope, f.line) for f in vis} == DOORS
    assert all(f.detail == "_engine_state" for f in vis)


def test_shipped_baseline_justified_and_not_stale(shipped):
    _, found = shipped
    bl = Baseline.load(REPO / port.DEFAULT_BASELINE)
    new, old = split_by_baseline(found, bl)
    assert new == [], "\n".join(f.render() for f in new)
    assert bl.unused(found) == []
    assert len({f.key for f in old}) == len(bl.entries)
    assert all(len(j) > 40 and "TODO" not in j
               for j in bl.entries.values())
    assert all(k.split(":", 2)[1].startswith("src/repro_torch/")
               for k in bl.entries)


def _functions(path: Path) -> Counter:
    tree = ast.parse(path.read_text())
    return Counter(n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)))


def test_every_jit_target_resolves_to_one_port_function():
    """One row per JAX target, each a function that exists where the
    table says: a later move cannot make a row vanish silently."""
    names = [n for ns in port.JIT_TARGETS.values() for n in ns]
    assert sorted(names) == sorted(n for ns in ref.JIT_TARGETS.values()
                                   for n in ns)
    assert len(names) == len(set(names)) == 13
    for suffix, wanted in port.JIT_TARGETS.items():
        assert suffix.startswith("repro_torch/")
        defs = _functions(REPO / "src" / suffix)
        for name in wanted:
            assert defs[name] == 1, (suffix, name)


def test_shipped_scorecard_has_one_row_per_target(shipped):
    ctx, found = shipped
    rows = scorecard(ctx, found)
    tails = sorted(q.rsplit(".", 1)[-1] for _p, q, _c, _r in rows)
    assert tails == sorted(n for ns in port.JIT_TARGETS.values()
                           for n in ns)
    ready = {q.rsplit(".", 1)[-1]: r for _p, q, _c, r in rows}
    assert ready["_slot_rounds"] and ready["_extract_ranked"]
    assert not ready["_schedule_centralized_batched"]


def test_cli_exits_zero_on_shipped_tree():
    """``python -m repro_torch.analysis src/repro_torch examples`` from
    the repo root is clean under the port's baseline."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "examples"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jit-readiness scorecard" in proc.stdout
    assert "0 new finding(s), 16 baselined" in proc.stdout
    assert "stale" not in proc.stdout


def test_cli_without_baseline_exits_one_on_shipped_tree():
    rc, out = _main(["--no-baseline", "src/repro_torch", "examples"])
    assert rc == 1
    assert "16 new finding(s), 0 baselined" in out


def test_cli_exits_nonzero_on_new_findings():
    rc, out = _main(["--no-baseline", "--assume-library",
                     str(TORCH_FIXTURES / "rng_bad.py")])
    assert rc == 1
    assert "RNG004" in out and "RNG003" in out


def test_cli_usage_errors_exit_two(tmp_path):
    assert _main(["--families", "nope", "src/repro_torch"])[0] == 2
    assert _main([str(tmp_path)])[0] == 2           # no python files


def test_default_baseline_is_the_ports_own(tmp_path):
    """Never the JAX package's ``analysis_baseline.json``: its keys name
    ``src/repro/`` paths, and ``--update-baseline`` must not write it."""
    assert port.DEFAULT_BASELINE == "analysis_baseline_torch.json"
    assert ref.cli.DEFAULT_BASELINE != port.DEFAULT_BASELINE
    fixture = tmp_path / "rng_bad.py"
    fixture.write_text((TORCH_FIXTURES / "rng_bad.py").read_text())
    rc, _ = _main(["--update-baseline", "--assume-library", "rng_bad.py"],
                  cwd=tmp_path)
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "analysis_baseline_torch.json", "rng_bad.py"]
    rc, out = _main(["--assume-library", "rng_bad.py"], cwd=tmp_path)
    assert rc == 0 and "0 new finding(s)" in out


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_analysis_phase_on_the_host():
    """``chip_smoke.run_analysis``, the phase that runs the analyzer on
    the card host, needs no card: the same counts as the CLI."""
    out = _load_smoke().run_analysis()
    assert {k: out[k] for k in ("rules", "new", "baselined", "rows")} == {
        "rules": 13, "new": 0, "baselined": 16, "rows": 13}
    assert 0 < out["ready"] < out["rows"] and out["files"] > 90


def test_chip_smoke_analysis_phase_fails_on_a_stale_entry(tmp_path,
                                                         monkeypatch):
    smoke = _load_smoke()
    stale = tmp_path / "analysis_baseline_torch.json"
    raw = json.loads((REPO / port.DEFAULT_BASELINE).read_text())
    raw["entries"].append({"key": "RNG002:src/repro_torch/x.py:f:torch.rand",
                           "justification": "gone since the rewrite"})
    stale.write_text(json.dumps(raw))
    monkeypatch.setattr(port, "DEFAULT_BASELINE", str(stale))
    with pytest.raises(smoke.SmokeFailure, match="stale"):
        smoke.run_analysis()
