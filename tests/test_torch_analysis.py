"""The port's simulation layers held to swarmlint's rules.

``repro.analysis`` classifies a file as library and simulation-layer
code by its ``src/repro/`` path, so its shipped-tree tests
(tests/test_analysis.py) hold none of ``src/repro_torch/`` to the rng,
obs and visibility rules.  Here the reference analyzer runs with
``assume_library=True`` over the port's ``core``, ``net`` and ``fl``
(the GPU slot engine ``core/jit_engine.py`` among them) and the result
is pinned: no rng finding, no obs finding, and visibility findings at
exactly the audited engine doors.  The port's own analyzer,
``repro_torch.analysis``, picks those layers by the port's paths, so it
runs without ``assume_library`` and must find the same.
"""
from pathlib import Path

import pytest

import repro_torch.analysis as port
from repro.analysis import AnalysisContext, collect_findings, get_rules

REPO = Path(__file__).resolve().parent.parent
PORT_LAYERS = ("src/repro_torch/core", "src/repro_torch/net",
               "src/repro_torch/fl")
# The audited engine doors, the same two as the JAX package's baseline
# (analysis_baseline.json): the distributed and flooding policies read
# the engine state through ``SlotView._engine_state`` to run their
# batched backends.  The jit engine adds none: it is reached from the
# centralized policies, whose tier is "full", and reads no SlotView.
DOORS = {("src/repro_torch/core/schedulers.py", "DistributedPolicy", 909),
         ("src/repro_torch/core/schedulers.py", "FloodingPolicy", 933)}


@pytest.fixture(scope="module")
def findings():
    ctx = AnalysisContext(REPO, assume_library=True)
    ctx.add_paths([REPO / p for p in PORT_LAYERS])
    assert not ctx.errors, ctx.errors
    assert "src/repro_torch/core/jit_engine.py" in ctx.modules
    return collect_findings(ctx)


@pytest.mark.parametrize("family", ["rng", "obs"])
def test_port_layers_have_no_findings(findings, family):
    rules = {r.rule for r in get_rules() if r.family == family}
    hits = [f.render() for f in findings if f.rule in rules]
    assert not hits, "\n".join(hits)


def test_port_visibility_findings_are_the_audited_doors(findings):
    vis = {(f.path, f.scope, f.line) for f in findings
           if f.rule == "VIS001"}
    assert vis == DOORS
    assert all(f.detail == "_engine_state" for f in findings
               if f.rule == "VIS001")


@pytest.fixture(scope="module")
def port_findings():
    ctx = port.AnalysisContext(REPO)
    ctx.add_paths([REPO / p for p in PORT_LAYERS])
    assert not ctx.errors, ctx.errors
    return port.collect_findings(ctx)


def _keys(found):
    return sorted((f.rule, f.path, f.line, f.scope, f.detail)
                  for f in found)


def test_port_analyzer_finds_the_same_without_assume_library(
        findings, port_findings):
    assert _keys(port_findings) == _keys(findings)
    assert {(f.path, f.scope, f.line) for f in port_findings
            if f.rule == "VIS001"} == DOORS
