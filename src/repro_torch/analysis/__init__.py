"""repro_torch.analysis — swarmlint for the port: static invariant
analysis of ``src/repro_torch`` in torch's terms.

The JAX package's analyzer, rule for rule, with the layers picked by the
port's paths and each rule's numpy or jax calls joined by torch's
counterparts.  Four rule families guard the contracts the port's claims
rest on:

* ``rng``         — one threaded rng stream (RNG001-RNG007): numpy's
                    legacy globals and torch's global stream, fresh or
                    constant-seeded ``np.random.Generator`` and
                    ``torch.Generator`` objects;
* ``visibility``  — SlotView tier discipline at lint time (VIS001);
* ``jit``         — host-sync / CUDA-graph-capture readiness of the
                    hot paths (JIT101-JIT103) + scorecard;
* ``obs``         — telemetry discipline in the sim layers: no print,
                    no inline host-time reads (OBS001-OBS002); route
                    through ``repro_torch.obs`` / the injectable clocks.

Pure stdlib (no numpy/torch import), so ``python -m
repro_torch.analysis`` runs anywhere a checkout exists.  Rules
self-register via :func:`register_rule`, mirroring
``repro_torch.core.policy.register_policy``.
"""
from .findings import (Baseline, Finding, split_by_baseline,
                       write_baseline)
from .registry import (FAMILIES, AnalysisContext, AnalyzerRule,
                       get_rules, register_rule, rule_ids)

# Importing the rule modules registers their rules.
from . import jit_rules, obs_rules, rng_rules, visibility
from .cli import DEFAULT_BASELINE, collect_findings, main
from .jit_rules import JIT_TARGETS, scorecard
from .visibility import slotview_tiers

__all__ = [
    "AnalysisContext", "AnalyzerRule", "Baseline", "DEFAULT_BASELINE",
    "FAMILIES", "Finding", "JIT_TARGETS", "collect_findings",
    "get_rules", "jit_rules", "main", "obs_rules", "register_rule",
    "rng_rules", "rule_ids", "scorecard", "slotview_tiers",
    "split_by_baseline", "visibility", "write_baseline",
]
