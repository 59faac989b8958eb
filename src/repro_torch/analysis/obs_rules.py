"""Observability-discipline rules (family ``obs``).

``repro_torch.obs`` makes telemetry a typed, recordable stream; these
rules keep the port's simulation layers from growing ad-hoc side channels
around it.  ``core/`` / ``net/`` / ``fl/`` hot paths must not write to
stdout (``print``) nor read host time directly (``time.*``): stdout
telemetry is unqueryable and breaks the zero-overhead-when-disabled
contract, and direct clock reads bypass both the injectable measurement
clock (``repro_torch.core.simulator.set_clock`` / ``measured_clock``) and the
recorder's injectable span clock — the same hole RNG007 polices for
determinism, policed here for telemetry routing (OBS002 also covers
``time.sleep``/``strftime``-style calls RNG007's wall-clock set does
not).
"""
from __future__ import annotations

import ast

from .findings import Finding
from .registry import AnalyzerRule, register_rule
from .resolve import call_name, import_aliases


def _calls(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


@register_rule
class PrintRule(AnalyzerRule):
    """OBS001: ``print(...)`` in a simulation layer — ad-hoc stdout
    telemetry that no exporter, report, or regression gate can see."""

    rule = "OBS001"
    family = "obs"
    severity = "error"
    title = "print() in a simulation layer"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_sim_layer(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                if call_name(call, aliases) == "print":
                    out.append(Finding(
                        rule=self.rule, severity=self.severity,
                        path=path, line=call.lineno,
                        scope=scopes.get(call.lineno, "<module>"),
                        detail="print",
                        message="print() is write-only telemetry in a "
                                "simulation layer — invisible to the "
                                "obs exporters and the regression gate",
                        hint="emit a typed repro_torch.obs event/counter "
                             "(obs.get().event(...)) or raise/warn"))
        return out


@register_rule
class HostTimeRule(AnalyzerRule):
    """OBS002: any direct ``time.*`` call in a simulation layer — host
    time must flow through the injectable clocks (``measured_clock`` /
    the recorder's span clock), never be read inline."""

    rule = "OBS002"
    family = "obs"
    severity = "error"
    title = "direct time.* call in a simulation layer"

    def check(self, ctx):
        out = []
        for path, tree in ctx.modules.items():
            if not ctx.is_sim_layer(path):
                continue
            aliases = import_aliases(tree)
            scopes = ctx.scopes(path)
            for call in _calls(tree):
                name = call_name(call, aliases)
                if name.startswith("time.") and name.count(".") == 1:
                    out.append(Finding(
                        rule=self.rule, severity=self.severity,
                        path=path, line=call.lineno,
                        scope=scopes.get(call.lineno, "<module>"),
                        detail=name,
                        message=f"{name}() reads/uses host time inline "
                                f"in a simulation layer",
                        hint="route through the injectable measurement "
                             "clock (repro_torch.core.simulator."
                             "measured_clock) or a repro_torch.obs "
                             "Recorder span"))
        return out
