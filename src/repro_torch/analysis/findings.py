"""Structured findings + the justified-baseline mechanism (swarmlint).

A :class:`Finding` is one rule hit with a *stable identity*: the
baseline keys on ``rule:path:scope:detail`` (never the line number, so
unrelated edits don't churn the baseline).  A baseline entry suppresses
a finding only when it carries a non-empty human justification — the
baseline is a reviewed ledger of accepted debt, not a mute button.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete site.

    ``scope``  — enclosing symbol (``Class.method`` / function name),
    ``detail`` — rule-specific stable token (accessor name, call name,
    construct kind) so the baseline key survives line drift.
    """

    rule: str
    severity: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    hint: str = ""
    scope: str = ""
    detail: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{self.severity:7s} {self.rule} {loc} [{self.scope}] {self.message}"
        if self.hint:
            out += f"\n        hint: {self.hint}"
        return out


@dataclass
class Baseline:
    """Justified suppression ledger (``analysis_baseline_torch.json``).

    Schema::

        {"version": 1,
         "entries": [{"key": "<finding key>",
                      "justification": "<why this is accepted>"}]}
    """

    entries: dict = field(default_factory=dict)   # key -> justification
    path: str = ""

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
        if not isinstance(raw, dict) or "entries" not in raw:
            raise ValueError(f"{path}: baseline must be an object with "
                             f"an 'entries' list")
        entries = {}
        for i, e in enumerate(raw["entries"]):
            key = e.get("key", "")
            just = str(e.get("justification", "")).strip()
            if not key:
                raise ValueError(f"{path}: entry {i} has no 'key'")
            if not just:
                raise ValueError(
                    f"{path}: entry {key!r} has no justification — a "
                    f"baseline entry must say WHY the finding is "
                    f"accepted")
            entries[key] = just
        return cls(entries=entries, path=str(path))

    def covers(self, finding: Finding) -> bool:
        return finding.key in self.entries

    def unused(self, findings) -> list:
        """Baseline keys no current finding matches (stale entries)."""
        live = {f.key for f in findings}
        return sorted(k for k in self.entries if k not in live)


def split_by_baseline(findings, baseline: Baseline | None):
    """Partition findings into (new, baselined)."""
    if baseline is None:
        return list(findings), []
    new, old = [], []
    for f in findings:
        (old if baseline.covers(f) else new).append(f)
    return new, old


def write_baseline(path, findings, previous: Baseline | None = None):
    """Emit a baseline covering ``findings``; keeps prior justifications
    and stamps ``TODO: justify`` on fresh entries.  :meth:`Baseline.load`
    refuses only empty justifications, so a TODO loads and stays visible
    debt until someone writes the reason."""
    prev = previous.entries if previous is not None else {}
    seen = []
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.scope,
                                             f.detail)):
        if f.key in (e["key"] for e in seen):
            continue
        seen.append({"key": f.key,
                     "justification": prev.get(f.key, "TODO: justify")})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": seen}, fh, indent=2)
        fh.write("\n")
