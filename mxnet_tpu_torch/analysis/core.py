"""Lint findings and reports (``mxnet_tpu/analysis/core.py``): the
:class:`Finding` record with its node provenance and the
:class:`LintReport` that collects findings, as the JAX package writes
them.  The quantization emission report is made of these; the graph
views and the pass framework come with the passes (ROADMAP item 10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from ..base import MXNetError

__all__ = ["ERROR", "WARN", "INFO", "SEVERITIES", "Finding", "LintReport"]

ERROR = "error"
WARN = "warn"
INFO = "info"
SEVERITIES = (ERROR, WARN, INFO)


@dataclass
class Finding:
    """One lint finding with node provenance.

    ``node`` is the symbol node the finding anchors to (``<graph>`` for
    whole-graph findings); ``layer`` is the source layer the finding is
    billed to.  ``detail`` carries structured provenance: op params,
    symbol attrs, shapes, dims.
    """

    rule: str
    severity: str
    node: str
    op: str
    message: str
    layer: Optional[str] = None
    detail: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise MXNetError("finding severity must be one of %s, got %r"
                             % (SEVERITIES, self.severity))

    def format(self) -> str:
        where = self.node
        if self.layer and self.layer != self.node:
            where = "%s@%s" % (self.node, self.layer)
        return "[%s] %-22s %s(%s): %s" % (
            self.severity.upper(), self.rule, where, self.op, self.message)

    def dedupe_key(self) -> str:
        """Stable identity for one finding across runs and sources:
        ``rule|node|op|layer`` — deliberately EXCLUDES the message (its
        wording carries volatile values — ages, counts, thread idents)
        so graph and concurrency findings dedupe on what they flag, not
        on how they phrase it."""
        return "%s|%s|%s|%s" % (self.rule, self.node, self.op,
                                self.layer or "")

    def to_dict(self) -> Dict[str, Any]:
        d = {"rule": self.rule, "severity": self.severity, "node": self.node,
             "op": self.op, "message": self.message}
        if self.layer:
            d["layer"] = self.layer
        if self.detail:
            d["detail"] = {k: str(v) for k, v in self.detail.items()}
        return d


class LintReport:
    """Findings + the annotated graph for one linted program."""

    def __init__(self, model: str = "<graph>"):
        self.model = model
        self.findings: List[Finding] = []
        self.traced = False

    def extend(self, findings: Iterable[Finding]):
        self.findings.extend(findings)
        return self

    def dedupe(self) -> "LintReport":
        """Drop findings whose :meth:`Finding.dedupe_key` repeats,
        keeping the first (stable order) — one report line per distinct
        hazard site regardless of how many passes or replays saw it."""
        seen, kept = set(), []
        for f in self.findings:
            k = f.dedupe_key()
            if k in seen:
                continue
            seen.add(k)
            kept.append(f)
        self.findings = kept
        return self

    def filter_severity(self, min_severity: Optional[str]) -> "LintReport":
        """Keep findings at or above ``min_severity`` (``None`` keeps
        all) — the ``--severity`` CLI filter, shared by graph and
        concurrency reports."""
        if min_severity is None:
            return self
        if min_severity not in SEVERITIES:
            raise MXNetError("severity must be one of %s, got %r"
                             % (SEVERITIES, min_severity))
        order = {s: i for i, s in enumerate(SEVERITIES)}
        cut = order[min_severity]
        self.findings = [f for f in self.findings
                         if order[f.severity] <= cut]
        return self

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        return c

    def by_rule(self, severity=None) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for f in self.findings:
            if severity is None or f.severity == severity:
                c[f.rule] = c.get(f.rule, 0) + 1
        return dict(sorted(c.items()))

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    def summary(self, max_findings=50) -> str:
        c = self.counts()
        lines = ["graph-lint[%s]: %d error, %d warn, %d info%s"
                 % (self.model, c[ERROR], c[WARN], c[INFO],
                    "" if self.traced else " (symbol-level only)")]
        order = {ERROR: 0, WARN: 1, INFO: 2}
        shown = sorted(self.findings, key=lambda f: order[f.severity])
        for f in shown[:max_findings]:
            lines.append("  " + f.format())
        if len(shown) > max_findings:
            lines.append("  ... %d more" % (len(shown) - max_findings))
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"model": self.model, "counts": self.counts(),
                "errors_by_rule": self.by_rule(ERROR),
                "warns_by_rule": self.by_rule(WARN),
                "infos_by_rule": self.by_rule(INFO),
                "findings": [f.to_dict() for f in self.findings]}
