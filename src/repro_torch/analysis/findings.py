"""The ``Finding`` record + inline suppression parsing (counterpart of
``repro.analysis.findings``).

A finding is one rule violation at one source location; its identity for
baseline matching is ``(path, rule, message)`` — the line number is for
humans and editors, so unrelated edits that shift lines never invalidate
a committed baseline (``baseline.py`` has the count semantics).

Suppressions are inline comments, pylint-style but namespaced so the two
tools never fight over a line::

    n = int(t.sum())        # nucleuslint: disable=NL101
    # nucleuslint: disable=NL102,NL103   (suppresses the NEXT line too)
    # nucleuslint: disable=all

A suppression on the finding's own line or the line directly above it
applies; ``all`` suppresses every rule.  Suppressions are deliberate,
reviewable markers — prefer them over baselining for code that is
*correct* but outside a rule's precision (the baseline is for accepted
legacy findings).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*nucleuslint:\s*disable=([A-Za-z0-9_,\s]+|all)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation: file:line + rule id + message + fix hint."""

    path: str          # repo-relative, '/'-separated
    line: int          # 1-indexed
    col: int           # 0-indexed (ast convention)
    rule: str          # e.g. "NL101"
    message: str       # what is wrong, with the offending names inlined
    hint: str = ""     # how to fix it

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers drift, (path, rule, message)
        does not (messages inline the offending names, so two distinct
        violations in one file rarely collide; colliding ones share a
        baseline budget — see ``baseline.apply_baseline``)."""
        return (self.path, self.rule, self.message)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col + 1}"
        out = f"{loc}: {self.rule}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def parse_suppressions(lines: Sequence[str]) -> Dict[int, frozenset]:
    """Map 1-indexed line number -> rules suppressed AT that line.

    A ``# nucleuslint: disable=...`` comment covers its own line and the
    following line (the comment-above idiom); ``all`` becomes the
    sentinel ``{"all"}``.
    """
    out: Dict[int, frozenset] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        spec = m.group(1).strip()
        rules = (frozenset({"all"}) if spec == "all" else
                 frozenset(r.strip().upper()
                           for r in spec.split(",") if r.strip()))
        for line in (i, i + 1):
            out[line] = out.get(line, frozenset()) | rules
    return out


def is_suppressed(finding: Finding,
                  suppressions: Dict[int, frozenset]) -> bool:
    rules = suppressions.get(finding.line)
    return bool(rules) and ("all" in rules or finding.rule in rules)


def apply_suppressions(findings: List[Finding],
                       suppressions: Dict[int, frozenset]) -> List[Finding]:
    return [f for f in findings if not is_suppressed(f, suppressions)]
