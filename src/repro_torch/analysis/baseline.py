"""The committed findings baseline: accepted findings don't block the gate
(counterpart of ``repro.analysis.baseline``).

The baseline is a JSON file (``.nucleuslint-torch-baseline.json`` at the
repo root; the reference's ``.nucleuslint-baseline.json`` is its own)
listing findings the port accepts as they stand (its host syncs that are
not suppressed inline: the inventory later speed work starts from) so
the gate fails only on NEW findings.  Matching ignores line numbers: an entry is
``(path, rule, message)`` and the file stores a *count* per key, so two
identical violations in one file consume two baseline slots — fixing one
of them shrinks the next ``--regen-baseline`` diff instead of hiding the
survivor.

``--regen-baseline`` rewrites the file from the current findings (the
review artifact for intentionally accepting a finding is the JSON diff,
as in the reference).  Stale entries — baselined
findings that no longer fire — are reported by ``apply_baseline`` so the
file shrinks monotonically instead of fossilizing.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Tuple

from .findings import Finding

BASELINE_FORMAT = "repro_torch.nucleuslint-baseline"
BASELINE_VERSION = 1
DEFAULT_BASELINE = ".nucleuslint-torch-baseline.json"

Key = Tuple[str, str, str]


def load_baseline(path: str) -> Counter:
    """Key -> allowed count.  A missing file is an empty baseline (first
    run of a fresh checkout must still gate on everything)."""
    if not os.path.exists(path):
        return Counter()
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != BASELINE_FORMAT:
        raise ValueError(
            f"{path}: not a nucleuslint baseline (format="
            f"{blob.get('format')!r}); regenerate it with "
            f"python -m repro_torch.analysis --regen-baseline")
    out: Counter = Counter()
    for e in blob.get("findings", []):
        out[(e["path"], e["rule"], e["message"])] += int(e.get("count", 1))
    return out


def write_baseline(findings: List[Finding], path: str) -> str:
    """Serialize current findings as the new baseline (sorted, counted —
    the diff IS the review artifact)."""
    counts: Counter = Counter(f.key for f in findings)
    lines: Dict[Key, int] = {}
    for f in sorted(findings):
        lines.setdefault(f.key, f.line)
    entries = [
        {"path": p, "rule": r, "message": m, "count": c,
         "line": lines[(p, r, m)]}   # informational only, not matched
        for (p, r, m), c in sorted(counts.items())]
    blob = {"format": BASELINE_FORMAT, "version": BASELINE_VERSION,
            "findings": entries}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def apply_baseline(findings: List[Finding], baseline: Counter
                   ) -> Tuple[List[Finding], List[Key]]:
    """Split findings into (new, stale-baseline-keys).

    Each finding consumes one slot of its baseline key's count; findings
    past the count (or unknown keys) are NEW and gate CI.  Keys with
    unconsumed slots are STALE — the violation was fixed, so the entry
    should leave the baseline at the next ``--regen-baseline``.
    """
    budget = Counter(baseline)
    new: List[Finding] = []
    for f in sorted(findings):
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    stale = sorted(k for k, c in budget.items() if c > 0)
    return new, stale
