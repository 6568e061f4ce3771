"""``python -m repro_torch.analysis`` — the port's nucleuslint CLI (the
gate; counterpart of ``python -m repro.analysis``).

Exit status is the contract: 0 = clean modulo the committed baseline,
1 = new findings (or stale baseline entries under ``--strict-stale``),
2 = usage error.  Run it from the repository's root.

    python -m repro_torch.analysis src/repro_torch     # lint the port
    python -m repro_torch.analysis src/repro_torch/serve
    python -m repro_torch.analysis --json out.json     # machine-readable
    python -m repro_torch.analysis --regen-baseline    # re-accept
    python -m repro_torch.analysis --dead --dead-json dead.json
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .baseline import (DEFAULT_BASELINE, apply_baseline, load_baseline,
                       write_baseline)
from .deadmod import dead_module_report
from .driver import load_project, rule_catalog, run_analysis


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="nucleuslint for the PyTorch/CUDA port: host syncs, "
                    "per-call builds, concurrency and registry rules")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--json", metavar="FILE",
                    help="also write findings + summary as JSON "
                         "('-' for stdout)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("--regen-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(the diff is the review artifact) and exit 0")
    ap.add_argument("--only", action="append", default=None,
                    metavar="PREFIX",
                    help="restrict to rule-id prefixes (repeatable), "
                         "e.g. --only NL3")
    ap.add_argument("--dead", action="store_true",
                    help="also run the dead-module report")
    ap.add_argument("--dead-json", metavar="FILE",
                    help="write the dead-module report as JSON "
                         "(implies --dead)")
    ap.add_argument("--strict-stale", action="store_true",
                    help="fail when baseline entries no longer fire")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in rule_catalog():
            print(f"{rule}  {desc}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    project = load_project(paths)
    findings = run_analysis(project, only=args.only)

    if args.regen_baseline:
        path = write_baseline(findings, args.baseline)
        print(f"nucleuslint: baseline regenerated -> {path} "
              f"({len(findings)} findings accepted)")
        return 0

    baseline = (load_baseline(args.baseline)
                if not args.no_baseline else None)
    if baseline is not None:
        new, stale = apply_baseline(findings, baseline)
    else:
        new, stale = findings, []

    for f in new:
        print(f.render())
    n_baselined = len(findings) - len(new)
    status = (f"nucleuslint: {len(new)} finding(s)"
              f" ({len(findings)} total, {n_baselined} baselined)")
    if stale:
        status += f"; {len(stale)} stale baseline entr(y/ies)"
        for path, rule, message in stale:
            print(f"stale baseline: {path}: {rule}: {message}")
    print(status)

    dead = None
    if args.dead or args.dead_json:
        dead = dead_module_report()
        print(f"dead modules: {len(dead['dead'])} of "
              f"{dead['n_modules']} unreachable from "
              f"core/serve/launch/tools, tests/test_torch_*.py and "
              f"chip_smoke.py")
        for line in dead["dead_summary"]:
            print(f"  {line}")
        print(f"nucleus-only view (core/serve roots): "
              f"{len(dead['nucleus_unreachable'])} modules outside the "
              f"nucleus product")
        for line in dead["nucleus_unreachable_summary"]:
            print(f"  {line}")
        if args.dead_json:
            with open(args.dead_json, "w") as f:
                json.dump(dead, f, indent=1, sort_keys=True)
                f.write("\n")

    if args.json:
        blob = {
            "tool": "nucleuslint",
            "paths": paths,
            "n_total": len(findings),
            "n_new": len(new),
            "n_baselined": n_baselined,
            "stale_baseline": [list(k) for k in stale],
            "findings": [f.to_dict() for f in new],
            "all_findings": [f.to_dict() for f in findings],
        }
        if dead is not None:
            blob["dead_modules"] = dead
        if args.json == "-":
            json.dump(blob, sys.stdout, indent=1, sort_keys=True)
            sys.stdout.write("\n")
        else:
            with open(args.json, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
                f.write("\n")

    if new:
        return 1
    if stale and args.strict_stale:
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `... | head` closed our stdout; exit quietly like other CLIs
        sys.stderr.close()
        sys.exit(0)
