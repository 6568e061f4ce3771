"""The checker driver: load sources once, run every rule, merge output
(counterpart of ``repro.analysis.driver``).

A rule is a callable ``(module: Module, project: Project) -> List[Finding]``
registered in ``RULES``.  The driver parses each file once into a
``Module`` (source text, AST, suppression table), bundles them into a
``Project`` (rules that need cross-file context — NL401 reads the
registry module regardless of which files were requested — get the whole
picture), then applies inline suppressions and the committed baseline.

Adding a rule: write the checker in the matching ``rules_*`` module, give
it a ``CATALOG`` entry (it becomes ``--list-rules`` output), and append
the module to ``_rules`` here.  Rules are pure functions of the ASTs: no
import of the analyzed code, so linting never imports torch.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .findings import Finding, apply_suppressions, parse_suppressions


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: str                      # repo-relative, '/'-separated
    source: str
    tree: ast.Module
    suppressions: Dict[int, frozenset]

    @property
    def lines(self) -> List[str]:
        return self.source.splitlines()


@dataclasses.dataclass
class Project:
    """Every module under analysis, keyed by repo-relative path."""

    root: str
    modules: Dict[str, Module]

    def module(self, path: str) -> Optional[Module]:
        return self.modules.get(path)

    def match(self, suffix: str) -> Optional[Module]:
        """The unique module whose path ends with ``suffix`` (for rules
        pinned to well-known files like ``serve/frontend.py``)."""
        hits = [m for p, m in self.modules.items() if p.endswith(suffix)]
        return hits[0] if len(hits) == 1 else None


def _rel(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    return rel.replace(os.sep, "/")


def load_project(paths: Sequence[str], root: str = ".") -> Project:
    """Parse every ``.py`` file under ``paths`` (files or directories).

    Files that fail to parse yield a synthetic NL000 finding instead of
    aborting the run — the driver attaches those via ``Project`` so the
    gate still fails loudly on a broken file.
    """
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".venv"))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    modules: Dict[str, Module] = {}
    for f in files:
        rel = _rel(f, root)
        with open(f, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            tree = ast.Module(body=[], type_ignores=[])
            mod = Module(path=rel, source=source, tree=tree, suppressions={})
            mod.parse_error = Finding(           # type: ignore[attr-defined]
                path=rel, line=e.lineno or 1, col=(e.offset or 1) - 1,
                rule="NL000", message=f"syntax error: {e.msg}",
                hint="nucleuslint cannot analyze this file until it parses")
            modules[rel] = mod
            continue
        modules[rel] = Module(
            path=rel, source=source, tree=tree,
            suppressions=parse_suppressions(source.splitlines()))
    return Project(root=os.path.abspath(root), modules=modules)


Rule = Callable[[Module, Project], List[Finding]]


def _rules() -> List[Tuple[str, Rule]]:
    # imported lazily so `findings`/`baseline` stay importable standalone
    from . import rules_concurrency, rules_recompile, rules_registry, \
        rules_trace
    return [
        ("NL1xx host syncs", rules_trace.check),
        ("NL2xx per-call builds", rules_recompile.check),
        ("NL3xx concurrency", rules_concurrency.check),
        ("NL4xx registry conformance", rules_registry.check),
    ]


def rule_catalog() -> List[Tuple[str, str]]:
    """(rule id, one-line description) for ``--list-rules``."""
    from . import rules_concurrency, rules_recompile, rules_registry, \
        rules_trace
    out: List[Tuple[str, str]] = []
    for mod in (rules_trace, rules_recompile, rules_concurrency,
                rules_registry):
        out.extend(mod.CATALOG)
    return sorted(out)


def run_analysis(project: Project,
                 only: Optional[Sequence[str]] = None) -> List[Finding]:
    """All non-suppressed findings over ``project``, sorted.

    ``only`` restricts to rule-id prefixes (e.g. ``["NL3"]``) for
    focused runs; suppressions always apply, the baseline is the
    caller's job (the CLI layers it so tests can see raw findings).
    """
    findings: List[Finding] = []
    for mod in project.modules.values():
        err = getattr(mod, "parse_error", None)
        if err is not None:
            findings.append(err)
            continue
        raw: List[Finding] = []
        for _family, rule in _rules():
            raw.extend(rule(mod, project))
        findings.extend(apply_suppressions(raw, mod.suppressions))
    if only:
        findings = [f for f in findings
                    if any(f.rule.startswith(p) for p in only)]
    return sorted(findings)
