"""NL4xx registry conformance: backends only touch declared knobs (the
port's counterpart of ``repro.analysis.rules_registry``).

``NucleusConfig.validate()`` derives the whole config x backend legality
matrix from each backend's ``BackendCapabilities.knobs`` declaration
(``core/backends.py``): the declaration is load-bearing, so it must be
TRUE.
This rule makes it verifiable instead of trusted:

  NL401  a registered backend's ``run`` adapter (or a module-local
         helper it forwards ``config`` to) reads a knob the
         declaration does not claim.  Knob evidence is an attribute
         read on the config parameter, by the port's config names:
         ``config.use_kernel`` -> ``pallas`` (the knob keeps the
         reference's name), ``config.mesh`` -> ``mesh``,
         ``config.compress`` -> ``compress``.  Reading an *undeclared* knob means the
         derived error messages lie ("backend X never runs it" while
         X's AST dispatches on it) and the planner's knob-binding rules
         route around a capability that actually exists.

The analysis is module-local and one-level transitive: it parses every
``register(_Registered(name=..., capabilities=BackendCapabilities(...,
knobs=frozenset({...})), _run=<adapter>))`` call, then scans the adapter
plus any same-module function the adapter calls with the config argument
(the ``_run_local`` pattern).  Over-declaring (a declared knob the AST
never reads) is NOT flagged — capabilities may legitimately precede the
wiring within a PR stack.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .driver import Module, Project
from .findings import Finding
from .torchast import dotted_name

CATALOG = [
    ("NL401", "registered Backend adapter reads a config knob its "
              "BackendCapabilities declaration does not claim"),
]

# config attribute -> declared knob name
KNOB_ATTRS = {"use_kernel": "pallas", "mesh": "mesh", "compress": "compress"}


def _knob_strings(node: ast.AST) -> Set[str]:
    """String constants anywhere under a knobs=... expression
    (handles ``frozenset({"a", "b"})``, ``frozenset()``, bare sets)."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.add(sub.value)
    return out


def _registered_backends(tree: ast.Module
                         ) -> List[Tuple[str, Set[str], str, ast.Call]]:
    """(backend name, declared knobs, adapter function name, call site)
    for each ``register(...)`` in the module."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func)
        if not callee or callee.split(".")[-1] != "register":
            continue
        if not node.args or not isinstance(node.args[0], ast.Call):
            continue
        entry = node.args[0]
        name = adapter = None
        knobs: Set[str] = set()
        for kw in entry.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = kw.value.value
            elif kw.arg == "_run":
                adapter = dotted_name(kw.value)
            elif kw.arg == "capabilities" \
                    and isinstance(kw.value, ast.Call):
                for ckw in kw.value.keywords:
                    if ckw.arg == "knobs":
                        knobs = _knob_strings(ckw.value)
        if name and adapter and "." not in adapter:
            out.append((name, knobs, adapter, node))
    return out


def _config_param(func: ast.AST) -> Optional[str]:
    """The name of the config-carrying parameter (by convention the one
    named ``config`` / ``cfg``)."""
    args = func.args
    for p in args.posonlyargs + args.args + args.kwonlyargs:
        if p.arg in ("config", "cfg"):
            return p.arg
    return None


def _knob_reads(func: ast.AST, param: str
                ) -> List[Tuple[str, ast.Attribute]]:
    out = []
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == param and node.attr in KNOB_ATTRS:
            out.append((KNOB_ATTRS[node.attr], node))
    return out


def _forwarded_helpers(func: ast.AST, param: str,
                       defs: Dict[str, ast.AST]) -> List[ast.AST]:
    """Same-module functions ``func`` calls with the config argument."""
    out = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func)
        if not callee or "." in callee or callee not in defs:
            continue
        passes_config = any(
            isinstance(a, ast.Name) and a.id == param for a in node.args
        ) or any(
            isinstance(kw.value, ast.Name) and kw.value.id == param
            for kw in node.keywords)
        if passes_config:
            out.append(defs[callee])
    return out


def check(module: Module, project: Project) -> List[Finding]:
    backends = _registered_backends(module.tree)
    if not backends:
        return []
    defs: Dict[str, ast.AST] = {
        n.name: n for n in module.tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    findings: List[Finding] = []
    for name, knobs, adapter, _site in backends:
        func = defs.get(adapter)
        if func is None:
            continue
        param = _config_param(func)
        if param is None:
            continue
        scan: List[Tuple[ast.AST, str]] = [(func, param)]
        for helper in _forwarded_helpers(func, param, defs):
            hp = _config_param(helper)
            if hp is not None:
                scan.append((helper, hp))
        for target, p in scan:
            for knob, site in _knob_reads(target, p):
                if knob in knobs:
                    continue
                where = getattr(target, "name", adapter)
                findings.append(Finding(
                    path=module.path, line=site.lineno,
                    col=site.col_offset, rule="NL401",
                    message=f"backend {name!r} reads config knob "
                            f"{site.attr!r} in {where}() but its "
                            f"BackendCapabilities declares "
                            f"knobs={sorted(knobs)}",
                    hint="add the knob to the declaration (legality is "
                         "derived from it) or stop dispatching on it — "
                         "the matrix must match the AST"))
    return findings
