"""NL3xx concurrency: the lock convention + single-writer engine (the
port's counterpart of ``repro.analysis.rules_concurrency``, unchanged in
substance: the port's server keeps the reference's design).

The threaded server's safety argument has two legs, and each leg is a
checkable AST property:

  NL301  lock-convention violation.  The convention is seeded per class:
         any ``self.<attr>`` a class EVER mutates inside a
         ``with self.<...lock...>:`` block (direct assignment, augmented
         assignment, subscript store, or a mutating method call like
         ``.pop`` / ``.append``) is a *guarded attribute* — e.g.
         ``Frontend.stats`` via ``_count``, the Router pool tables.
         Every other mutation of a guarded attribute must also hold the
         lock; ``__init__`` is exempt (no concurrent readers exist
         before construction completes).
  NL302  single-writer violation.  ``serve/frontend.py``'s correctness
         claim is that exactly one thread drives the engine: calls that
         enter it (``route_many`` / ``router.update`` /
         ``decompose``\\*) may appear only in the worker methods
         ``_run`` / ``_serve_batch``.  ``submit()`` may resolve, pool
         and bucket (lock-guarded reads) but never run a decomposition.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .driver import Module, Project
from .findings import Finding
from .torchast import dotted_name

CATALOG = [
    ("NL301", "write to a lock-guarded attribute outside `with "
              "self.<lock>` (the _count convention)"),
    ("NL302", "engine-entry call outside the frontend worker thread "
              "(single-writer invariant)"),
]

_MUTATORS = {"append", "extend", "pop", "popitem", "clear", "update",
             "setdefault", "add", "remove", "discard", "insert",
             "appendleft", "__setitem__"}
_ENGINE_ENTRIES = {"route_many", "update", "decompose", "decompose_many"}
_WORKER_METHODS = {"_run", "_serve_batch"}


def _is_lock_name(attr: str) -> bool:
    return "lock" in attr.lower()


def _self_attr_mutations(node: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(attr name, site) for every mutation of ``self.<attr>`` performed
    by ``node`` itself (not a full walk)."""
    out: List[Tuple[str, ast.AST]] = []

    def self_attr(target: ast.AST) -> Optional[str]:
        # self.x  |  self.x[...]  (store through subscript)
        if isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            return target.attr
        return None

    if isinstance(node, ast.Assign):
        for t in node.targets:
            attr = self_attr(t)
            if attr:
                out.append((attr, node))
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        attr = self_attr(node.target)
        if attr:
            out.append((attr, node))
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            attr = self_attr(t)
            if attr:
                out.append((attr, node))
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        attr = self_attr(node.func.value)
        if attr:
            out.append((attr, node))
    return out


def _with_holds_self_lock(node: ast.With) -> bool:
    for item in node.items:
        name = dotted_name(item.context_expr)
        if name and name.startswith("self.") \
                and _is_lock_name(name.split(".")[-1]):
            return True
    return False


def _scan_class(cls: ast.ClassDef
                ) -> List[Tuple[str, str, ast.AST, bool]]:
    """(method, attr, site, under_lock) for every self-attr mutation in
    ``cls``, with lock context tracked lexically."""
    sites: List[Tuple[str, str, ast.AST, bool]] = []

    def walk(node: ast.AST, method: str, locked: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_method, child_locked = method, locked
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_method, child_locked = child.name, False
            elif isinstance(child, ast.With) \
                    and _with_holds_self_lock(child):
                child_locked = True
            for attr, site in _self_attr_mutations(child):
                sites.append((child_method, attr, site, child_locked))
            walk(child, child_method, child_locked)

    walk(cls, "<class body>", False)
    return sites


def check(module: Module, project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_check_class(module, node))
    if module.path.endswith("serve/frontend.py"):
        findings.extend(_check_single_writer(module))
    return findings


def _check_class(module: Module, cls: ast.ClassDef) -> List[Finding]:
    sites = _scan_class(cls)
    guarded: Set[str] = {attr for _m, attr, _s, locked in sites if locked}
    if not guarded:
        return []
    out: List[Finding] = []
    for method, attr, site, locked in sites:
        if locked or attr not in guarded or method == "__init__":
            continue
        if _is_lock_name(attr):
            continue
        out.append(Finding(
            path=module.path, line=site.lineno, col=site.col_offset,
            rule="NL301",
            message=f"{cls.name}.{attr} mutated in {method}() without "
                    f"holding the lock that guards it elsewhere",
            hint="this attribute is written under `with self.<lock>` in "
                 "another method — wrap this write too (the _count "
                 "convention), or move it to __init__"))
    return out


def _check_single_writer(module: Module) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name in _WORKER_METHODS:
                continue
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if not name:
                    continue
                parts = name.split(".")
                if parts[-1] not in _ENGINE_ENTRIES:
                    continue
                # only receiver chains through the router / a session —
                # `job.future.update(...)`-style lookalikes stay clean
                if not any(p in ("router", "sess", "session")
                           for p in parts[:-1]):
                    continue
                out.append(Finding(
                    path=module.path, line=node.lineno,
                    col=node.col_offset, rule="NL302",
                    message=f"engine entry {name}() called from "
                            f"{cls.name}.{method.name}() — only the "
                            f"worker ({'/'.join(sorted(_WORKER_METHODS))}"
                            f") may drive the engine",
                    hint="route the work through the queue; the "
                         "single-writer invariant is what makes the "
                         "engine lock-free"))
    return out
