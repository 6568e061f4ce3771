"""``--dead``: modules unreachable from the port's product surface (the
port's counterpart of ``repro.analysis.deadmod``).

Reachability is an import-graph BFS over ``src/repro_torch``:

  * **Roots** — every module under ``repro_torch.core``,
    ``repro_torch.serve``, ``repro_torch.launch`` and
    ``repro_torch.tools``, plus every ``repro_torch.*`` module imported
    (textually, via AST) by ``tests/test_torch_*.py`` and
    ``chip_smoke.py``.
  * **Edges** — ``import x`` / ``from x import y`` statements, with
    relative imports resolved against the importing module's package;
    ``from pkg import name`` also targets ``pkg.name`` when that is a
    module (the lazy-import idiom inside function bodies counts — the
    walk covers the whole AST, not just top level).
  * **Dead** — modules never reached.  Packages whose every module is
    dead are summarized as ``pkg/*``.

The report also carries the ``nucleus_unreachable`` view, modules
unreachable from ``repro_torch.core`` + ``repro_torch.serve`` alone (the
LM, GNN and recsys substrate).  It never deletes anything.  The record
has the reference's keys.
"""
from __future__ import annotations

import ast
import os
import glob
from typing import Dict, List, Optional, Sequence, Set

TOP = "repro_torch"


def _discover(src_root: str) -> Dict[str, str]:
    """dotted module name -> file path for every .py under src_root
    (src_root is the directory CONTAINING the ``repro_torch``
    package)."""
    out: Dict[str, str] = {}
    pkg_root = os.path.join(src_root, TOP)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, src_root)
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out[".".join(parts)] = path
    return out


def _imports_of(path: str, module: str) -> Set[str]:
    """Dotted names this file imports (absolute, ``repro_torch.*``
    only)."""
    with open(path, encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            return set()
    pkg_parts = module.split(".")
    is_pkg = os.path.basename(path) == "__init__.py"
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative: `from ..core import engine` in a serve module
                # resolves against the containing package
                base_parts = pkg_parts if is_pkg else pkg_parts[:-1]
                cut = node.level - 1
                base = base_parts[:len(base_parts) - cut] if cut else \
                    base_parts
                prefix = ".".join(base)
                stem = f"{prefix}.{node.module}" if node.module else prefix
            else:
                stem = node.module or ""
            if stem:
                out.add(stem)
                for alias in node.names:
                    out.add(f"{stem}.{alias.name}")
    return {n for n in out if n == TOP or n.startswith(TOP + ".")}


def _external_roots(files: Sequence[str]) -> Set[str]:
    """``repro_torch.*`` modules imported by ``files`` (the port's tests
    and ``chip_smoke.py``: anything there keeps its imports alive)."""
    out: Set[str] = set()
    for path in files:
        if os.path.isfile(path):
            out |= _imports_of(path, "external")
    return out


ROOT_PACKAGES = ("repro_torch.core", "repro_torch.serve",
                 "repro_torch.launch", "repro_torch.tools")
NUCLEUS_PACKAGES = ("repro_torch.core", "repro_torch.serve")


def default_root_files(src_root: str = "src") -> List[str]:
    """``tests/test_torch_*.py`` and ``chip_smoke.py`` beside
    ``src_root``."""
    top = os.path.dirname(os.path.abspath(src_root))
    return sorted(glob.glob(os.path.join(top, "tests", "test_torch_*.py"))) \
        + [os.path.join(top, "chip_smoke.py")]


def dead_module_report(src_root: str = "src",
                       extra_root_files: Optional[Sequence[str]] = None,
                       ) -> Dict[str, object]:
    """The dead-module inventory (JSON-ready; see module docstring)."""
    modules = _discover(src_root)
    imports = {m: _imports_of(p, m) for m, p in modules.items()}

    def resolve(name: str) -> List[str]:
        """Importing ``a.b.c`` reaches a.b.c AND executes a, a.b."""
        hits = []
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            if prefix in modules:
                hits.append(prefix)
        return hits

    def bfs(roots: Set[str]) -> Set[str]:
        reachable: Set[str] = set()
        frontier = sorted(roots)
        while frontier:
            m = frontier.pop()
            if m in reachable:
                continue
            reachable.add(m)
            for name in imports.get(m, ()):
                for hit in resolve(name):
                    if hit not in reachable:
                        frontier.append(hit)
        return reachable

    def pkg_roots(prefixes: Sequence[str]) -> Set[str]:
        return {m for m in modules
                if m in prefixes or any(m.startswith(r + ".")
                                        for r in prefixes)}

    def summarize(dead: List[str], reachable: Set[str]) -> List[str]:
        # collapse fully-dead packages for the human summary
        by_pkg: Dict[str, List[str]] = {}
        for m in dead:
            pkg = m.rsplit(".", 1)[0] if "." in m else m
            by_pkg.setdefault(pkg, []).append(m)
        summary: List[str] = []
        for pkg, members in sorted(by_pkg.items()):
            live_in_pkg = any(x == pkg or x.startswith(pkg + ".")
                              for x in reachable)
            if not live_in_pkg and len(members) > 1:
                summary.append(f"{pkg}.* ({len(members)} modules)")
            else:
                summary.extend(members)
        return summary

    roots = pkg_roots(ROOT_PACKAGES)
    if extra_root_files is None:
        extra_root_files = default_root_files(src_root)
    for name in _external_roots(extra_root_files):
        roots.update(resolve(name))
    reachable = bfs(roots)
    dead = sorted(m for m in modules if m not in reachable)

    nucleus_reachable = bfs(pkg_roots(NUCLEUS_PACKAGES))
    nucleus_dead = sorted(m for m in modules if m not in nucleus_reachable)

    return {
        "src_root": src_root,
        "roots": sorted(roots),
        "n_modules": len(modules),
        "n_reachable": len(reachable),
        "dead": dead,
        "dead_summary": summarize(dead, reachable),
        "dead_paths": [os.path.relpath(modules[m]).replace(os.sep, "/")
                       for m in dead],
        "nucleus_unreachable": nucleus_dead,
        "nucleus_unreachable_summary": summarize(nucleus_dead,
                                                 nucleus_reachable),
    }
