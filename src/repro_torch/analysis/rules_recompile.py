"""NL2xx per-call builds: what is built once must not be built per call
(the port's counterpart of ``repro.analysis.rules_recompile``).

The port's warm paths (the kernel library loaded once, the ``Session``'s
pow2 buckets, the server's prewarm) are only warm if a second call finds
what the first one built:

  NL201  an extension load (``torch.utils.cpp_extension.load`` /
         ``load_inline``, ``ctypes.CDLL``), ``torch.compile`` or a
         ``torch.cuda.CUDAGraph()`` made inside a function body without
         memoization: a fresh build (an nvcc run, a compile, a capture)
         on every call.  ``functools.lru_cache`` / ``cache`` on the
         function is the sanctioned pattern (``kernels._build.library``);
         module level is fine.
  NL202  value-varying capture (``time.*()``, ``random.*``,
         ``np.random.*``, ``os.environ`` / ``os.getenv``,
         ``datetime.now``) in a warm-path key function (the ``key`` /
         ``bucket`` / ``canonical`` / ``plan``-named functions of
         ``core/session.py`` and ``serve/cache.py``), which would vary the
         cache key per call, or inside a ``torch.cuda.graph`` capture,
         whose replay bakes the value in.

The reference's NL203 (an unhashable literal bound to a jit
``static_argnames`` parameter) has no torch counterpart: torch has no
static arguments hashed into a compiled program's key.
"""
from __future__ import annotations

import ast
from typing import List, Set

from .driver import Module, Project
from .findings import Finding
from .torchast import (FUNC_NODES, dotted_name, hot_regions, own_nodes,
                       region_nodes)

CATALOG = [
    ("NL201", "extension load / torch.compile / CUDAGraph built inside a "
              "function body without memoization (a fresh build every "
              "call)"),
    ("NL202", "value-varying capture (time/random/os.environ) in a "
              "warm-path key function or a CUDA graph capture"),
]

_MEMO_DECORATORS = {"lru_cache", "cache", "cached_property"}
_BUILDS = {"cpp_extension.load", "cpp_extension.load_inline", "load_inline",
           "ctypes.CDLL", "CDLL", "torch.compile", "cuda.CUDAGraph",
           "CUDAGraph"}
_VARYING_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "os.getenv", "os.urandom", "uuid.uuid4", "id",
}
_VARYING_PREFIXES = ("random.", "np.random.", "numpy.random.",
                     "secrets.", "datetime.datetime.now",
                     "datetime.date.today")
_WARM_FILES = ("core/session.py", "serve/cache.py")
_KEY_NAME_PARTS = ("key", "bucket", "canonical", "plan")


def _is_memoized(func: ast.AST) -> bool:
    for dec in getattr(func, "decorator_list", []):
        name = dotted_name(dec if not isinstance(dec, ast.Call)
                           else dec.func)
        if name and name.split(".")[-1] in _MEMO_DECORATORS:
            return True
    return False


def _build_name(node: ast.Call) -> str:
    name = dotted_name(node.func) or ""
    for b in _BUILDS:
        if name == b or name.endswith("." + b):
            return name
    return ""


def _calls_in_functions(tree: ast.Module):
    """Yield (innermost enclosing function, call) for every call inside a
    function body (module-level calls are skipped)."""
    for func in ast.walk(tree):
        if isinstance(func, FUNC_NODES):
            for node in own_nodes(func):
                if isinstance(node, ast.Call):
                    yield func, node


def _varying_reason(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name:
            if name in _VARYING_CALLS:
                return f"{name}()"
            if any(name.startswith(p) for p in _VARYING_PREFIXES):
                return f"{name}()"
    name = dotted_name(node)
    if name and (name == "os.environ" or name.startswith("os.environ.")):
        return "os.environ"
    return ""


def check(module: Module, project: Project) -> List[Finding]:
    return _check_builds(module) + _check_varying(module)


def _check_builds(module: Module) -> List[Finding]:
    out: List[Finding] = []
    for owner, node in _calls_in_functions(module.tree):
        what = _build_name(node)
        if not what or _is_memoized(owner):
            continue
        fn_name = getattr(owner, "name", "<lambda>")
        out.append(Finding(
            path=module.path, line=node.lineno, col=node.col_offset,
            rule="NL201",
            message=f"{what}() inside {fn_name}() — built again on every "
                    f"call",
            hint="hoist it to module level, or memoize the function with "
                 "functools.lru_cache (see kernels._build.library)"))
    return out


def _check_varying(module: Module) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[int] = set()
    captures = hot_regions(module.tree) if "graph(" in module.source \
        else []
    for region in captures:
        if region.reason != "torch.cuda.graph capture":
            continue
        for node in region_nodes(region):
            reason = _varying_reason(node)
            if reason and id(node) not in seen:
                seen.add(id(node))
                out.append(Finding(
                    path=module.path, line=node.lineno,
                    col=node.col_offset, rule="NL202",
                    message=f"value-varying capture {reason} inside a "
                            f"torch.cuda.graph capture",
                    hint="a replay reuses the captured value; pass it in "
                         "a tensor the graph reads"))
    if module.path.endswith(_WARM_FILES):
        for func in ast.walk(module.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not any(p in func.name.lower() for p in _KEY_NAME_PARTS):
                continue
            for node in ast.walk(func):
                if id(node) in seen:
                    continue
                reason = _varying_reason(node)
                if reason:
                    seen.add(id(node))
                    out.append(Finding(
                        path=module.path, line=node.lineno,
                        col=node.col_offset, rule="NL202",
                        message=f"value-varying {reason} in warm-path "
                                f"key function {func.name}()",
                        hint="cache keys must depend only on shapes and "
                             "declared settings or the warm pool never "
                             "hits"))
    return out
