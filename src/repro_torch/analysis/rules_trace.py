"""NL1xx host syncs: no device-to-host reads in hot code (the port's
counterpart of ``repro.analysis.rules_trace``).

A CUDA launch returns before the device finishes; reading a tensor's value
on the host waits for every queued launch and copies it back.  Once per
call that is cheap; once per round of a loop it bounds the loop by the
host.  Inside a hot context (``torchast``: a loop body, a checkpoint body,
an autograd ``Function``, a CUDA graph capture) a tensor value
(``torchast``'s taint) must not flow into the host:

  NL101  host-sync call: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
         ``.numpy()``, or ``int()`` / ``float()`` / ``bool()``, on a
         tensor; or ``torch.nonzero`` / ``.nonzero()`` / ``torch.unique``
         / ``.unique()`` / ``torch.equal``, whose output size (or answer)
         the host must read.
  NL102  Python ``if`` / ``while`` / ``assert`` / ternary testing a tensor:
         an implicit ``bool()`` sync.
  NL103  any NL101/NL102 sync inside a checkpoint body or an autograd
         ``Function``, which runs twice (the recompute, the backward), so
         it syncs twice.

``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` / ``.numel()`` launder
the taint: they are host metadata.  A sync a loop needs (the engine's one
read a round, which also ends the loop) carries an inline suppression
with its reason; the rest are the baseline, the inventory later speed
work starts from.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .driver import Module, Project
from .findings import Finding
from .torchast import TaintEnv, dotted_name, hot_regions, region_nodes

CATALOG = [
    ("NL101", "host-sync call (.item/.tolist/.cpu/.numpy, int/float/bool "
              "of a tensor, nonzero/unique/equal) inside a loop or a CUDA "
              "graph capture"),
    ("NL102", "Python if/while/assert/ternary on a tensor (implicit "
              "bool() sync) inside a loop or a CUDA graph capture"),
    ("NL103", "host sync inside a checkpoint body or an autograd Function "
              "(runs twice)"),
]

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SIZE_METHODS = {"nonzero", "unique"}
_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_TORCH = {"nonzero", "unique", "equal"}


def _sync_call(env: TaintEnv, node: ast.Call) -> Optional[str]:
    """What makes ``node`` a host sync, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and \
            fn.attr in _SYNC_METHODS | _SIZE_METHODS and \
            env.expr_tainted(fn.value):
        return f".{fn.attr}() on a tensor"
    name = dotted_name(fn)
    if name in _SYNC_BUILTINS and node.args and \
            env.expr_tainted(node.args[0]):
        return f"{name}() of a tensor"
    if name and name.startswith("torch.") and \
            name.split(".")[-1] in _SYNC_TORCH:
        return f"{name}()"
    return None


def check(module: Module, project: Project) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[int, int, str]] = set()
    # regions twice-hot first: a sync there is NL103 however nested
    for region in sorted(hot_regions(module.tree), key=lambda r: not
                         r.twice):
        env = region.env
        where = f"in a {region.reason}"
        for node in region_nodes(region):
            f = None
            if isinstance(node, ast.Call):
                what = _sync_call(env, node)
                if what:
                    f = (node, "NL101", f"{what} {where}",
                         "a device-to-host read per iteration; keep the "
                         "value on the device or read it once outside")
            elif isinstance(node, (ast.If, ast.While, ast.Assert,
                                   ast.IfExp)) and \
                    env.expr_tainted(node.test):
                kind = {"If": "if", "While": "while", "Assert": "assert",
                        "IfExp": "ternary"}[type(node).__name__]
                f = (node.test, "NL102", f"Python {kind} on a tensor "
                     f"{where}", "an implicit bool() sync; use torch.where "
                     "or keep the decision on the device")
            if f is None:
                continue
            site, rule, message, hint = f
            if region.twice:
                rule = "NL103"
                hint = "the body runs twice (recompute / backward), so " \
                       "the sync does too; " + hint
            key = (site.lineno, site.col_offset, rule[:4])
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                path=module.path, line=site.lineno, col=site.col_offset,
                rule=rule, message=message, hint=hint))
    return findings
