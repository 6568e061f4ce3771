"""Shared AST machinery: tensor taint and the port's hot contexts (the
port's counterpart of ``repro.analysis.jaxast``).

The host-sync and per-call-build rules need two facts about a module:

  * **Which values are tensors.**  A forward taint per function: results
    of ``torch.*`` calls and of methods called on a tensor, and parameters
    annotated ``torch.Tensor`` (also inside ``Optional[...]`` and the
    like), flow through assignments, ``for`` targets, ``with ... as`` and
    comprehension targets.  ``.shape``, ``.ndim``, ``.dtype``, ``.device``
    and ``.numel()`` launder the taint: they are host metadata, no sync;
    so do ``is`` / ``is not`` tests, ``len()`` and ``isinstance()``.  The
    result of a sync (``int(t)``, ``t.item()``, ``t.tolist()``,
    ``t.numpy()``) is a host value: the sync is flagged where it is made,
    not again where its value is used.
    The taint is additive (a rebound name stays a tensor): its cost is a
    stray finding, silenced inline, never a missed sync.
  * **Which code is hot.**  A hot context runs many times per call, so a
    sync there is paid many times: the body (and test) of a ``for`` or
    ``while`` loop; a function passed to
    ``torch.utils.checkpoint.checkpoint`` (run again in the backward
    pass); ``forward``/``backward`` of a ``torch.autograd.Function``
    subclass; a ``with torch.cuda.graph(...)`` block (captured, so a host
    value read there is baked into the graph).  Discovery is name-based
    and module-local, as the reference's.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Union

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]
FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# attribute reads and methods that give host metadata, not tensor values
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                "layout", "requires_grad", "type", "index", "itemsize"}
STATIC_METHODS = {"numel", "dim", "size", "element_size", "stride",
                  "is_contiguous", "data_ptr", "get_device"}
TORCH_ROOTS = {"torch"}
# calls whose results are host values: the read itself is the sync (NL101
# flags it there), what it returns is no longer a tensor
HOST_BUILTINS = {"len", "isinstance", "int", "float", "bool", "str",
                 "repr", "type"}
HOST_METHODS = {"item", "tolist", "numpy"}
# torch functions whose results are host objects, not tensors
HOST_CALLS = {"device", "Size", "Generator", "is_available", "device_count",
              "current_device", "get_device_name", "is_grad_enabled",
              "no_grad", "enable_grad", "inference_mode", "get_default_dtype",
              "is_tensor", "finfo", "iinfo", "Event", "Stream",
              "current_stream", "synchronize", "empty_cache",
              "memory_allocated", "max_memory_allocated", "memory_reserved",
              "reset_peak_memory_stats", "set_num_threads",
              "get_num_threads", "manual_seed", "compile", "graph",
              "CUDAGraph", "is_floating_point", "promote_types",
              "result_type", "get_device_capability", "set_grad_enabled"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for the matching Attribute/Name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_torch_call(node: ast.AST) -> bool:
    """A call of ``torch.<anything>`` (``torch.zeros``,
    ``torch.nn.functional.silu``)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return bool(name) and "." in name and \
        name.split(".")[0] in TORCH_ROOTS and \
        name.split(".")[-1] not in HOST_CALLS


def _annotation_is_tensor(ann: Optional[ast.AST]) -> bool:
    """``torch.Tensor``, ``Tensor``, or ``Optional``/``Union`` of one (a
    container of tensors is not a tensor)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    name = dotted_name(ann)
    if name:
        return name.split(".")[-1] == "Tensor"
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _annotation_is_tensor(ann.left) or \
            _annotation_is_tensor(ann.right)
    if isinstance(ann, ast.Subscript):
        head = dotted_name(ann.value) or ""
        if head.split(".")[-1] in ("Optional", "Union"):
            args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
                else [ann.slice]
            return any(_annotation_is_tensor(a) for a in args)
    return False


def param_names(node: FuncNode) -> List[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def tensor_params(node: FuncNode) -> Set[str]:
    """Parameters annotated as tensors."""
    if isinstance(node, ast.Lambda):
        return set()
    a = node.args
    out = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
           if _annotation_is_tensor(p.annotation)}
    for p in (a.vararg, a.kwarg):
        if p is not None and _annotation_is_tensor(p.annotation):
            out.add(p.arg)
    return out


def own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """Every node under ``root`` without descending into nested functions
    or classes (those are scanned on their own)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, FUNC_NODES + (ast.ClassDef,)):
            continue
        stack.extend(ast.iter_child_nodes(n))


_BINDS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For,
          ast.comprehension, ast.withitem, ast.NamedExpr)


class TaintEnv:
    """Forward tensor taint over one function body (additive)."""

    def __init__(self, func: Optional[ast.AST], seed: Set[str] = frozenset(),
                 parent: Optional["TaintEnv"] = None):
        self.func = func
        self.tainted: Set[str] = set(seed)
        if parent is not None:
            self.tainted |= parent.tainted
        if isinstance(func, FUNC_NODES):
            self.tainted |= tensor_params(func)

    # -- expression query ----------------------------------------------
    def expr_tainted(self, node: ast.AST) -> bool:
        """Does ``node`` evaluate to (or read) a tensor value, modulo the
        laundering accessors?"""
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in STATIC_METHODS | HOST_METHODS:
                return False
            if isinstance(f, ast.Name) and f.id in HOST_BUILTINS:
                return False
            if is_torch_call(node):
                return True
            if isinstance(f, ast.Attribute) and self.expr_tainted(f.value):
                return True
            return any(self.expr_tainted(a) for a in node.args) or \
                any(self.expr_tainted(k.value) for k in node.keywords)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False                # identity: no value is read
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, FUNC_NODES):
            return False
        return any(self.expr_tainted(c) for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.expr_context, ast.keyword))) \
            or any(self.expr_tainted(k.value) for k in
                   getattr(node, "keywords", ()))

    # -- statement-level propagation -----------------------------------
    @staticmethod
    def _targets(target: ast.AST) -> Set[str]:
        return {sub.id for sub in ast.walk(target)
                if isinstance(sub, ast.Name)}

    def propagate(self) -> "TaintEnv":
        """Assignment propagation over the body to a fixpoint (bounded:
        the tainted set only grows)."""
        if self.func is None:
            return self
        binds = [n for n in own_nodes(self.func) if isinstance(n, _BINDS)]
        for _ in range(8):
            before = len(self.tainted)
            for node in binds:
                self._visit(node)
            if len(self.tainted) == before:
                break
        return self

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            if self.expr_tainted(node.value):
                for t in node.targets:
                    self.tainted |= self._targets(t)
        elif isinstance(node, ast.AugAssign):
            if self.expr_tainted(node.value) or \
                    self.expr_tainted(node.target):
                self.tainted |= self._targets(node.target)
        elif isinstance(node, ast.AnnAssign):
            if (node.value is not None and self.expr_tainted(node.value)) \
                    or _annotation_is_tensor(node.annotation):
                self.tainted |= self._targets(node.target)
        elif isinstance(node, (ast.For, ast.comprehension)):
            if self.expr_tainted(node.iter):
                self.tainted |= self._targets(node.target)
        elif isinstance(node, ast.withitem):
            if node.optional_vars is not None and \
                    self.expr_tainted(node.context_expr):
                self.tainted |= self._targets(node.optional_vars)
        elif isinstance(node, ast.NamedExpr):
            if self.expr_tainted(node.value):
                self.tainted |= self._targets(node.target)


# ---------------------------------------------------------------------------
# hot contexts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HotRegion:
    """Statements that run many times per call, with why."""

    nodes: List[ast.AST]        # the region's roots (loop, body stmts)
    reason: str                 # "for loop", "checkpoint body", ...
    twice: bool                 # a checkpoint body / autograd Function
    env: TaintEnv


def _is_checkpoint(name: Optional[str]) -> bool:
    if not name:
        return False
    parts = name.split(".")
    return parts[-1] == "checkpoint" and (len(parts) == 1 or
                                          parts[-2] == "checkpoint")


def _is_function_base(base: ast.AST) -> bool:
    name = dotted_name(base)
    return bool(name) and (name == "torch.autograd.Function" or
                           name.endswith("autograd.Function") or
                           name == "Function")


def _is_cuda_graph(expr: ast.AST) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func)
    return bool(name) and name.split(".")[-1] == "graph" and \
        "cuda" in name.split(".")


def _functions(tree: ast.Module):
    """(func node, enclosing function or None, enclosing class or None)."""
    def walk(node, owner, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FUNC_NODES):
                yield child, owner, cls
                yield from walk(child, child, None)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, owner, child)
            else:
                yield from walk(child, owner, cls)
    yield from walk(tree, None, None)


def hot_regions(tree: ast.Module) -> List[HotRegion]:
    """Every hot region of a module, each with the taint of the function
    it lies in (nested functions inherit their parent's); computed once
    per tree."""
    cached = getattr(tree, "_hot_regions", None)
    if cached is not None:
        return cached
    envs: Dict[int, TaintEnv] = {}
    checkpointed: Set[str] = set()
    checkpointed_nodes: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                _is_checkpoint(dotted_name(node.func)) and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                checkpointed_nodes.add(id(arg))
            else:
                name = dotted_name(arg)
                if name and "." not in name:
                    checkpointed.add(name)
    module_env = TaintEnv(None)
    regions: List[HotRegion] = []
    twice_funcs: List[tuple] = []
    funcs = list(_functions(tree))
    for func, owner, cls in funcs:
        parent = envs.get(id(owner)) if owner is not None else module_env
        name = getattr(func, "name", "<lambda>")
        function_body = cls is not None and \
            name in ("forward", "backward") and \
            any(_is_function_base(b) for b in cls.bases)
        twice = id(func) in checkpointed_nodes or name in checkpointed or \
            function_body
        seed = set()
        if twice:
            # every argument of a recomputed body or a Function is a tensor
            # (but ctx / self)
            seed = {p for p in param_names(func) if p not in ("ctx", "self")}
        env = TaintEnv(func, seed, parent).propagate()
        envs[id(func)] = env
        if twice:
            why = ("autograd Function " + name if function_body
                   else "checkpoint body")
            twice_funcs.append((func, why, env))
    for func, why, env in twice_funcs:
        regions.append(HotRegion(nodes=list(func.body) if not isinstance(
            func, ast.Lambda) else [func.body], reason=why, twice=True,
            env=env))
    twice_ids = {id(f) for f, _, _ in twice_funcs}
    # loops and graph captures, in the function (or module) they lie in
    scopes = [(tree, module_env)] + [(f, envs[id(f)]) for f, _, _ in funcs]
    for scope, env in scopes:
        if id(scope) in twice_ids:
            continue        # already hot as a whole, and twice
        for node in own_nodes(scope):
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                kind = "while loop" if isinstance(node, ast.While) \
                    else "for loop"
                roots = ([node.test] if isinstance(node, ast.While)
                         else []) + list(node.body)
                regions.append(HotRegion(nodes=roots, reason=kind,
                                         twice=False, env=env))
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_cuda_graph(i.context_expr) for i in node.items):
                regions.append(HotRegion(nodes=list(node.body),
                                         reason="torch.cuda.graph capture",
                                         twice=False, env=env))
    tree._hot_regions = regions         # both rule families ask
    return regions


def region_nodes(region: HotRegion) -> Iterator[ast.AST]:
    """Every node of a region, its roots included, without descending into
    nested functions or classes."""
    for root in region.nodes:
        yield root
        yield from own_nodes(root)
