"""Nested containers of tensors, walked as ``jax.tree`` walks them.

The port's parameters, gradients and optimizer state are dicts, tuples,
lists and NamedTuples of tensors (the reference's pytrees).  Every function
here visits the leaves in ``jax.tree``'s order: dict keys sorted, sequence
items and NamedTuple fields in order, ``None`` an empty subtree.
``params_from_reference`` carries the reference's parameters across.
``flatten_with_paths`` names each leaf by its ``jax.tree_util`` key path
joined by ``/`` (``"[0]/['layers']/['wq']"``, ``"[1]/.step"``), the keys
of a checkpoint's ``arrays.npz``; with ``plain=True``, by its keys, indices
and field names alone (``"0/layers/wq"``, ``"1/step"``), the paths the
sharding rules match.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any, plain: bool = False
              ) -> Iterator[Tuple[str, Any]]:
    """(path element, child) of an inner node in jax's order; nothing for
    a leaf or None (callers tell those apart).  The element is jax's
    (``['wq']``, ``.step``, ``[0]``), or with ``plain`` the bare key,
    field name or index."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield (str(k) if plain else f"[{k!r}]"), node[k]
    elif _is_namedtuple(node):
        for name, v in zip(node._fields, node):
            yield (name if plain else f".{name}"), v
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield (str(i) if plain else f"[{i}]"), v


def _is_inner(node: Any) -> bool:
    return isinstance(node, (dict, tuple, list))


def flatten_with_paths(tree: Any, plain: bool = False
                       ) -> List[Tuple[str, Any]]:
    """(key path, leaf) of every leaf, in jax's leaf order; ``plain``
    paths join the bare keys (``layers/wq``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if not _is_inner(node):
            out.append(("/".join(path), node))
            return
        for part, child in _children(node, plain):
            walk(child, path + (part,))
    walk(tree, ())
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves in jax's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def leaves_like(tree: Any, like: Any) -> List[Any]:
    """``tree``'s subtrees at the positions of ``like``'s leaves, in order:
    a payload whose leaves are tuples, or a tree holding ``None`` where
    ``like`` has a tensor, cut down to ``like``'s structure."""
    out: List[Any] = []

    def walk(node, ref):
        if ref is None:
            return
        if not _is_inner(ref):
            out.append(node)
            return
        kids = dict(_children(node))
        for part, child in _children(ref):
            walk(kids[part], child)
    walk(tree, like)
    return out


def unflatten(like: Any, values: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)

    def build(ref):
        if ref is None:
            return None
        if not _is_inner(ref):
            return next(it)
        built = {part: build(child) for part, child in _children(ref)}
        if isinstance(ref, dict):
            return {k: built[f"[{k!r}]"] for k in ref}
        kids = list(built.values())
        if _is_namedtuple(ref):
            return type(ref)(*kids)
        return type(ref)(kids)
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("unflatten: more values than leaves")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree``'s structure with ``fn`` of each leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


_NP_TO_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def params_from_reference(np_tree: Any, device: DeviceLike = None) -> Any:
    """The reference's parameters (nested dicts and lists of numpy arrays,
    e.g. from ``jax.device_get``) as the port's, leaf for leaf and in the
    same structure; a 0-d leaf stays 0-d.

    bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
    take) go through float32, which holds every bf16 value exactly.
    """
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name not in _NP_TO_TORCH:
            raise TypeError(f"unsupported parameter dtype {a.dtype}")
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=_NP_TO_TORCH[a.dtype.name])

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return conv(node)

    return build(np_tree)
