"""Batched union-find on top of min-hooking connectivity.

Counterpart of ``repro.graph.unionfind``: state is a plain (n,) parent
tensor and the root of every set is its minimum member id, so parallel
runs and the sequential oracle agree on representatives.  The functional
API (``uf_create`` / ``uf_find_all`` / ``uf_union_edges``) returns a new
tensor from every op; ``BatchedUnionFind`` wraps it for eager callers.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike, resolve_device
from .connectivity import connected_components, pointer_jump
from .container import INT


def uf_create(n: int, device: DeviceLike = None) -> torch.Tensor:
    """Fresh parent array: every element its own root."""
    return torch.arange(n, dtype=INT, device=resolve_device(device))


def uf_find_all(parent: torch.Tensor) -> torch.Tensor:
    """Fully resolved parent array (parent[parent] == parent)."""
    return pointer_jump(parent)


def uf_union_edges(parent: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Unite endpoints of all edges at once; returns resolved parents.

    Self-edges are no-ops.
    """
    return connected_components(int(parent.shape[0]), u, v, init=parent)


@dataclasses.dataclass
class BatchedUnionFind:
    parent: torch.Tensor  # (n,) int32, parent[i] <= i invariant after resolve

    @classmethod
    def create(cls, n: int, device: DeviceLike = None) -> "BatchedUnionFind":
        return cls(parent=uf_create(n, device))

    def find_all(self) -> torch.Tensor:
        self.parent = uf_find_all(self.parent)
        return self.parent

    def union_edges(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Unite endpoints of all edges at once; returns resolved labels."""
        self.parent = uf_union_edges(self.parent, u, v)
        return self.parent
