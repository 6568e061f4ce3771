"""Batched union-find on top of min-hooking connectivity.

Counterpart of ``repro.graph.unionfind``: state is a plain (n,) parent
tensor and the root of every set is its minimum member id.
"""
from __future__ import annotations

import torch

from .connectivity import connected_components


def uf_union_edges(parent: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Unite endpoints of all edges at once; returns resolved parents.

    Self-edges are no-ops.
    """
    return connected_components(int(parent.shape[0]), u, v, init=parent)
