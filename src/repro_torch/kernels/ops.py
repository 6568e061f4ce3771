"""Public wrappers around the tricount kernel (counterpart of
``repro.kernels.ops``'s ``tricount`` and ``tricount_oriented``).

They cast the adjacency to contiguous float32, as the reference's
``astype(jnp.float32)`` does.  The reference pads n to its 128 tile inside
the kernel call and slices; the port's kernel masks the ragged edge, so the
result equals ``[:n, :n]`` of the reference's padded call for any n.
"""
from __future__ import annotations

import torch

from .tricount import tricount_oriented as _tricount_oriented
from .tricount import tricount_per_edge


def _f32(adj: torch.Tensor) -> torch.Tensor:
    return adj.to(torch.float32).contiguous()


def tricount(adj: torch.Tensor) -> torch.Tensor:
    """Per-edge triangle counts (A @ A) ⊙ A, any n."""
    return tricount_per_edge(_f32(adj))


def tricount_oriented(adj: torch.Tensor) -> torch.Tensor:
    """Per-DAG-edge 3-clique extension counts (D @ Dᵀ) ⊙ D, any n."""
    return _tricount_oriented(_f32(adj))
