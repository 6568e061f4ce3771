"""Public wrappers around the tricount and flash-attention kernels
(counterpart of ``repro.kernels.ops``'s ``tricount``, ``tricount_oriented``
and ``attention``).

The tricount wrappers cast the adjacency to contiguous float32, as the
reference's ``astype(jnp.float32)`` does.  The reference pads n to its 128
tile inside the kernel call and slices, and ``attention`` pads the sequence
to its blocks; the port's kernels mask the ragged edge themselves, so the
results equal the reference's padded calls sliced back, for any n or S.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """Flash attention, q (B, H, Sq, D), k/v (B, Hkv, Sk, D) -> (B, H, Sq, D).

    The reference pads Sq and Sk to its blocks and can mask padded keys
    only through the causal horizon, so it refuses non-causal keys that
    would need padding; this wrapper keeps that rule (``ValueError``) and
    it is the only use of ``block_q``/``block_k``: the kernel picks its own
    tiles and masks the ragged edge.  With causal, Sq > Sk and ragged keys,
    the reference lets queries past Sk see its zero pad keys; the kernel
    masks every key at or past Sk, as ``ref.attention_ref`` does.
    """
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"blocks must be positive, got {block_q}, "
                         f"{block_k}")
    if not causal and k.shape[2] % block_k:
        raise ValueError("non-causal padded attention: pre-pad keys "
                         "yourself")
    return flash_attention(q, k, v, causal=causal)
