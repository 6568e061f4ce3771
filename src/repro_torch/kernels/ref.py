"""Plain-torch oracles of the port's kernels (counterpart of
``repro.kernels.ref``).

Same contracts as the reference's ``peel_round_ref``/``segment_sum_ref``/
``tricount_*_ref``/``attention_ref``, so the tests feed both the same numpy
inputs and demand equal outputs (allclose for attention).  The kernel
wrappers in ``peel_round.py``/``segment_sum.py``/``tricount.py``/
``flash_attention.py`` run these on CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernels against them.
"""
from __future__ import annotations

import math

import torch

INT = torch.int32


def tricount_per_edge_ref(adj: torch.Tensor) -> torch.Tensor:
    """(A @ A) ⊙ A: per-pair common-neighbor counts on the edges."""
    return (adj @ adj) * adj


def triangle_count_ref(adj: torch.Tensor) -> torch.Tensor:
    return torch.sum(tricount_per_edge_ref(adj)) / 6.0


def tricount_oriented_ref(adj: torch.Tensor) -> torch.Tensor:
    """(D @ Dᵀ) ⊙ D: per-DAG-edge common-out-neighbor counts."""
    return (adj @ adj.T) * adj


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Materialized-softmax attention. q/k/v: (B, H, S, D).

    Scores in float32, a ``-inf`` causal mask by index (key index <= query
    index, also when Sq != Sk), softmax, then the cast to ``q.dtype``.
    """
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :] <=
                torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def segment_sum_ref(data: torch.Tensor, ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    """out[n] = sum of data[k] over k with ids[k] == n.

    Like ``jax.ops.segment_sum``, rows whose id is outside
    [0, n_segments) are dropped.
    """
    out = torch.zeros((n_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    valid = (ids >= 0) & (ids < n_segments)
    out.index_add_(0, ids[valid].long(), data[valid])
    return out


def peel_round_ref(ids: torch.Tensor, members: torch.Tensor,
                   deg: torch.Tensor, peeled: torch.Tensor, core: torch.Tensor,
                   order: torch.Tensor, level: int, rnd: int):
    """One peel round over the per-edge CSR plan.

    ids (E_pad,) with pad id = n_r_pad, members (E_pad, C) with pad member
    = -1 (read as already peeled), deg/peeled/core/order (n_r_pad,) int32
    (peeled 0/1).  Returns the post-round (deg, peeled, core, order).
    """
    n_r_pad = deg.shape[0]
    memc = torch.clamp(members, 0, max(n_r_pad - 1, 0)).long()
    was = (peeled[memc] > 0) | (members < 0)
    gone = was | (deg[memc] <= level)
    dead = (~was.any(dim=1)) & gone.any(dim=1)
    # pad edges carry id = n_r_pad: give the scatter one spill row
    delta = torch.zeros((n_r_pad + 1,), dtype=INT, device=deg.device)
    delta.index_add_(0, ids.long(), dead.to(INT))
    delta = delta[:n_r_pad]
    a = (peeled == 0) & (deg <= level)
    newp = (peeled > 0) | a
    deg = torch.where(newp, deg, deg - delta)
    lv = torch.full_like(core, level)
    rv = torch.full_like(order, rnd)
    return (deg, newp.to(INT), torch.where(a, lv, core),
            torch.where(a, rv, order))
