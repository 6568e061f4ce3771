"""Plain-torch oracles of the port's kernels (counterpart of
``repro.kernels.ref``).

Same contracts as the reference's ``peel_round_ref``/``segment_sum_ref``, so
the tests feed both the same numpy inputs and demand equal outputs.  The
kernel wrappers in ``peel_round.py``/``segment_sum.py`` run these on CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernels against them.
"""
from __future__ import annotations

import torch

INT = torch.int32


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
