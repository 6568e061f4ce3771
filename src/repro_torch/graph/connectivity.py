"""Connected components via min-hooking + pointer jumping.

Counterpart of ``repro.graph.connectivity``.  The reference runs both loops
as ``lax.while_loop``s; here they are host-driven, one ``.item()`` sync per
iteration, which removing is ROADMAP Queue 1.8.  Labels are the minimum
vertex id of each component, so results equal the reference exactly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .container import INT


def pointer_jump(labels: torch.Tensor) -> torch.Tensor:
    """Resolve a label forest to roots: labels <- labels[labels] to fixpoint.

    Pointer doubling halves path lengths each step, so the reference's cap
    of n + 1 steps is never reached."""
    n = int(labels.shape[0])
    if n == 0:
        return labels
    i = 0
    while i < n + 1:
        nxt = labels[labels.long()]
        changed = bool((nxt != labels).any())
        labels = nxt
        i += 1
        if not changed:
            break
    return labels


def connected_components(n: int, u: torch.Tensor, v: torch.Tensor,
                         init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Component labels (min vertex id reachable) for graph (n, edges u-v).

    `init` seeds labels (an existing union-find forest, resolved or not);
    self-edges are no-ops.  Returned labels are fully resolved.
    """
    dev = u.device
    labels = (torch.arange(n, dtype=INT, device=dev) if init is None
              else pointer_jump(init.to(INT)))
    if int(u.shape[0]) == 0 or n == 0:
        return labels
    u, v = u.long(), v.long()
    while True:
        lu, lv = labels[u], labels[v]
        m = torch.minimum(lu, lv)
        # hook at the ROOTS (lu, lv), as the reference does, so components
        # seeded through `init` whose members are not endpoints stay whole
        hooked = labels.scatter_reduce(0, lu.long(), m, "amin",
                                       include_self=True)
        hooked = hooked.scatter_reduce(0, lv.long(), m, "amin",
                                       include_self=True)
        new = pointer_jump(hooked)
        if not bool((new != labels).any()):
            return new
        labels = new
