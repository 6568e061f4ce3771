"""Hierarchy tree container (counterpart of ``repro.core.hierarchy``).

Node ids 0..n_r-1 are leaves (one per r-clique); internal nodes are
appended.  ``parent[i] == -1`` marks roots; ``level[i]`` is the merge level
(for leaves: the clique's core number).  Host numpy code, as in the
reference; the two-phase builders are not ported in this slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HierarchyTree:
    n_leaves: int
    parent: np.ndarray  # (n_nodes,) int64, -1 for roots
    level: np.ndarray   # (n_nodes,) int64

    @property
    def n_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves

    def ancestor_at_level(self, c: int) -> np.ndarray:
        """For each leaf: highest ancestor with level >= c (-1 if core < c).

        The "cut the hierarchy" query behind Fig. 10: the returned node ids
        label the c-(r,s) nuclei.
        """
        node = np.arange(self.n_leaves, dtype=np.int64)
        cur = np.where(self.level[: self.n_leaves] >= c, node, -1)
        while True:
            valid = cur >= 0
            p = np.where(valid, self.parent[np.maximum(cur, 0)], -1)
            ok = (p >= 0) & (self.level[np.maximum(p, 0)] >= c) & valid
            if not ok.any():
                return cur
            cur = np.where(ok, p, cur)
