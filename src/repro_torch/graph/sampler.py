"""GraphSAGE-style fanout neighbor sampler (minibatch_lg shape); the
counterpart of ``repro.graph.sampler``, block for block the reference's: the
CSR is sorted on the graph's device, the draws are host numpy.

Uniform sampling with replacement from CSR neighbor lists, layer by layer,
returning the union subgraph padded to static worst-case shapes.  The
random draws are the reference's calls in its order, so a seed gives the
same block; the relabelling to local ids is a ``np.searchsorted`` over the
sorted node ids where the reference walks a Python dict, with equal arrays
(a seed drawn twice maps to its last slot, as the dict's last write does).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .container import Graph


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One sampled k-hop block (padded to static capacity)."""

    node_ids: np.ndarray      # (cap_nodes,) global ids, -1 pad
    n_nodes: int
    edge_src: np.ndarray      # (cap_edges,) local indices into node_ids
    edge_dst: np.ndarray
    n_edges: int
    seed_count: int           # first `seed_count` node_ids are the seeds


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: Sequence[int], seed: int = 0):
        # symmetric CSR, sorted on the graph's device (a host sort of
        # reddit's 229 M directed edges takes ~30 s); a stable sort, so
        # the arrays equal the reference's host numpy ones
        edges = g.edges
        src = torch.cat([edges[:, 0], edges[:, 1]])
        dst = torch.cat([edges[:, 1], edges[:, 0]])
        order = torch.argsort(src, stable=True)
        self.dst = dst[order].cpu().numpy()
        counts = torch.bincount(src, minlength=g.n).cpu().numpy()
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n = g.n
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def capacities(batch_nodes: int, fanouts: Sequence[int]):
        """Static worst-case (n_nodes, n_edges) for a padded block."""
        nodes, layer = batch_nodes, batch_nodes
        edges = 0
        for f in fanouts:
            edges += layer * f
            layer *= f
            nodes += layer
        return nodes, edges

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        cap_nodes, cap_edges = self.capacities(len(seeds), self.fanouts)
        frontier = np.asarray(seeds, dtype=np.int64)
        all_src, all_dst = [], []
        node_list = [frontier]
        for f in self.fanouts:
            deg = self.offsets[frontier + 1] - self.offsets[frontier]
            # uniform with replacement when deg > 0 (standard GraphSAGE)
            draw = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            nbr = self.dst[self.offsets[frontier][:, None] + draw]
            valid = np.broadcast_to(deg[:, None] > 0, (len(frontier), f))
            src = np.repeat(frontier, f).reshape(len(frontier), f)
            all_src.append(src[valid])
            all_dst.append(nbr[valid])
            frontier = np.unique(nbr[valid])
            node_list.append(frontier)
        nodes = np.unique(np.concatenate(node_list))
        # relabel: seeds first
        seeds64 = np.asarray(seeds, dtype=np.int64)
        rest = np.setdiff1d(nodes, seeds64, assume_unique=False)
        node_ids = np.concatenate([seeds64, rest])
        order = np.argsort(node_ids, kind="stable")
        ranked = node_ids[order]

        def local(x):
            # the last slot holding each id (stable sort: last among equals)
            return order[np.searchsorted(ranked, x, side="right") - 1]

        src = local(np.concatenate(all_src)).astype(np.int32)
        dst = local(np.concatenate(all_dst)).astype(np.int32)
        # pad to capacity
        pad_nodes = np.full(cap_nodes, -1, dtype=np.int64)
        pad_nodes[: len(node_ids)] = node_ids
        pad_src = np.zeros(cap_edges, dtype=np.int32)
        pad_dst = np.zeros(cap_edges, dtype=np.int32)
        pad_src[: len(src)] = src
        pad_dst[: len(dst)] = dst
        return SampledBlock(node_ids=pad_nodes, n_nodes=len(node_ids),
                            edge_src=pad_src, edge_dst=pad_dst,
                            n_edges=len(src), seed_count=len(seeds))
