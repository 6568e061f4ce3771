"""Data pipelines: deterministic, resumable, host-side synthetic sources
(counterpart of ``repro.data.pipeline``; host numpy, batch for batch the
reference's).

Every source is seeded and step-indexed, so a restore at step N
reproduces batch N exactly (a checkpoint stores only the step).  Batches
are numpy arrays; the train loop moves them to its device.
``GraphMinibatchStream`` samples its blocks with the port's
``NeighborSampler``, and ``synthetic_molecules`` lists triplets with the
port's ``build_triplets``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..graph import Graph, NeighborSampler
from ..models.gnn_common import build_triplets


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenStream:
    """Synthetic LM token batches with a Zipfian unigram + ngram structure
    (so losses actually decrease during example training runs)."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        B, S = self.cfg.global_batch, self.cfg.seq_len
        toks = rng.choice(self.cfg.vocab, size=(B, S + 1), p=self._probs)
        # inject learnable bigram structure: x[t+1] = f(x[t]) half the time
        nxt = (toks[:, :-1] * 31 + 7) % self.cfg.vocab
        mask = rng.random((B, S)) < 0.5
        toks[:, 1:][mask] = nxt[mask]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class RecsysStreamConfig:
    n_items: int
    n_cates: int
    n_users: int
    seq_len: int
    batch: int
    seed: int = 0


class RecsysStream:
    """DIN batches: user history (items+cates), candidate, CTR label with a
    planted preference signal (users favour items in their own cluster)."""

    def __init__(self, cfg: RecsysStreamConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        user = rng.integers(0, c.n_users, size=c.batch)
        cluster = user % 64
        hist = (rng.integers(0, c.n_items // 64, size=(c.batch, c.seq_len))
                * 64 + cluster[:, None]) % c.n_items
        # random padding tail
        lens = rng.integers(c.seq_len // 2, c.seq_len + 1, size=c.batch)
        pad = np.arange(c.seq_len)[None, :] >= lens[:, None]
        hist[pad] = -1
        cand_pos = rng.random(c.batch) < 0.5
        cand = np.where(
            cand_pos,
            (rng.integers(0, c.n_items // 64, size=c.batch) * 64 + cluster)
            % c.n_items,
            rng.integers(0, c.n_items, size=c.batch))
        return {
            "hist_items": hist.astype(np.int32),
            "hist_cates": np.where(hist >= 0, hist % c.n_cates, -1).astype(np.int32),
            "cand_item": cand.astype(np.int32),
            "cand_cate": (cand % c.n_cates).astype(np.int32),
            "user_id": user.astype(np.int32),
            "label": cand_pos.astype(np.float32),
        }


class GraphMinibatchStream:
    """Fanout-sampled GNN blocks over a base graph (minibatch_lg shape)."""

    def __init__(self, g: Graph, fanouts: Sequence[int], batch_nodes: int,
                 d_feat: int, n_classes: int, seed: int = 0,
                 with_pos: bool = False, triplet_cap: Optional[int] = None):
        self.sampler = NeighborSampler(g, fanouts, seed=seed)
        self.g = g
        self.batch_nodes = batch_nodes
        self.d_feat = d_feat
        self.n_classes = n_classes
        self.seed = seed
        self.with_pos = with_pos
        self.triplet_cap = triplet_cap
        self.cap_nodes, self.cap_edges = NeighborSampler.capacities(
            batch_nodes, fanouts)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.integers(0, self.g.n, size=self.batch_nodes)
        blk = self.sampler.sample(seeds)
        feat_rng = np.random.default_rng(self.seed + 1)
        feats = feat_rng.standard_normal(
            (self.cap_nodes, self.d_feat)).astype(np.float32)
        out = {
            "nodes": feats,
            "edge_src": blk.edge_src,
            "edge_dst": blk.edge_dst,
            "node_mask": (np.arange(self.cap_nodes) < blk.n_nodes),
            "edge_mask": (np.arange(self.cap_edges) < blk.n_edges),
            "labels": rng.integers(0, self.n_classes,
                                   size=self.cap_nodes).astype(np.int32),
            "label_mask": (np.arange(self.cap_nodes)
                           < blk.seed_count).astype(np.float32),
        }
        if self.with_pos:
            out["pos"] = feat_rng.standard_normal(
                (self.cap_nodes, 3)).astype(np.float32)
        return out


def synthetic_molecules(n_graphs: int, n_nodes: int, n_edges: int,
                        d_feat: int, seed: int = 0,
                        triplet_cap: Optional[int] = None):
    """A batch of random molecular graphs (positions in a box, kNN edges).

    Returns flat padded arrays for a GraphBatch + per-graph energy targets
    with a learnable structure (sum of pairwise LJ-ish terms).
    """
    rng = np.random.default_rng(seed)
    N, E = n_graphs * n_nodes, n_graphs * n_edges
    pos = rng.uniform(0, 2.5, size=(N, 3)).astype(np.float32)
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)
    srcs, dsts = [], []
    for gi in range(n_graphs):
        base = gi * n_nodes
        p = pos[base:base + n_nodes]
        d2 = np.sum((p[:, None] - p[None, :]) ** 2, -1)
        np.fill_diagonal(d2, np.inf)
        k = max(1, n_edges // n_nodes)
        nbr = np.argsort(d2, axis=1)[:, :k]
        s = np.repeat(np.arange(n_nodes), k) + base
        t = nbr.reshape(-1) + base
        srcs.append(s[:n_edges])
        dsts.append(t[:n_edges])
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    graph_id = np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32)
    # synthetic energies: smooth function of geometry
    d = np.linalg.norm(pos[src] - pos[dst], axis=1)
    e_per_edge = 4.0 * ((0.8 / d) ** 12 - (0.8 / d) ** 6)
    energy = np.zeros(n_graphs, np.float32)
    np.add.at(energy, graph_id[src], e_per_edge.astype(np.float32) / 2)
    trip = build_triplets(src, dst, N, cap_per_edge=triplet_cap)
    return {
        "nodes": feats, "pos": pos, "edge_src": src, "edge_dst": dst,
        "graph_id": graph_id, "n_graphs": n_graphs,
        "triplets": trip, "energy": np.tanh(energy).astype(np.float32),
    }
