"""End-to-end driver: nucleus decomposition CURATES the training graph for a
GNN: the paper's technique composed with an assigned architecture.

    PYTHONPATH=src python -m repro_torch.examples.graph_pipeline
        [--device cpu]

Pipeline:
  1. build a noisy social-like graph with planted communities,
  2. run (2,3) nucleus decomposition + hierarchy (the paper),
  3. cut the hierarchy to keep only dense nuclei -> curated subgraph,
  4. train GIN on both raw and curated graphs on a community-recovery task,
  5. report the accuracy gain from nucleus curation.

The task and the curation are the reference's draw for draw.  GIN's
parameters come from a ``torch.Generator`` seeded ``seed``, so the
accuracies are the port's own.  On the card the decomposition, the batch
and every training step stay on the device.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import NucleusConfig, decompose, resolve_device
from ..graph import make_graph
from ..launch import steps as S
from ..models import gin
from ..models.gnn_common import make_batch_from_arrays
from ..optim import adamw


def make_task(seed=0, n=240, k=4, device=None):
    """k planted communities + heavy inter-community noise edges."""
    rng = np.random.default_rng(seed)
    per = n // k
    edges = []
    labels = np.zeros(n, np.int64)
    for c in range(k):
        mem = np.arange(c * per, (c + 1) * per)
        labels[mem] = c
        for _ in range(per * 6):
            u, v = rng.choice(mem, 2, replace=False)
            edges.append((u, v))
    for _ in range(n * 4):                     # noise
        u, v = rng.integers(0, n, 2)
        edges.append((u, v))
    return make_graph(n, np.asarray(edges), device), labels


def curate(g):
    """Decompose ``g`` at (2,3) on its device, cut at ``max(2, kmax // 3)``
    and keep the edges inside the nuclei there: (curated graph, keep
    mask, nuclei, cut level)."""
    e = g.edges
    dec = decompose(g, NucleusConfig(r=2, s=3, backend="dense",
                                     hierarchy="two_phase"), device=e.device)
    kmax = int(dec.core.max())
    cut_level = max(2, kmax // 3)
    nuclei = dec.nuclei(cut_level)
    keep = np.zeros(g.n, bool)
    for nc in nuclei.values():
        keep[nc.vertices] = True
    keep_t = torch.from_numpy(keep).to(e.device)
    sel = keep_t[e[:, 0]] & keep_t[e[:, 1]]
    g_cur = make_graph(g.n, e[sel], e.device)
    return g_cur, keep, nuclei, cut_level


def train_gin(g, labels, seed=0, steps=150, device=None):
    dev = resolve_device(device)
    n = g.n
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(
        rng.standard_normal((n, 16)).astype(np.float32)).to(dev)
    e = g.edges.to(dev)
    src = torch.cat([e[:, 0], e[:, 1]]).to(torch.int32)
    dst = torch.cat([e[:, 1], e[:, 0]]).to(torch.int32)
    cfg = gin.GINConfig(d_in=16, n_layers=3, d_hidden=32,
                        n_classes=int(labels.max()) + 1, graph_level=False)
    params = gin.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = adamw.init_state(params)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                                weight_decay=0.0)
    train_mask = (rng.random(n) < 0.3).astype(np.float32)
    labels_t = torch.as_tensor(labels, dtype=torch.int32, device=dev)
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    batch = {"nodes": feats, "edge_src": src, "edge_dst": dst,
             "node_mask": torch.ones((n,), dtype=torch.bool, device=dev),
             "edge_mask": torch.ones_like(src, dtype=torch.bool),
             "graph_id": node_ids, "labels": labels_t,
             "label_mask": torch.from_numpy(train_mask).to(dev)}
    for _ in range(steps):
        params, opt, _ = S.gnn_train_step(
            params, opt, batch, cfg=cfg, arch="gin-tu", n_graphs=n,
            node_level=True, opt_cfg=opt_cfg)
    # eval on held-out nodes
    gb = make_batch_from_arrays(feats, src, dst, graph_id=node_ids,
                                n_graphs=n, device=dev)
    with torch.no_grad():
        pred = torch.argmax(gin.forward(params, gb, cfg), -1)
    test = torch.from_numpy(train_mask == 0).to(dev)
    return float((pred[test] == labels_t[test]).float().mean())


def main(argv: Optional[Sequence[str]] = None, *, steps: int = 150
         ) -> Dict[str, Any]:
    """``steps``: GIN steps per graph (the reference's 150; tests pass
    fewer)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g, labels = make_task(device=dev)
    print(f"raw graph: n={g.n} m={g.m}")

    # --- the paper: decompose, cut, curate ---------------------------------
    g_cur, keep, nuclei, cut_level = curate(g)
    print(f"curated:  kept {keep.sum()} / {g.n} vertices inside "
          f"{len(nuclei)} nuclei at c={cut_level}; m={g_cur.m}")

    acc_raw = train_gin(g, labels, seed=1, steps=steps, device=dev)
    acc_cur = train_gin(g_cur, labels, seed=1, steps=steps, device=dev)
    print(f"GIN community recovery:  raw graph acc={acc_raw:.3f}   "
          f"nucleus-curated acc={acc_cur:.3f}")
    return {"n": g.n, "m": g.m, "kept": int(keep.sum()), "keep": keep,
            "n_nuclei": len(nuclei), "cut_level": cut_level,
            "curated_edges": g_cur.edges.cpu().numpy(), "m_curated": g_cur.m,
            "acc_raw": acc_raw, "acc_curated": acc_cur}


if __name__ == "__main__":
    main()
