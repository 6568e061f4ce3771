"""Shared shape grid of the GNN-family architectures (counterpart of
``repro.configs.gnn_shapes``).

Shapes carry their own feature/label dims (taken from the public datasets the
shapes correspond to: cora / reddit / ogbn-products / QM9-like molecules).
Equivariant archs get synthetic 3-D positions on every shape; DimeNet
additionally gets capacity-capped triplet lists (cap recorded here).
``cfg_for_cell`` is the reference's per-cell config rule (its dry run's
``_gnn_cfg_for_cell``): ``d_in`` from the cell's features, the classes
(``n_classes`` or ``n_out``) and ``graph_level`` from the cell.
``gnn_input_specs`` gives a cell's batch on ``meta``, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .base import ArchSpec, ShapeCell, meta_spec

# static sampler capacities for minibatch_lg (fanout 15-10 over 1024 seeds)
_MB_NODES = 1024 * (1 + 15 + 150)      # 169,984
_MB_EDGES = 1024 * (15 + 150)          # 168,960

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train",
              {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433,
               "n_classes": 7, "triplet_cap": 8}),
    ShapeCell("minibatch_lg", "train",
              {"n_nodes": _MB_NODES, "n_edges": _MB_EDGES, "d_feat": 602,
               "n_classes": 41, "triplet_cap": 8,
               "base_nodes": 232_965, "base_edges": 114_615_892,
               "batch_nodes": 1_024, "fanout": (15, 10)}),
    ShapeCell("ogb_products", "train",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
               "n_classes": 47, "triplet_cap": 4}),
    ShapeCell("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
               "triplet_cap": 8}),
)


def needs_pos(arch_id: str) -> bool:
    return arch_id in ("egnn", "mace", "dimenet")


def needs_triplets(arch_id: str) -> bool:
    return arch_id == "dimenet"


def is_node_level(cell: ShapeCell) -> bool:
    """Every cell but ``molecule`` is a node task (n_graphs == n_nodes,
    graph_id the node index)."""
    return cell.name != "molecule"


def cfg_for_cell(spec: ArchSpec, cell: ShapeCell) -> Any:
    """``spec``'s full config with the cell's ``d_in`` and classes: a node
    cell's ``n_classes`` (gin also ``graph_level=False``), a molecule's one
    output."""
    cfg = spec.make_config()
    d = cell.dims
    node_level = is_node_level(cell)
    n_out = d.get("n_classes", 1) if node_level else 1
    kw = {"d_in": d["d_feat"]}
    fields = {f.name for f in dataclasses.fields(cfg)}
    if "n_classes" in fields:
        kw["n_classes"] = n_out
        if "graph_level" in fields:
            kw["graph_level"] = not node_level
    if "n_out" in fields:
        kw["n_out"] = n_out
    return dataclasses.replace(cfg, **kw)


def gnn_input_specs(arch_id: str):
    """The arch's ``input_specs``: a cell's padded batch on ``meta`` (a
    molecule cell is ``batch`` graphs side by side), with positions for
    the equivariant archs and the capped triplet lists for dimenet, and
    the step's ``n_graphs`` and ``node_level``."""
    def specs(cfg: Any, cell: ShapeCell) -> Dict[str, Any]:
        d = cell.dims
        if cell.name == "molecule":
            N = d["n_nodes"] * d["batch"]
            E = d["n_edges"] * d["batch"]
            n_graphs = d["batch"]
            node_level = False
        else:
            N, E = d["n_nodes"], d["n_edges"]
            n_graphs = N          # node-level: identity "pooling"
            node_level = True
        batch = {
            "nodes": meta_spec((N, d["d_feat"])),
            "edge_src": meta_spec((E,), torch.int32),
            "edge_dst": meta_spec((E,), torch.int32),
            "node_mask": meta_spec((N,), torch.bool),
            "edge_mask": meta_spec((E,), torch.bool),
            "graph_id": meta_spec((N,), torch.int32),
        }
        if needs_pos(arch_id):
            batch["pos"] = meta_spec((N, 3))
        if needs_triplets(arch_id):
            T = E * d["triplet_cap"]
            batch["triplet_kj"] = meta_spec((T,), torch.int32)
            batch["triplet_ji"] = meta_spec((T,), torch.int32)
            batch["triplet_mask"] = meta_spec((T,), torch.bool)
        if node_level:
            batch["labels"] = meta_spec((N,), torch.int32)
            batch["label_mask"] = meta_spec((N,))
        else:
            batch["energy"] = meta_spec((n_graphs, 1))
        return {"batch": batch, "n_graphs": n_graphs,
                "node_level": node_level}
    return specs
