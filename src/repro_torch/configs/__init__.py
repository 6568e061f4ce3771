"""Architecture configs (counterpart of ``repro.configs``): one module per
ported arch.

`get_arch(id)` returns the registered ArchSpec; importing this package
registers every arch of the reference: the five LM archs (three dense,
the MoE moonshot-v1-16b-a3b and the MoE + MLA deepseek-v2-lite-16b), the
four GNN archs (gin-tu, egnn, dimenet, mace; their cells in
``configs.gnn_shapes``), the recsys arch din, and ``nucleus`` (the
paper's workload at SNAP scale, ``configs.nucleus``).  Every LM arch and
din serve (``launch.serve``) and train (``launch.train``); the GNN archs
train through ``launch.steps.gnn_train_step`` (the reference has no GNN
launcher).  Serving ``--arch nucleus`` needs no arch config:
``launch.serve`` runs it.
"""
from .base import ArchSpec, ShapeCell, get_arch, all_archs, pad_vocab
from . import (stablelm_12b, minicpm_2b, minitron_4b, moonshot_v1_16b_a3b,
               deepseek_v2_lite_16b, gin_tu, egnn, dimenet, mace, din,
               nucleus)

ALL_ARCH_IDS = tuple(sorted(all_archs()))
