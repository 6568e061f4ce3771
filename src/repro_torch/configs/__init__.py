"""Architecture configs (counterpart of ``repro.configs``): one module per
ported arch.

`get_arch(id)` returns the registered ArchSpec; importing this package
registers the reference's five LM archs (three dense, the MoE
moonshot-v1-16b-a3b and the MoE + MLA deepseek-v2-lite-16b) and
``nucleus`` (the paper's workload at SNAP scale, ``configs.nucleus``).
Every LM arch serves (``launch.serve``) and trains (``launch.train``).
The GNN and recsys archs are not yet ported.  Serving ``--arch nucleus``
needs no arch config: ``launch.serve`` runs it.
"""
from .base import ArchSpec, ShapeCell, get_arch, all_archs, pad_vocab
from . import (stablelm_12b, minicpm_2b, minitron_4b, moonshot_v1_16b_a3b,
               deepseek_v2_lite_16b, nucleus)

ALL_ARCH_IDS = tuple(sorted(all_archs()))
