"""Architecture configs (counterpart of ``repro.configs``): one module per
ported arch.

`get_arch(id)` returns the registered ArchSpec; importing this package
registers the three dense LM archs.  The MoE and MLA archs
(moonshot-v1-16b-a3b, deepseek-v2-lite-16b) and the GNN and recsys archs
are not yet ported; neither is the ``nucleus`` arch config (its consumers
are the sharded dry run and the distributed backend).  Serving
``--arch nucleus`` needs no arch config: ``launch.serve`` runs it.
"""
from .base import ArchSpec, ShapeCell, get_arch, all_archs, pad_vocab
from . import stablelm_12b, minicpm_2b, minitron_4b

ALL_ARCH_IDS = tuple(sorted(all_archs()))
