"""Model zoo of the port (counterpart of ``repro.models``).

LM family:  transformer (GQA / MLA attention, dense / MoE FFN)
GNN family: gin, egnn, dimenet, mace over GraphBatch (+ gnn_common substrate)
RecSys:     din (+ the EmbeddingBag substrate)
"""
from . import transformer
from . import gnn_common
from . import gin
from . import egnn
from . import dimenet
from . import mace
from . import din
from .gnn_common import GraphBatch, make_batch_from_arrays, build_triplets
from .transformer import MLAConfig, MoEConfig, TransformerConfig
