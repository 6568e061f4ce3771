from .container import (Graph, Digraph, make_graph, orient, csr_from_pairs,
                        is_member, PAD, INT)
from .orientation import degree_rank, approx_degeneracy_rank
from .cliques import sort_join, lexsort_rows, subset_columns, expand_levels
from .connectivity import connected_components, pointer_jump
from .unionfind import (BatchedUnionFind, uf_create, uf_find_all,
                        uf_union_edges)
from . import generators
from .sampler import NeighborSampler, SampledBlock
