"""The (r, s) nucleus decomposition: incidence build, peel engine,
hierarchy and the ``decompose()`` front door (counterpart of
``repro.core``)."""
from .api import (ConfigError, Decomposition, Nucleus, NucleusConfig,
                  decompose, resolve_problem)
from .engine import (dense_coreness, link_fixpoint, make_schedule,
                     peel_round, round_links, run_peel_engine,
                     scatter_decrement)
from .hierarchy import HierarchyTree
from .incidence import (NucleusProblem, build_problem, pick_rank,
                        problem_from_reference)
from .interleaved import (LinkState, construct_tree_efficient,
                          link_state_from_forest)
from .nuclei import (canonicalize_labels, edge_densities, edge_density,
                     nucleus_vertex_sets)
from .peel import PeelResult, approx_coreness, exact_coreness
from .schedule import PeelSchedule
