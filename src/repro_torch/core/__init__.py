"""The (r, s) nucleus decomposition: incidence build, peel backends,
hierarchies and the ``decompose()`` front door (counterpart of
``repro.core``).

  decompose(graph, config) -> Decomposition
      incidence structure, exact/approx peeling on a registered backend
      (the dense engine, the eager gather loop, the sequential NH
      baseline), the hierarchy (fused, replay, two_phase, basic), and the
      build-once/query-many artifact with its JSON form.
  NucleusConfig / Plan / resolve_plan / register_backend
      the validated config, the capability-declared backend registry and
      the ``backend='auto'`` planner (``core.backends``).
  Session / GraphDelta / update_decomposition
      warm decompose-many through pow2 shape buckets (``core.session``) and
      the exact incremental ``Decomposition.update`` (``core.streaming``).

The building blocks are exported under the reference's names.  The
reference's deprecated package-level wrappers have no counterpart: the
functions are exported plainly.
"""
from .api import (ConfigError, Decomposition, Nucleus, NucleusConfig,
                  decompose, plan_config, resolve_problem)
from .backends import (Backend, BackendCapabilities, BackendResult, Plan,
                       resolve_plan)
from .backends import register as register_backend
from .engine import (dense_coreness, h_index_rows, link_fixpoint,
                     local_converge, make_schedule, peel_round, round_links,
                     run_peel_engine, scatter_decrement)
from .hierarchy import (HierarchyTree, build_hierarchy_basic,
                        build_hierarchy_levels, hierarchy_edges)
from .incidence import (NucleusProblem, build_problem, pick_rank,
                        problem_from_reference)
from .interleaved import (InterleavedResult, LinkState,
                          build_hierarchy_interleaved,
                          construct_tree_efficient, link_state_from_forest,
                          replay_trace)
from .kcore import kcore_coreness
from .nh_baseline import (brute_force_coreness, nh_coreness, nh_full,
                          nh_hierarchy)
from .nuclei import (canonicalize_labels, cut_hierarchy, edge_densities,
                     edge_density, nuclei_without_hierarchy,
                     nucleus_vertex_sets, same_partition)
from .peel import PeelResult, approx_coreness, exact_coreness
from .schedule import PeelSchedule
from .streaming import GraphDelta, UpdateStats, update_decomposition
from .session import Session
