"""The front door: ``decompose(graph, config) -> Decomposition``.

Counterpart of ``repro.core.api``: one build-once/query-many artifact,
coreness plus the join-forest hierarchy, queried at many resolutions
(Fig. 10).

  * ``NucleusConfig`` captures every axis in one frozen, validated record:
    (r, s), exact or approx peeling, the backend (``dense``, ``gather``,
    ``nh`` or ``auto``), the hierarchy strategy (``none``, ``fused``,
    ``replay``, ``two_phase``, ``basic`` or ``auto``), the kernel knob and
    the build.  Backend legality is derived from the registry's capability
    declarations (``backends.check_capabilities``), so the legal triples
    and their messages are the reference's.
  * ``decompose`` builds the incidence structure on the device (``None``:
    the card), lets the planner resolve ``auto`` axes
    (``backends.resolve_plan``), runs the registered backend and returns a
    ``Decomposition``.
  * ``Decomposition`` holds the results as host numpy arrays and answers
    ``tree``/``cut(c)``/``nuclei(c)`` lazily with caching.  ``to_json()``/
    ``from_json()`` round-trip the artifact in the reference's format
    (``JSON_FORMAT``, version 2, version 1 readable), so an artifact of
    either package loads in the other.

``Decomposition.update(delta)`` maintains an exact artifact under edge
inserts and deletes (``core.streaming``).  Not ported yet (``NOT_PORTED``;
each raises ``ConfigError`` naming it): the sharded backend and build,
``compress`` and ``build_shards`` (ROADMAP Queue 1.9).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..graph.container import Graph
from . import backends as backend_registry
from .backends import (AUTO, BACKENDS, HIERARCHIES, METHODS, ConfigError,
                       Plan, not_ported)
from .hierarchy import (HierarchyTree, build_hierarchy_basic,
                        build_hierarchy_levels)
from .incidence import BUILDS, NucleusProblem, build_problem
from .interleaved import (construct_tree_efficient, forest_from_trace,
                          link_state_from_forest)
from .nuclei import grouped_densities, grouped_vertex_sets, split_groups
from .peel import PeelResult

JSON_FORMAT = "repro.nucleus-decomposition"
JSON_VERSION = 2
# version 1 artifacts (pre-Plan) load fine: "plan" is simply absent.
SUPPORTED_JSON_VERSIONS = (1, 2)

# what the reference runs that the port does not yet
NOT_PORTED = ("backend='sharded'", "build='sharded'", "compress=True",
              "build_shards")

__all__ = ["AUTO", "BACKENDS", "HIERARCHIES", "METHODS", "NOT_PORTED",
           "ConfigError", "Decomposition", "Nucleus", "NucleusConfig",
           "decompose", "execute_plan", "plan_config", "resolve_problem"]


@dataclasses.dataclass(frozen=True)
class NucleusConfig:
    """Every axis of a nucleus decomposition, in one validated record.

      r, s        — the (r, s) of the decomposition, 1 <= r < s.
      method      — "exact" or "approx" (Alg. 2, geometric buckets);
                    ``delta`` sets the approximation knob.
      backend     — "dense" (the peel engine on the device; (1, 2) takes
                    the k-core lane unless ``use_kernel=True``), "gather"
                    (the eager work-efficient host loop), "nh" (the
                    sequential baseline) or "auto" (the registry planner
                    picks from the device, the problem size and the
                    memory budget).  "sharded" is registered but not yet
                    ported.
      hierarchy   — "none", "fused" (LINK fixpoint inside the peel loop),
                    "replay" (host trace replay), "two_phase" (ANH-TE),
                    "basic" (ANH-BL) or "auto" (the richest strategy the
                    resolved backend supports).
      use_kernel  — the reference's ``use_pallas``: True runs the dense
                    engine's round on the hand-written kernels (on CPU
                    tensors, their plain versions) and pins the generic
                    engine at (1, 2); False runs plain torch; None
                    (default) resolves per device (``engine.
                    kernel_by_default``: the kernels on CUDA).  It is
                    written as ``use_pallas`` in ``to_dict()``.
      mesh        — the sharded backend's device mesh; compress — its
                    collective's compression (neither is ported yet: only
                    backend='sharded' takes them).
      build       — incidence builder: "eager" or "chunked" (memory-
                    bounded; bit-identical).  "sharded" is not yet ported.
      memory_budget_bytes — the chunked build's intermediate-memory budget
                    (None = a 256 MiB default).  With backend='auto' it is
                    also the planner's memory ceiling: the gather backend
                    is preferred where the dense engine's per-round working
                    set would exceed it, and an eager build whose estimated
                    working set exceeds it is upgraded to 'chunked' before
                    the incidence structure is built.
      build_chunk_size — explicit source vertices per chunk (overrides the
                    budget-derived size; pins the sparse chunked path).
      build_shards — the sharded builder's worker count (not yet ported).
    """

    r: int = 2
    s: int = 3
    method: str = "exact"
    delta: float = 0.1
    backend: str = "dense"
    hierarchy: str = "fused"
    use_kernel: Optional[bool] = None
    mesh: Optional[Any] = None
    compress: bool = False
    build: str = "eager"
    memory_budget_bytes: Optional[int] = None
    build_chunk_size: Optional[int] = None
    build_shards: Optional[int] = None

    def validate(self) -> "NucleusConfig":
        """Reject unsupported combinations with actionable errors.

        Backend x (method, hierarchy, knob) legality is derived from the
        registry's capability declarations; this method holds the
        backend-independent axis checks, as the reference's does, and
        raises "not yet ported" for the build knobs the port lacks.
        ``backend='auto'``/``hierarchy='auto'`` are accepted here; the
        planner resolves them at decompose() time.
        """
        if not 1 <= self.r < self.s:
            raise ConfigError(
                f"need 1 <= r < s, got (r, s) = ({self.r}, {self.s})")
        if self.method not in METHODS:
            raise ConfigError(
                f"method={self.method!r}; expected one of {METHODS}")
        if self.backend != AUTO and \
                self.backend not in backend_registry.names():
            raise ConfigError(
                f"backend={self.backend!r}; expected one of "
                f"{backend_registry.names() + (AUTO,)}")
        if self.hierarchy != AUTO and self.hierarchy not in HIERARCHIES:
            raise ConfigError(
                f"hierarchy={self.hierarchy!r}; expected one of "
                f"{HIERARCHIES + (AUTO,)}")
        if self.method == "approx" and not self.delta > 0:
            raise ConfigError(
                f"method='approx' needs delta > 0, got {self.delta}")
        backend_registry.check_capabilities(self)
        if self.compress:
            raise not_ported("compress=True")
        if self.build == "sharded":
            raise not_ported("build='sharded'")
        if self.build not in BUILDS:
            raise ConfigError(
                f"build={self.build!r}; expected one of {BUILDS}")
        if self.memory_budget_bytes is not None:
            # with backend='auto' the budget is also the planner's memory
            # ceiling (and can upgrade the build), so it stays legal there
            # with build='eager'
            if self.build not in ("chunked", "sharded") and \
                    self.backend != AUTO:
                raise ConfigError(
                    "memory_budget_bytes sizes the chunked/sharded "
                    "incidence builders (or guides backend='auto'); set "
                    "build='chunked'/'sharded', backend='auto', or drop "
                    "the budget")
            if self.memory_budget_bytes <= 0:
                raise ConfigError(
                    f"memory_budget_bytes must be positive, got "
                    f"{self.memory_budget_bytes}")
        if self.build_chunk_size is not None:
            if self.build not in ("chunked", "sharded"):
                raise ConfigError(
                    "build_chunk_size is the chunked/sharded builders' "
                    "chunk; set build='chunked'/'sharded' or drop it")
            if self.build_chunk_size <= 0:
                raise ConfigError(
                    f"build_chunk_size must be positive, got "
                    f"{self.build_chunk_size}")
        if self.build_shards is not None:
            raise not_ported("build_shards (the sharded builder's worker "
                             "count)")
        return self

    @classmethod
    def legal_combinations(cls) -> List[Tuple[str, str, str]]:
        """Every (method, backend, hierarchy) triple ``validate()`` accepts
        — the reference's 29, in its order."""
        out = []
        for method in METHODS:
            for backend in backend_registry.names():  # live registry
                for hierarchy in HIERARCHIES:
                    cfg = cls(method=method, backend=backend,
                              hierarchy=hierarchy)
                    try:
                        cfg.validate()
                    except ConfigError:
                        continue
                    out.append((method, backend, hierarchy))
        return out

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe view with the reference's key set: ``use_kernel`` is
        written as ``use_pallas`` (so the reference's ``from_dict`` reads
        it) and the mesh, a process-local handle, is dropped."""
        d = dataclasses.asdict(self)
        d.pop("mesh")
        d["use_pallas"] = d.pop("use_kernel")
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NucleusConfig":
        d = {k: v for k, v in d.items() if k != "mesh"}
        if "use_pallas" in d:
            d["use_kernel"] = d.pop("use_pallas")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Nucleus:
    """One c-(r, s) nucleus: its vertex set + the Fig. 10 quality metric."""

    label: int
    vertices: np.ndarray   # sorted unique vertex ids
    n_r_cliques: int       # r-cliques carrying the nucleus
    density: float         # |E(S)| / C(|S|, 2); nan if edges unavailable


def _ints(x) -> List[int]:
    return np.asarray(x).reshape(-1).tolist()


def _opt_ints(x) -> Optional[List[int]]:
    return None if x is None else _ints(x)


class Decomposition:
    """The build-once/query-many artifact: coreness + hierarchy + queries.

    The peel (``core``, ``rounds``, the trace and, for hierarchy='fused',
    the join forest) is computed by ``decompose()``; the rest is lazy and
    cached:

      .tree      — first access builds the ``HierarchyTree`` from the fused
                   forest, the trace replay or the two-phase/basic builder.
      .cut(c)    — first call per level walks the tree; repeats are O(1).
      .nuclei(c) — vertex sets + densities, derived from the cached cut.

    ``to_json()`` pins the artifact (tree materialized, the inputs the
    queries need embedded), so ``from_json()`` serves queries with no
    ``NucleusProblem``.
    """

    def __init__(self, config: NucleusConfig, *,
                 problem: Optional[NucleusProblem] = None,
                 core: np.ndarray, rounds: int,
                 order_round: Optional[np.ndarray] = None,
                 peel_value: Optional[np.ndarray] = None,
                 uf_parent: Optional[np.ndarray] = None,
                 uf_L: Optional[np.ndarray] = None,
                 tree: Optional[HierarchyTree] = None,
                 r_cliques: Optional[np.ndarray] = None,
                 edges: Optional[np.ndarray] = None,
                 n_vertices: Optional[int] = None,
                 n_s: Optional[int] = None,
                 plan: Optional[Plan] = None,
                 name: Optional[str] = None,
                 version: int = 0):
        self.config = config
        self._name = name
        self._version = int(version)
        self._plan = plan
        self.problem = problem
        self._core = np.asarray(core)
        self._rounds = int(rounds)
        self._order_round = None if order_round is None \
            else np.asarray(order_round)
        self._peel_value = self._core if peel_value is None \
            else np.asarray(peel_value)
        self._uf_parent = None if uf_parent is None else np.asarray(uf_parent)
        self._uf_L = None if uf_L is None else np.asarray(uf_L)
        self._tree = tree
        self._r_cliques = None if r_cliques is None else np.asarray(r_cliques)
        self._edges = None if edges is None else np.asarray(edges)
        self._n_vertices = n_vertices
        self._n_s = n_s
        self._cuts: Dict[int, np.ndarray] = {}
        self._nuclei: Dict[int, Dict[int, Nucleus]] = {}
        self._link_stats: Optional[Tuple[int, int]] = None

    # -- materialized by decompose() --------------------------------------
    @property
    def core(self) -> np.ndarray:
        """(n_r,) core numbers (approx: clipped practical estimates)."""
        return self._core

    @property
    def rounds(self) -> int:
        """Peel rounds."""
        return self._rounds

    @property
    def order_round(self) -> Optional[np.ndarray]:
        """(n_r,) round each r-clique peeled — the peel trace (None on
        backends that do not record it: nh)."""
        return self._order_round

    @property
    def peel_value(self) -> np.ndarray:
        """(n_r,) raw bucket values (unclipped) — what LINK equality saw."""
        return self._peel_value

    @property
    def n_r(self) -> int:
        return int(self._core.shape[0])

    # -- live-artifact identity --------------------------------------------
    @property
    def name(self) -> Optional[str]:
        """The serving-side artifact name (None until published)."""
        return self._name

    @name.setter
    def name(self, value: Optional[str]) -> None:
        self._name = value

    @property
    def version(self) -> int:
        """Live-artifact version: 0 at decompose() time, incremented by
        every ``update(delta)``."""
        return self._version

    @property
    def has_hierarchy(self) -> bool:
        return self.config.hierarchy != "none"

    @property
    def link_stats(self) -> Optional[Tuple[int, int]]:
        """(links processed, unions) of the host LINK replay — populated
        only after hierarchy='replay' materializes the tree."""
        return self._link_stats

    @property
    def uf_parent(self) -> Optional[np.ndarray]:
        """(n_r,) resolved ANH-EL union-find — the join forest (fused:
        computed by decompose(); replay: after .tree materializes)."""
        return self._uf_parent

    @property
    def uf_L(self) -> Optional[np.ndarray]:
        """(n_r,) nearest-lower-core table of the join forest."""
        return self._uf_L

    # -- the planner's decision record -------------------------------------
    @property
    def plan(self) -> Optional[Plan]:
        """How backend/hierarchy were resolved (None only on version-1
        artifacts)."""
        return self._plan

    def plan_report(self) -> str:
        """Human-readable resolution report."""
        if self._plan is None:
            return "plan: not recorded (artifact predates plan embedding)"
        return self._plan.report()

    # -- lazy hierarchy ----------------------------------------------------
    @property
    def tree(self) -> HierarchyTree:
        """The hierarchy tree, materialized on first access and cached."""
        if self._tree is not None:
            return self._tree
        h = self.config.hierarchy
        if h == "none":
            raise ValueError(
                "this Decomposition was built with hierarchy='none'; "
                "re-run decompose() with hierarchy='fused' (or 'replay'/"
                "'two_phase'/'basic') to get a tree")
        if h in ("fused", "replay") and self._uf_parent is None:
            # replay defers the host LINK fixpoint until the tree is needed
            if self.problem is None or self._order_round is None:
                raise ValueError(
                    "cannot materialize the hierarchy: the join forest was "
                    "not computed and the peel trace / problem is not "
                    "available (serialize with to_json() *after* the tree "
                    "exists, or keep the NucleusProblem attached)")
            res = PeelResult(core=self._core, rounds=self._rounds,
                             order_round=self._order_round,
                             peel_value=self._peel_value)
            self._uf_parent, self._uf_L, self._link_stats = \
                forest_from_trace(self.problem, res)
        if h in ("fused", "replay"):
            state = link_state_from_forest(self._peel_value, self._uf_parent,
                                           self._uf_L)
            self._tree = construct_tree_efficient(self._problem_view(), state)
        elif h == "two_phase":
            self._tree = build_hierarchy_levels(self._require_problem(),
                                                self._core)
        elif h == "basic":
            self._tree = build_hierarchy_basic(self._require_problem(),
                                               self._core)
        return self._tree

    def _require_problem(self) -> NucleusProblem:
        if self.problem is None:
            raise ValueError(
                f"hierarchy={self.config.hierarchy!r} rebuilds the tree "
                "from the incidence structure, which a deserialized "
                "Decomposition does not carry; serialize with to_json() "
                "after the tree is materialized (to_json() does this) or "
                "keep the NucleusProblem attached")
        return self.problem

    class _TreeProblemView:
        """The construct-tree post-pass only reads ``n_r``."""

        def __init__(self, n_r: int):
            self.n_r = n_r

    def _problem_view(self):
        return self.problem if self.problem is not None \
            else self._TreeProblemView(self.n_r)

    def _r_clique_table(self) -> Optional[np.ndarray]:
        if self._r_cliques is not None:
            return self._r_cliques
        return None if self.problem is None \
            else self.problem.r_cliques.cpu().numpy()

    def _edge_table(self) -> Optional[np.ndarray]:
        if self._edges is not None:
            return self._edges
        return None if self.problem is None \
            else self.problem.g.edges.cpu().numpy()

    # -- queries -----------------------------------------------------------
    def cut(self, c: int) -> np.ndarray:
        """Label each r-clique with its c-(r, s) nucleus id (-1: core < c)."""
        c = int(c)
        if c not in self._cuts:
            self._cuts[c] = self.tree.ancestor_at_level(c)
        return self._cuts[c]

    def nuclei(self, c: int) -> Dict[int, Nucleus]:
        """The c-(r, s) nuclei as vertex sets + densities (Fig. 10)."""
        c = int(c)
        if c in self._nuclei:
            return self._nuclei[c]
        labels = self.cut(c)
        rc = self._r_clique_table()
        if rc is None:
            raise ValueError(
                "nucleus vertex sets need the r-clique table; this "
                "artifact was saved without its inputs: serialize it "
                "again with to_json() or keep the NucleusProblem attached")
        edges = self._edge_table()
        labs, counts = np.unique(labels[labels >= 0], return_counts=True)
        _, starts, verts = grouped_vertex_sets(rc, labels)
        sizes = np.diff(np.append(starts, verts.shape[0]))
        dens = grouped_densities(edges, sizes, verts) if edges is not None \
            else np.full((labs.shape[0],), np.nan)
        out = {lab: Nucleus(label=lab, vertices=v, n_r_cliques=k, density=d)
               for lab, v, k, d in zip(labs.tolist(),
                                       split_groups(verts, starts),
                                       counts.tolist(), dens.tolist())}
        self._nuclei[c] = out
        return out

    # -- incremental maintenance -------------------------------------------
    def update(self, delta, *, bucket_hook=None) -> "Decomposition":
        """Apply a ``GraphDelta`` (edge inserts/deletes) incrementally.

        Returns a NEW ``Decomposition`` for the edited graph: core, peel
        values, ``uf_parent``, the tree and every query are identical to a
        fresh ``decompose()`` of the edited graph, but only the affected
        neighborhood is recomputed (``core.streaming``, on the attached
        problem's device).  ``uf_L`` is the canonical chain multiset's, as
        the reference's ``update`` gives it: it can break a tie apart from
        the fused peel's.  ``self`` stays valid for the OLD graph.

        Exact method only, (r, s) in ``streaming.SUPPORTED_RS``, hierarchy
        'fused' or 'none', and the ``NucleusProblem`` must be attached.
        The result has no peel trace (``order_round=None``, ``rounds ==
        -1``) and carries an ``update_stats`` record.  ``bucket_hook``
        lets ``Session.update`` count the shape classes of the local
        stages.
        """
        from .streaming import update_decomposition
        new_dec, _stats = update_decomposition(self, delta,
                                               bucket_hook=bucket_hook)
        return new_dec

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        """Serialize the full artifact (deterministic, round-trip exact),
        in the reference's format: the same configuration gives the same
        bytes as ``repro``'s ``to_json()``.

        The tree is materialized first so a loaded Decomposition answers
        ``cut``/``nuclei`` without the incidence structure; the r-clique
        table + graph edges the nucleus/density queries need are embedded.
        """
        tree = self.tree if self.has_hierarchy else None
        d: Dict[str, Any] = {
            "format": JSON_FORMAT,
            "version": JSON_VERSION,
            "config": self.config.to_dict(),
            "n_r": self.n_r,
            "n_s": self._n_s if self._n_s is not None else (
                None if self.problem is None else self.problem.n_s),
            "n_vertices": self._n_vertices if self._n_vertices is not None
            else (None if self.problem is None else int(self.problem.g.n)),
            "rounds": self._rounds,
            "name": self._name,
            "live_version": self._version,
            "core": _ints(self._core),
            "order_round": _opt_ints(self._order_round),
            "peel_value": _ints(self._peel_value),
            "uf_parent": _opt_ints(self._uf_parent),
            "uf_L": _opt_ints(self._uf_L),
            "plan": None if self._plan is None else self._plan.to_dict(),
            "tree": None if tree is None else {
                "n_leaves": tree.n_leaves,
                "parent": _ints(tree.parent),
                "level": _ints(tree.level),
            },
        }
        rc = self._r_clique_table()
        ed = self._edge_table()
        d["r_cliques"] = None if rc is None else np.asarray(rc).tolist()
        d["edges"] = None if ed is None else np.asarray(ed).tolist()
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, blob: str) -> "Decomposition":
        """Load a serialized decomposition (of either package) for query
        serving.  The result has no ``NucleusProblem``; ``cut``/``nuclei``
        answer from the embedded tree + inputs, and ``to_json()``
        round-trips exactly."""
        d = json.loads(blob)
        if d.get("format") != JSON_FORMAT:
            raise ValueError(
                f"not a serialized Decomposition: format={d.get('format')!r}"
                f" (expected {JSON_FORMAT!r}) — this file was not written "
                f"by Decomposition.to_json(); regenerate the artifact with "
                f"decompose(...).save(path)")
        if d.get("version") not in SUPPORTED_JSON_VERSIONS:
            raise ValueError(
                f"unsupported Decomposition version {d.get('version')!r}: "
                f"this build reads versions {SUPPORTED_JSON_VERSIONS} and "
                f"writes {JSON_VERSION} — the artifact was written by a "
                f"different version; regenerate it with to_json()/save() "
                f"or upgrade the serving process")
        config = NucleusConfig.from_dict(d["config"])
        plan_d = d.get("plan")

        def arr(x):
            return None if x is None else np.asarray(x, np.int64)
        t = d.get("tree")
        tree = None if t is None else HierarchyTree(
            n_leaves=int(t["n_leaves"]),
            parent=np.asarray(t["parent"], np.int64),
            level=np.asarray(t["level"], np.int64))
        rc = d.get("r_cliques")
        ed = d.get("edges")
        return cls(config,
                   core=np.asarray(d["core"], np.int64),
                   rounds=int(d["rounds"]),
                   order_round=arr(d.get("order_round")),
                   peel_value=np.asarray(d["peel_value"], np.int64),
                   uf_parent=arr(d.get("uf_parent")),
                   uf_L=arr(d.get("uf_L")),
                   tree=tree,
                   r_cliques=None if rc is None
                   else np.asarray(rc, np.int64).reshape(-1, config.r),
                   edges=None if ed is None
                   else np.asarray(ed, np.int64).reshape(-1, 2),
                   n_vertices=d.get("n_vertices"),
                   n_s=d.get("n_s"),
                   plan=None if plan_d is None else Plan.from_dict(plan_d),
                   name=d.get("name"),
                   version=int(d.get("live_version", 0)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Decomposition":
        with open(path) as f:
            return cls.from_json(f.read())

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Decomposition(r={self.config.r}, s={self.config.s}, "
                f"method={self.config.method!r}, "
                f"backend={self.config.backend!r}, "
                f"hierarchy={self.config.hierarchy!r}, n_r={self.n_r}, "
                f"rounds={self._rounds}, "
                f"tree={'materialized' if self._tree is not None else 'lazy'})")


def _refuse_unported(config: NucleusConfig) -> None:
    """Raise before any build for a backend the port does not run yet."""
    if config.backend == "sharded":
        raise not_ported("backend='sharded'")


def resolve_problem(graph_or_problem, config: NucleusConfig,
                    device: DeviceLike = None
                    ) -> Tuple[NucleusProblem, NucleusConfig]:
    """Validate the config, then build the incidence structure from a
    ``Graph`` on `device`, or adopt a prebuilt ``NucleusProblem`` (its
    (r, s) wins) and move it there.

    Build upgrade, as the reference's: with ``backend='auto'``, a
    ``memory_budget_bytes`` and the default eager build, the estimated
    eager working set (``distbuild.estimate_eager_build_bytes``) is
    compared with the budget before the build runs; if it does not fit,
    the build is upgraded to 'chunked' (one device).  The arrays are
    bit-identical either way; the plan's reasons record the upgrade."""
    dev = resolve_device(device)
    if isinstance(graph_or_problem, NucleusProblem):
        problem = graph_or_problem.to(dev)
        if (problem.r, problem.s) != (config.r, config.s):
            config = dataclasses.replace(config, r=problem.r, s=problem.s)
        config.validate()
        _refuse_unported(config)
        return problem, config
    if not isinstance(graph_or_problem, Graph):
        raise TypeError(f"decompose() takes a Graph or a NucleusProblem, got "
                        f"{type(graph_or_problem).__name__}")
    config.validate()
    _refuse_unported(config)
    g = graph_or_problem.to(dev)
    estimate = None
    if config.backend == AUTO and config.build == "eager" and \
            config.memory_budget_bytes is not None:
        from ..distbuild import estimate_eager_build_bytes
        from .incidence import pick_rank
        dg, _ = pick_rank(g)
        estimate = estimate_eager_build_bytes(dg, config.s)
        if estimate > config.memory_budget_bytes:
            config = dataclasses.replace(config, build="chunked")
    problem = build_problem(g, config.r, config.s, build=config.build,
                            memory_budget_bytes=config.memory_budget_bytes,
                            chunk_size=config.build_chunk_size, device=dev)
    if estimate is not None:
        problem.build_stats = dict(problem.build_stats or {},
                                   eager_estimate_bytes=estimate)
    return problem, config


def plan_config(problem: NucleusProblem,
                config: NucleusConfig) -> Tuple[NucleusConfig, Plan]:
    """Resolve ``backend='auto'``/``hierarchy='auto'`` against ``problem``
    on its device.

    Returns the concrete, re-validated config plus the ``Plan`` decision
    record (explicit configs get a trivial plan).
    """
    stats = problem.build_stats or {}
    estimate = stats.get("eager_estimate_bytes")
    plan = backend_registry.resolve_plan(
        config, n_r=problem.n_r, n_s=problem.n_s, n_sub=problem.n_sub,
        device_kind=problem.device.type, n_devices=1,
        r=problem.r, s=problem.s, build=stats.get("build", config.build),
        eager_build_bytes=estimate)
    if estimate is not None and stats.get("build") == "chunked":
        plan = dataclasses.replace(plan, reasons=plan.reasons + (
            f"build 'chunked': estimated eager build working set "
            f"~{estimate} B exceeds memory_budget_bytes="
            f"{config.memory_budget_bytes} on one device "
            f"({stats.get('n_chunks')} chunks of "
            f"{stats.get('chunk_size')} source vertices, fast path "
            f"{stats.get('fastpath')})",))
    if (plan.backend, plan.hierarchy) != (config.backend, config.hierarchy):
        changes = dict(backend=plan.backend, hierarchy=plan.hierarchy)
        if config.backend == AUTO and config.build == "eager":
            # the budget only guided the planner: an eager build has no
            # use for it, and the resolved config must validate (the
            # reference raises here when the eager estimate fits)
            changes["memory_budget_bytes"] = None
        config = dataclasses.replace(config, **changes)
    config.validate()
    return config, plan


def execute_plan(problem: NucleusProblem, config: NucleusConfig,
                 plan: Plan) -> Decomposition:
    """Run an already-planned decomposition: registry lookup + dispatch."""
    res = backend_registry.get(config.backend).run(problem, config)
    return Decomposition(config, problem=problem, core=res.core,
                         rounds=res.rounds, order_round=res.order_round,
                         peel_value=res.peel_value, uf_parent=res.uf_parent,
                         uf_L=res.uf_L, plan=plan)


def decompose(graph_or_problem, config: Optional[NucleusConfig] = None, *,
              device: DeviceLike = None, **overrides) -> Decomposition:
    """THE entry point: run an (r, s) nucleus decomposition per ``config``.

    ``graph_or_problem`` is a ``Graph`` (the incidence structure is built
    here from ``config.r/s``) or a prebuilt ``NucleusProblem``.
    ``config`` defaults to ``NucleusConfig()``; keyword overrides apply on
    top, e.g. ``decompose(g, method="approx", delta=0.5)``.
    ``backend='auto'``/``hierarchy='auto'`` are resolved here by the
    registry planner; the decision is recorded on the result (``.plan``/
    ``plan_report()``) and serialized with it.  ``device=None`` means the
    card: without one this raises, naming ``device="cpu"``.
    """
    if config is None:
        config = NucleusConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    problem, config = resolve_problem(graph_or_problem, config, device)
    config, plan = plan_config(problem, config)
    return execute_plan(problem, config, plan)
