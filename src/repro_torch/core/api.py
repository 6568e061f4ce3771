"""The front door: ``decompose(graph, config) -> Decomposition``.

Counterpart of ``repro.core.api`` for this slice of the port: the dense
backend, exact or approx peeling, the fused hierarchy or none, the eager
build, one device.  ``Decomposition`` holds the results as host numpy
arrays and answers ``tree``/``cut(c)``/``nuclei(c)`` lazily with caching,
as the reference does.  Any configuration outside the slice raises
``ConfigError`` naming the value as not yet ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..graph.container import Graph
from .hierarchy import HierarchyTree
from .incidence import BUILDS, NucleusProblem, build_problem
from .interleaved import construct_tree_efficient, link_state_from_forest
from .nuclei import edge_densities, nucleus_vertex_sets
from .peel import approx_coreness, exact_coreness

METHODS = ("exact", "approx")
BACKENDS = ("dense",)
HIERARCHIES = ("fused", "none")
# values the reference accepts that this slice does not run yet
NOT_PORTED = {
    "backend": ("gather", "sharded", "nh", "auto"),
    "hierarchy": ("replay", "two_phase", "basic", "auto"),
    "build": ("chunked", "sharded"),
}


class ConfigError(ValueError):
    """An unsupported ``NucleusConfig`` value (raised by validate())."""


def _check_axis(axis: str, value, ported) -> None:
    if value in ported:
        return
    if value in NOT_PORTED.get(axis, ()):
        raise ConfigError(
            f"{axis}={value!r} is not yet ported to repro_torch; this slice "
            f"runs {axis} in {ported}")
    raise ConfigError(f"{axis}={value!r}; expected one of {ported}")


@dataclasses.dataclass(frozen=True)
class NucleusConfig:
    """Every axis of a nucleus decomposition this slice runs.

      r, s       — the (r, s) of the decomposition, 1 <= r < s.
      method     — "exact" or "approx" (Alg. 2, geometric buckets);
                   ``delta`` sets the approximation knob.
      backend    — "dense": the single-device peel engine.
      hierarchy  — "fused" (LINK fixpoint inside the peel) or "none".
      use_kernel — the reference's ``use_pallas``: True runs the round on
                   the hand-written kernels (on CPU tensors, their plain
                   versions), False on plain torch, and None (default)
                   resolves to True on CUDA and False on the CPU.
      build      — "eager": the one-burst incidence build.
    """

    r: int = 2
    s: int = 3
    method: str = "exact"
    delta: float = 0.1
    backend: str = "dense"
    hierarchy: str = "fused"
    use_kernel: Optional[bool] = None
    build: str = "eager"

    def validate(self) -> "NucleusConfig":
        if not 1 <= self.r < self.s:
            raise ConfigError(
                f"need 1 <= r < s, got (r, s) = ({self.r}, {self.s})")
        _check_axis("method", self.method, METHODS)
        _check_axis("backend", self.backend, BACKENDS)
        _check_axis("hierarchy", self.hierarchy, HIERARCHIES)
        _check_axis("build", self.build, BUILDS)
        if self.method == "approx" and not self.delta > 0:
            raise ConfigError(
                f"method='approx' needs delta > 0, got {self.delta}")
        return self


@dataclasses.dataclass(frozen=True)
class Nucleus:
    """One c-(r, s) nucleus: its vertex set + the Fig. 10 quality metric."""

    label: int
    vertices: np.ndarray   # sorted unique vertex ids
    n_r_cliques: int       # r-cliques carrying the nucleus
    density: float         # |E(S)| / C(|S|, 2)


class Decomposition:
    """The build-once/query-many artifact: coreness + hierarchy + queries.

    ``core``/``rounds``/``order_round``/``peel_value``/``uf_parent``/
    ``uf_L`` are computed by ``decompose()``; ``tree`` is built from the
    fused join forest on first access, and ``cut(c)``/``nuclei(c)`` are
    cached per level.
    """

    def __init__(self, config: NucleusConfig, *, problem: NucleusProblem,
                 core: np.ndarray, rounds: int,
                 order_round: np.ndarray, peel_value: np.ndarray,
                 uf_parent: Optional[np.ndarray] = None,
                 uf_L: Optional[np.ndarray] = None):
        self.config = config
        self.problem = problem
        self._core = np.asarray(core)
        self._rounds = int(rounds)
        self._order_round = np.asarray(order_round)
        self._peel_value = np.asarray(peel_value)
        self._uf_parent = None if uf_parent is None else np.asarray(uf_parent)
        self._uf_L = None if uf_L is None else np.asarray(uf_L)
        self._tree: Optional[HierarchyTree] = None
        self._cuts: Dict[int, np.ndarray] = {}
        self._nuclei: Dict[int, Dict[int, Nucleus]] = {}

    @property
    def core(self) -> np.ndarray:
        """(n_r,) core numbers (approx: clipped practical estimates)."""
        return self._core

    @property
    def rounds(self) -> int:
        """Peel rounds."""
        return self._rounds

    @property
    def order_round(self) -> np.ndarray:
        """(n_r,) round each r-clique peeled — the peel trace."""
        return self._order_round

    @property
    def peel_value(self) -> np.ndarray:
        """(n_r,) raw bucket values (unclipped) — what LINK equality saw."""
        return self._peel_value

    @property
    def uf_parent(self) -> Optional[np.ndarray]:
        """(n_r,) resolved ANH-EL union-find — the join forest."""
        return self._uf_parent

    @property
    def uf_L(self) -> Optional[np.ndarray]:
        """(n_r,) nearest-lower-core table of the join forest."""
        return self._uf_L

    @property
    def n_r(self) -> int:
        return int(self._core.shape[0])

    @property
    def has_hierarchy(self) -> bool:
        return self.config.hierarchy != "none"

    @property
    def tree(self) -> HierarchyTree:
        """The hierarchy tree, materialized on first access and cached."""
        if self._tree is None:
            if not self.has_hierarchy:
                raise ValueError(
                    "this Decomposition was built with hierarchy='none'; "
                    "re-run decompose() with hierarchy='fused' to get a tree")
            state = link_state_from_forest(self._peel_value, self._uf_parent,
                                           self._uf_L)
            self._tree = construct_tree_efficient(self, state)
        return self._tree

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
        rc = self.problem.r_cliques.cpu().numpy()
        edges = self.problem.g.edges.cpu().numpy()
        labs, cnts = np.unique(labels[labels >= 0], return_counts=True)
        counts = dict(zip(labs.tolist(), cnts.tolist()))
        sets = nucleus_vertex_sets(rc, labels)
        dens = edge_densities(edges, sets)
        out = {int(lab): Nucleus(label=int(lab), vertices=verts,
                                 n_r_cliques=int(counts[lab]),
                                 density=dens[int(lab)])
               for lab, verts in sets.items()}
        self._nuclei[c] = out
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Decomposition(r={self.config.r}, s={self.config.s}, "
                f"method={self.config.method!r}, "
                f"hierarchy={self.config.hierarchy!r}, n_r={self.n_r}, "
                f"rounds={self._rounds})")


def resolve_problem(graph_or_problem, config: NucleusConfig,
                    device: DeviceLike = None
                    ) -> Tuple[NucleusProblem, NucleusConfig]:
    """Validate the config, then build the incidence structure from a
    ``Graph`` on `device`, or adopt a prebuilt ``NucleusProblem`` (its
    (r, s) wins) and move it there."""
    dev = resolve_device(device)
    if isinstance(graph_or_problem, NucleusProblem):
        problem = graph_or_problem.to(dev)
        if (problem.r, problem.s) != (config.r, config.s):
            config = dataclasses.replace(config, r=problem.r, s=problem.s)
        config.validate()
        return problem, config
    if not isinstance(graph_or_problem, Graph):
        raise TypeError(f"decompose() takes a Graph or a NucleusProblem, got "
                        f"{type(graph_or_problem).__name__}")
    config.validate()
    problem = build_problem(graph_or_problem, config.r, config.s,
                            build=config.build, device=dev)
    return problem, config


def decompose(graph_or_problem, config: Optional[NucleusConfig] = None, *,
              device: DeviceLike = None, **overrides) -> Decomposition:
    """THE entry point: run an (r, s) nucleus decomposition per ``config``.

    ``graph_or_problem`` is a ``Graph`` (the incidence structure is built
    here from ``config.r/s``) or a prebuilt ``NucleusProblem``.
    ``config`` defaults to ``NucleusConfig()``; keyword overrides apply on
    top, e.g. ``decompose(g, method="approx", delta=0.5)``.  ``device=None``
    means the card: without one this raises, naming ``device="cpu"``.
    """
    if config is None:
        config = NucleusConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    dev = resolve_device(device)
    problem, config = resolve_problem(graph_or_problem, config, dev)
    fused = config.hierarchy == "fused"
    if config.method == "exact":
        res = exact_coreness(problem, device=dev,
                             use_kernel=config.use_kernel, hierarchy=fused)
    else:
        res = approx_coreness(problem, delta=config.delta, device=dev,
                              use_kernel=config.use_kernel, hierarchy=fused)

    def host(t):
        return None if t is None else t.cpu().numpy()
    return Decomposition(config, problem=problem, core=host(res.core),
                         rounds=res.rounds,
                         order_round=host(res.order_round),
                         peel_value=host(res.peel_value),
                         uf_parent=host(res.uf_parent) if fused else None,
                         uf_L=host(res.uf_L) if fused else None)
