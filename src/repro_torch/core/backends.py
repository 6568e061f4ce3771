"""Capability-declared backend registry + the auto-planner.

Counterpart of ``repro.core.backends``.  Every peel backend is a
registered ``Backend``: a name, a declarative ``BackendCapabilities``
record, and ``run(problem, config) -> BackendResult``.  The registry is the
single source of backend truth:

  * ``NucleusConfig.validate()`` derives the legality matrix from the
    capability declarations (``check_capabilities``), so the 29 legal
    (method, backend, hierarchy) triples, the error messages and
    ``legal_combinations()`` are the reference's;
  * ``decompose()`` dispatches by registry lookup (``get``);
  * ``resolve_plan`` is the ``backend="auto"`` / ``hierarchy="auto"``
    planner: it filters the registry down to capability-compatible
    candidates, then picks by device kind, problem size and
    ``memory_budget_bytes``.  The resolved ``Plan`` (requested vs resolved
    + reasons) rides on every ``Decomposition`` and its ``to_json()``.

The four backends are registered in the reference's order and with its
capabilities: ``dense`` (the peel engine on the device; fast lane
``"kcore"`` at (1, 2)), ``gather`` (the eager work-efficient loop),
``sharded`` and ``nh`` (the sequential exact baseline).  ``sharded`` stays
registered so the matrix is the reference's, but its run raises
``ConfigError``: the sharded backend is ROADMAP Queue 1.9.

Capability semantics (how legality is derived):

  * ``hierarchy='fused'`` is legal iff the backend runs its peel as one
    engine loop the LINK fixpoint rides in (``compiled_peel``);
  * ``hierarchy='replay'`` is legal iff the backend records the peel trace
    the host replay consumes (``records_trace``);
  * ``'none'``/``'two_phase'``/``'basic'`` need only core numbers;
  * the device knobs (``use_kernel`` as "pallas", ``mesh``,
    ``compress``) are legal iff the backend lists them in ``knobs``.

Import-light: backend implementations are imported inside the ``run``
adapters.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from . import planner_profile
from .incidence import NucleusProblem

METHODS = ("exact", "approx")
HIERARCHIES = ("none", "fused", "replay", "two_phase", "basic")
AUTO = "auto"


class ConfigError(ValueError):
    """An unsupported ``NucleusConfig`` combination (caught at validate())."""


def not_ported(what: str, queue: str = "1.9") -> ConfigError:
    """The error for a reference feature the port does not run yet."""
    return ConfigError(f"{what} is not yet ported to repro_torch (ROADMAP "
                       f"Queue {queue})")


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend declares it can do — legality is derived from this.

    ``methods``: peel schedules the backend runs ("exact"/"approx").
    ``compiled_peel``: the peel is one engine loop the LINK fixpoint can
        ride in (``hierarchy='fused'`` legal).
    ``records_trace``: the backend returns the peel trace
        (``order_round``), so host replay can rebuild the forest
        (``hierarchy='replay'`` legal).
    ``knobs``: device knobs the backend honours ("pallas" is the port's
        ``use_kernel``; "mesh"/"compress").
    ``fast_lanes``: special-case engine lanes the backend routes to by
        itself ("kcore": the r1s2 vertex-degree peel with the one-shot
        edge-list link fixpoint), declared so the planner records the
        routing in ``Plan.reasons``; legality is unaffected.
    ``summary``: one-line description, quoted in derived error messages
        and ``plan_report()``.
    """

    methods: Tuple[str, ...]
    compiled_peel: bool
    records_trace: bool
    knobs: frozenset
    summary: str
    fast_lanes: Tuple[str, ...] = ()

    @property
    def hierarchies(self) -> Tuple[str, ...]:
        """Supported hierarchy strategies, derived — not hand-listed."""
        return tuple(h for h in HIERARCHIES
                     if (h != "fused" or self.compiled_peel)
                     and (h != "replay" or self.records_trace))


@dataclasses.dataclass(frozen=True)
class BackendResult:
    """What ``Backend.run`` returns: host numpy arrays + a Python int.

    Optional fields are None exactly when the capabilities say the backend
    does not produce them (``order_round``/``peel_value`` need
    ``records_trace``; ``uf_parent``/``uf_L`` need a fused hierarchy).
    """

    core: np.ndarray
    rounds: int
    order_round: Optional[np.ndarray] = None
    peel_value: Optional[np.ndarray] = None
    uf_parent: Optional[np.ndarray] = None
    uf_L: Optional[np.ndarray] = None


@runtime_checkable
class Backend(Protocol):
    """The registry entry contract (structural — see ``_Registered``)."""

    name: str
    capabilities: BackendCapabilities

    def run(self, problem: NucleusProblem, config) -> BackendResult:
        ...


@dataclasses.dataclass(frozen=True)
class _Registered:
    name: str
    capabilities: BackendCapabilities
    _run: Callable[[NucleusProblem, Any], BackendResult]

    def run(self, problem: NucleusProblem, config) -> BackendResult:
        return self._run(problem, config)


_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Register a backend (insertion order defines enumeration order)."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ConfigError(
            f"backend={name!r}; expected one of {names()} (or 'auto')")


def all_backends() -> Tuple[Backend, ...]:
    return tuple(_REGISTRY.values())


# ---------------------------------------------------------------------------
# Capability-derived validation: the only place config x backend legality
# lives.  Messages are rule templates formatted with registry-derived
# alternatives.
# ---------------------------------------------------------------------------

_HIERARCHY_RULES = {
    "fused": (
        "compiled_peel",
        "hierarchy='fused' runs the LINK fixpoint inside the compiled peel "
        "loop, but backend={backend!r} has no compiled loop to fuse into; "
        "use hierarchy='replay' (same forest, host fixpoint) or one of "
        "backend={alts}"),
    "replay": (
        "records_trace",
        "hierarchy='replay' rebuilds the forest from the recorded peel "
        "trace, which backend={backend!r} does not return; use "
        "hierarchy='fused' (forest computed in the same loop) or "
        "'two_phase', or one of backend={alts}"),
}

_KNOB_RULES = {
    "pallas": (
        lambda cfg: bool(cfg.use_kernel),
        "use_kernel=True selects the hand-written round kernels of the "
        "dense engine; backend={backend!r} never runs them — use one of "
        "backend={alts} or drop use_kernel"),
    "compress": (
        lambda cfg: bool(cfg.compress),
        "compress=True (int16 + error-feedback delta all-reduce) only "
        "applies to a sharded collective, which backend={backend!r} does "
        "not run; use one of backend={alts} or drop compress"),
    "mesh": (
        lambda cfg: cfg.mesh is not None,
        "a mesh only applies to one of backend={alts}, got "
        "backend={backend!r}"),
}


def _hierarchy_supported(caps: BackendCapabilities, hierarchy: str) -> bool:
    rule = _HIERARCHY_RULES.get(hierarchy)
    return rule is None or getattr(caps, rule[0])


def _method_alts(method: str) -> Tuple[str, ...]:
    return tuple(b.name for b in all_backends()
                 if method in b.capabilities.methods)


def check_capabilities(config) -> None:
    """Raise ConfigError iff ``config`` asks a backend for something its
    capability declaration rules out.  ``backend='auto'`` defers the
    per-backend checks to the planner but still requires at least one
    capability-compatible candidate to exist."""
    if config.backend == AUTO:
        if not candidate_backends(config):
            raise ConfigError(
                f"backend='auto': no registered backend supports "
                f"method={config.method!r} with "
                f"hierarchy={config.hierarchy!r} and the requested knobs "
                f"(use_kernel={config.use_kernel}, "
                f"mesh={'set' if config.mesh is not None else None}, "
                f"compress={config.compress}); registered: {names()}")
        return
    caps = get(config.backend).capabilities
    if config.method not in caps.methods:
        raise ConfigError(
            f"backend={config.backend!r} is {caps.summary} — "
            f"method={config.method!r} needs one of "
            f"backend={_method_alts(config.method)}")
    if config.hierarchy != AUTO and \
            not _hierarchy_supported(caps, config.hierarchy):
        attr, template = _HIERARCHY_RULES[config.hierarchy]
        alts = tuple(b.name for b in all_backends()
                     if getattr(b.capabilities, attr))
        raise ConfigError(template.format(backend=config.backend, alts=alts))
    for knob, (is_set, template) in _KNOB_RULES.items():
        if is_set(config) and knob not in caps.knobs:
            alts = tuple(b.name for b in all_backends()
                         if knob in b.capabilities.knobs)
            raise ConfigError(
                template.format(backend=config.backend, alts=alts))


# ---------------------------------------------------------------------------
# The auto-planner: backend="auto" / hierarchy="auto" resolution
# ---------------------------------------------------------------------------

# Decision thresholds, as in the reference.  TINY_NR: below this, the eager
# gather loop beats the dense engine's full passes on the CPU.
# SHARD_MIN_INCIDENCE: incidence entries before slicing the s-clique axis
# across devices pays.  DENSE_ROUND_BYTES_PER_ENTRY: the dense engine
# touches the whole (n_s, C) incidence plus two views of it every round
# (~3 int32 reads); past memory_budget_bytes the gather backend, which
# touches only incident s-cliques, is preferred.  TINY_NR and
# SHARD_MIN_INCIDENCE are the static fallbacks of ``planner_profile``.
TINY_NR = planner_profile.STATIC_TINY_NR
SHARD_MIN_INCIDENCE = planner_profile.STATIC_SHARD_MIN_INCIDENCE
DENSE_ROUND_BYTES_PER_ENTRY = 12


@dataclasses.dataclass(frozen=True)
class Plan:
    """The planner's decision record: requested vs resolved + why.

    Attached to every ``Decomposition`` (explicit configs get a trivial
    plan) and embedded in ``to_json()``."""

    backend: str
    hierarchy: str
    requested_backend: str
    requested_hierarchy: str
    reasons: Tuple[str, ...] = ()

    @property
    def was_auto(self) -> bool:
        return AUTO in (self.requested_backend, self.requested_hierarchy)

    def report(self) -> str:
        """Human-readable resolution report."""
        lines = [
            f"plan: backend={self.backend!r} hierarchy={self.hierarchy!r}"
            f" (requested backend={self.requested_backend!r}"
            f" hierarchy={self.requested_hierarchy!r})"]
        lines += [f"  - {r}" for r in self.reasons]
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"backend": self.backend, "hierarchy": self.hierarchy,
                "requested_backend": self.requested_backend,
                "requested_hierarchy": self.requested_hierarchy,
                "reasons": list(self.reasons)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Plan":
        missing = [k for k in ("backend", "hierarchy", "requested_backend",
                               "requested_hierarchy") if k not in d]
        if missing:
            raise ValueError(
                f"malformed Decomposition plan: missing {missing} in {d!r} "
                f"— the artifact was truncated or hand-edited; regenerate "
                f"it with to_json()/save()")
        return cls(backend=d["backend"], hierarchy=d["hierarchy"],
                   requested_backend=d["requested_backend"],
                   requested_hierarchy=d["requested_hierarchy"],
                   reasons=tuple(d.get("reasons", ())))


def candidate_backends(config) -> List[Backend]:
    """Registry entries whose capabilities satisfy every explicit axis of
    ``config`` (registry order is the tiebreak order)."""
    out = []
    for b in all_backends():
        caps = b.capabilities
        if config.method not in caps.methods:
            continue
        if config.hierarchy != AUTO and \
                not _hierarchy_supported(caps, config.hierarchy):
            continue
        if any(is_set(config) and knob not in caps.knobs
               for knob, (is_set, _t) in _KNOB_RULES.items()):
            continue
        out.append(b)
    return out


def resolve_plan(config, *, n_r: int, n_s: int, n_sub: int,
                 device_kind: Optional[str] = None,
                 n_devices: Optional[int] = None,
                 r: Optional[int] = None, s: Optional[int] = None,
                 profile_path: Optional[str] = None,
                 build: Optional[str] = None,
                 eager_build_bytes: Optional[int] = None) -> Plan:
    """Resolve ``backend='auto'`` / ``hierarchy='auto'`` to concrete axes.

    Problem facts come in as plain ints so the rules are unit-testable;
    ``decompose()`` passes them from the built problem and the device facts
    from the resolved torch device: ``device_kind`` is its type ("cuda" or
    "cpu"; None: "cuda" when a card is present) and ``n_devices`` is 1
    until the sharded backend is ported.  The rules, in priority order (as
    the reference's):

      1. an explicit backend is kept as-is;
      2. knobs bind: ``mesh``/``compress`` force the sharded collective,
         ``use_kernel=True`` the dense engine;
      2b. build facts bind: a sharded build, or an eager build estimate
         over ``memory_budget_bytes``, on several devices -> sharded;
      3. several devices + enough incidence work -> sharded;
      4. a ``memory_budget_bytes`` under the dense engine's per-round
         working set -> gather;
      5. an accelerator -> dense;
      6. CPU: tiny problems (below ``tiny_nr``) -> gather, else dense.

    Thresholds come from the planner profile entry for the device kind,
    else the static constants; the reasons record which.  ``hierarchy=
    'auto'`` then picks the richest strategy the resolved backend
    supports: fused > replay > two_phase.  At (r, s) = (1, 2) on a backend
    declaring the "kcore" lane, the reasons record whether the peel takes
    it (it does unless ``use_kernel=True``).
    """
    reasons: List[str] = []
    cands = candidate_backends(config)
    if not cands:
        check_capabilities(config)          # raises with the derived message
        raise ConfigError("no capability-compatible backend")  # unreachable
    cand_names = [b.name for b in cands]

    if config.backend != AUTO:
        backend = config.backend
        reasons.append(f"backend {backend!r}: explicitly configured")
    else:
        if device_kind is None:
            device_kind = "cuda" if torch.cuda.is_available() else "cpu"
        if n_devices is None:
            n_devices = 1
        prof = planner_profile.thresholds(device_kind=device_kind,
                                          platform=device_kind,
                                          path=profile_path)
        tiny_nr = prof["tiny_nr"]
        shard_min = prof["shard_min_incidence"]
        prof_src = prof["source"]
        reasons.append(
            f"thresholds: tiny_nr={tiny_nr}, "
            f"shard_min_incidence={shard_min} ({prof_src})")
        budget = config.memory_budget_bytes
        dense_round_bytes = DENSE_ROUND_BYTES_PER_ENTRY * n_s * n_sub

        def pick(name, why):
            if name in cand_names:
                reasons.append(f"backend {name!r}: {why}")
                return name
            return None

        backend = None
        if config.mesh is not None:
            backend = pick("sharded", "a mesh was supplied")
        if backend is None and config.compress:
            backend = pick("sharded",
                           "compress=True implies the sharded collective")
        if backend is None and config.use_kernel:
            backend = pick("dense", "use_kernel=True selects the dense "
                                    "engine's hand-written round kernels")
        if backend is None and n_devices > 1 and build == "sharded":
            backend = pick(
                "sharded",
                f"the incidence structure was built sharded over "
                f"{n_devices} devices; the peel partitions the same "
                f"s-clique slabs")
        if backend is None and n_devices > 1 and budget is not None and \
                eager_build_bytes is not None and eager_build_bytes > budget:
            backend = pick(
                "sharded",
                f"estimated eager build working set ~{eager_build_bytes} B "
                f"exceeds memory_budget_bytes={budget} on {n_devices} "
                f"devices: shard the build and the peel together")
        if backend is None and n_devices > 1 and \
                n_s * n_sub >= shard_min:
            backend = pick(
                "sharded",
                f"{n_devices} devices and {n_s * n_sub} incidence entries "
                f">= {shard_min} ({prof_src}): partition the s-clique axis")
        if backend is None and budget is not None and \
                dense_round_bytes > budget:
            backend = pick(
                "gather",
                f"dense per-round working set ~{dense_round_bytes} B "
                f"exceeds memory_budget_bytes={budget}; the gather "
                f"backend touches only incident s-cliques per round")
        if backend is None and device_kind != "cpu":
            backend = pick("dense", f"accelerator ({device_kind}): the "
                                    f"dense engine on the hand-written "
                                    f"round kernels is the fast path")
        if backend is None and n_r < tiny_nr:
            backend = pick(
                "gather",
                f"tiny problem (n_r={n_r} < {tiny_nr}, {prof_src}) on "
                f"cpu: the eager work-efficient loop beats the dense "
                f"engine's passes over the whole incidence table")
        if backend is None:
            backend = pick("dense", f"cpu default (n_r={n_r}): the dense "
                                    f"engine's fixed-shape rounds beat the "
                                    f"gather loop's per-round compactions")
        if backend is None:             # preferred pick filtered by caps
            backend = cand_names[0]
            reasons.append(
                f"backend {backend!r}: first capability-compatible "
                f"candidate (preferred picks excluded by the requested "
                f"method/hierarchy/knobs)")

    caps = get(backend).capabilities
    if (r, s) == (1, 2) and "kcore" in caps.fast_lanes:
        from .kcore import takes_kcore_lane
        if takes_kcore_lane(r, s, config.use_kernel):
            reasons.append(
                f"fast lane 'kcore': (r, s) = (1, 2) on backend "
                f"{backend!r} — vertex-degree peel with the one-shot "
                f"edge-list link fixpoint, no incidence-table indirection")
        else:
            reasons.append(
                f"fast lane 'kcore' not taken: use_kernel=True pins the "
                f"generic engine on the peel-round megakernel at (r, s) = "
                f"(1, 2) on backend {backend!r}")
    if config.hierarchy != AUTO:
        hierarchy = config.hierarchy
        reasons.append(f"hierarchy {hierarchy!r}: explicitly configured")
    elif caps.compiled_peel:
        hierarchy = "fused"
        reasons.append("hierarchy 'fused': the resolved backend has a "
                       "compiled peel loop to fuse the LINK fixpoint into")
    elif caps.records_trace:
        hierarchy = "replay"
        reasons.append("hierarchy 'replay': the resolved backend records "
                       "the peel trace the host LINK replay consumes")
    else:
        hierarchy = "two_phase"
        reasons.append("hierarchy 'two_phase': the resolved backend "
                       "returns only core numbers, so the tree is built "
                       "by the two-phase (ANH-TE) post-pass")
    return Plan(backend=backend, hierarchy=hierarchy,
                requested_backend=config.backend,
                requested_hierarchy=config.hierarchy,
                reasons=tuple(reasons))


# ---------------------------------------------------------------------------
# The four backends.  Implementations are imported lazily.
# ---------------------------------------------------------------------------

def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _run_local(problem: NucleusProblem, config, backend: str,
               **peel_kw) -> BackendResult:
    from .peel import approx_coreness, exact_coreness
    fused = config.hierarchy == "fused"
    if config.method == "exact":
        res = exact_coreness(problem, backend=backend, hierarchy=fused,
                             device=problem.device, **peel_kw)
    else:
        res = approx_coreness(problem, delta=config.delta, backend=backend,
                              hierarchy=fused, device=problem.device,
                              **peel_kw)
    return BackendResult(
        core=_host(res.core), rounds=int(res.rounds),
        order_round=_host(res.order_round),
        peel_value=_host(res.peel_value),
        uf_parent=_host(res.uf_parent) if fused else None,
        uf_L=_host(res.uf_L) if fused else None)


def _run_dense(problem: NucleusProblem, config) -> BackendResult:
    return _run_local(problem, config, "dense", use_kernel=config.use_kernel)


def _run_gather(problem: NucleusProblem, config) -> BackendResult:
    return _run_local(problem, config, "gather")


def _run_sharded(problem: NucleusProblem, config) -> BackendResult:
    raise not_ported("backend='sharded'")


def _run_nh(problem: NucleusProblem, config) -> BackendResult:
    from .nh_baseline import nh_coreness
    core, rho = nh_coreness(problem)
    return BackendResult(core=np.asarray(core), rounds=int(rho))


register(_Registered(
    name="dense",
    capabilities=BackendCapabilities(
        methods=("exact", "approx"), compiled_peel=True, records_trace=True,
        knobs=frozenset({"pallas"}),
        summary="the single-device peel engine on the device",
        fast_lanes=("kcore",)),
    _run=_run_dense))

register(_Registered(
    name="gather",
    capabilities=BackendCapabilities(
        methods=("exact", "approx"), compiled_peel=False, records_trace=True,
        knobs=frozenset(),
        summary="the eager work-efficient host loop"),
    _run=_run_gather))

register(_Registered(
    name="sharded",
    capabilities=BackendCapabilities(
        methods=("exact", "approx"), compiled_peel=True, records_trace=False,
        knobs=frozenset({"mesh", "compress"}),
        summary="the distributed engine (not yet ported)"),
    _run=_run_sharded))

register(_Registered(
    name="nh",
    capabilities=BackendCapabilities(
        methods=("exact",), compiled_peel=False, records_trace=False,
        knobs=frozenset(),
        summary="the sequential exact baseline; it has no approximate "
                "bucket schedule"),
    _run=_run_nh))

BACKENDS = names()
