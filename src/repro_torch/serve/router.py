"""Plan-aware request routing: one ``Session`` pool per config class.

Counterpart of ``repro.serve.router``.  Tenants submit different graphs
under different (r, s)/method/hierarchy axes; the ``Router`` keeps them
apart where they must be and together where they can be:

  * **Pool keying.**  Each request's config axes are *canonicalized* (axes
    the engine never reads are pinned to defaults, e.g. ``delta`` under
    ``method='exact'``) and the canonical config keys a pool: one warm
    ``Session``, whose pow2 shape buckets group similar graphs further.
  * **Introspection.**  Per pool the router reports the embedded ``Plan``
    of the last decomposition, the warm/cold hit rates out of
    ``Session.stats`` and the tracked shape buckets; ``serve.status``
    serializes this next to the queue and admission counters.

Named live artifacts ride the same pools: ``route()`` publishes a
decomposition under ``Request.artifact``, ``update()`` applies a
``GraphDelta`` through ``Session.update`` and re-publishes the successor
under the same name with ``version + 1``.  Every pool runs on the router's
``device`` (``None``: the card); a sharded pool runs on its config's
``mesh`` (``None``: every visible card), so ``pool(config)`` with a mesh
opens the pool that requests of that class then reach.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core.api import Decomposition, NucleusConfig, resolve_problem
from ..core.incidence import NucleusProblem
from ..core.session import Session
from ..core.streaming import GraphDelta
from ..device import DeviceLike, resolve_device

# config defaults the canonicalizer pins dead axes back to
_DEFAULTS = NucleusConfig()


@dataclasses.dataclass
class Request:
    """One unit of routed work.

    ``graph`` is a ``Graph`` or prebuilt ``NucleusProblem`` (decompose
    requests); ``update`` is a ``GraphDelta`` against the named live
    artifact ``artifact`` (update requests; ``graph`` is then None).
    ``artifact`` on a decompose request publishes the result under that
    name.  ``use_kernel`` is the reference's ``use_pallas``."""

    graph: Any = None
    r: int = 2
    s: int = 3
    method: str = "exact"
    hierarchy: str = "fused"
    backend: str = "dense"
    delta: float = 0.1
    use_kernel: Optional[bool] = None
    build: str = "eager"
    build_shards: Optional[int] = None
    memory_budget_bytes: Optional[int] = None
    artifact: str = ""
    update: Optional[GraphDelta] = None

    @property
    def kind(self) -> str:
        return "update" if self.update is not None else "decompose"

    def config(self) -> NucleusConfig:
        return NucleusConfig(r=self.r, s=self.s, method=self.method,
                             hierarchy=self.hierarchy, backend=self.backend,
                             delta=self.delta, use_kernel=self.use_kernel,
                             build=self.build, build_shards=self.build_shards,
                             memory_budget_bytes=self.memory_budget_bytes)


def canonical_config(config: NucleusConfig) -> NucleusConfig:
    """Pin axes the engine never reads, so near-identical tenants share one
    pool: ``delta`` only matters under ``method='approx'``."""
    if config.method == "exact" and config.delta != _DEFAULTS.delta:
        config = dataclasses.replace(config, delta=_DEFAULTS.delta)
    return config


def pool_key(config: NucleusConfig) -> Tuple:
    """Hashable identity of a canonical config (the mesh, a process-local
    handle, is excluded by ``to_dict``)."""
    return tuple(sorted(canonical_config(config).to_dict().items(),
                        key=lambda kv: kv[0]))


class Router:
    """Route heterogeneous requests through per-config ``Session`` pools.

    Thread-safety: pool creation, artifact publication and all bookkeeping
    are lock-guarded, but engine work (decompose/update) is expected to be
    single-writer: the ``Frontend`` drains its queue from one worker
    thread, which is the only thread that runs CUDA work.
    """

    def __init__(self, *, bucket_floor: Optional[int] = None,
                 bucket_cap: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._session_kw: Dict[str, int] = {}
        if bucket_floor is not None:
            self._session_kw["bucket_floor"] = int(bucket_floor)
        if bucket_cap is not None:
            self._session_kw["bucket_cap"] = int(bucket_cap)
        self._lock = threading.Lock()
        self._pools: Dict[Tuple, Session] = {}
        self._last_plan: Dict[Tuple, Any] = {}
        # pool -> build_stats of the last decomposition whose problem
        # carried them (how the incidence structure was built)
        self._last_build: Dict[Tuple, Dict[str, Any]] = {}
        # name -> (artifact, pool_key); versions live on the artifact
        self._artifacts: Dict[str, Tuple[Decomposition, Tuple]] = {}

    # -- pools -------------------------------------------------------------
    def pool(self, config: NucleusConfig) -> Session:
        """The warm Session serving ``config``'s canonical class (created
        on first use)."""
        key = pool_key(config)
        with self._lock:
            sess = self._pools.get(key)
            if sess is None:
                sess = Session(canonical_config(config), device=self.device,
                               **self._session_kw)
                self._pools[key] = sess
            return sess

    def resolve(self, request: Request
                ) -> Tuple[NucleusProblem, NucleusConfig]:
        """Build/adopt the request's problem under its canonical config on
        the router's device (the ``Frontend`` worker runs it for
        admission)."""
        if request.kind != "decompose":
            raise ValueError("resolve() is for decompose requests; "
                             "updates address a named artifact")
        return resolve_problem(request.graph,
                               canonical_config(request.config()),
                               self.device)

    # -- routed work -------------------------------------------------------
    def route(self, request: Request) -> Decomposition:
        """Execute one request on its pool: decompose (publishing under
        ``request.artifact`` if named) or update a named live artifact."""
        if request.kind == "update":
            return self.update(request.artifact, request.update)
        problem, config = self.resolve(request)
        sess = self.pool(config)
        dec = sess.decompose(problem)
        self._record(config, dec, request.artifact)
        return dec

    def route_many(self, requests: List[Request],
                   problems: Optional[List[NucleusProblem]] = None
                   ) -> List[Decomposition]:
        """Same-pool batch: ``requests`` must share one canonical config.
        Prebuilt ``problems`` (from the admission's ``resolve``) skip a
        rebuild."""
        if not requests:
            return []
        config = canonical_config(requests[0].config())
        key = pool_key(config)
        for req in requests[1:]:
            if pool_key(canonical_config(req.config())) != key:
                raise ValueError("route_many() requires same-pool requests"
                                 " — coalesce by pool first")
        sess = self.pool(config)
        if problems is None:
            problems = [self.resolve(r)[0] for r in requests]
        decs = sess.decompose_many(problems)
        for req, dec in zip(requests, decs):
            self._record(config, dec, req.artifact)
        return decs

    def _record(self, config: NucleusConfig, dec: Decomposition,
                artifact: str) -> None:
        key = pool_key(config)
        with self._lock:
            if dec.plan is not None:
                self._last_plan[key] = dec.plan
            if dec.problem is not None and dec.problem.build_stats:
                self._last_build[key] = dict(dec.problem.build_stats)
            if artifact:
                dec.name = artifact
                self._artifacts[artifact] = (dec, key)

    # -- named live artifacts ----------------------------------------------
    def artifact(self, name: str) -> Decomposition:
        with self._lock:
            entry = self._artifacts.get(name)
        if entry is None:
            raise KeyError(
                f"no live artifact named {name!r}; publish one by routing "
                f"a decompose request with artifact={name!r}")
        return entry[0]

    def update(self, name: str, delta: GraphDelta) -> Decomposition:
        """Advance the named artifact one edit generation through its
        pool's ``Session.update``; the successor replaces it."""
        with self._lock:
            entry = self._artifacts.get(name)
        if entry is None:
            raise KeyError(
                f"no live artifact named {name!r} to update; publish it "
                f"first (decompose with artifact={name!r})")
        dec, key = entry
        with self._lock:
            sess = self._pools[key]
        new = sess.update(dec, delta)
        new.name = name
        with self._lock:
            self._artifacts[name] = (new, key)
        return new

    # -- introspection -----------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Per-pool plan, hit rates and buckets, per-artifact versions: the
        router's slice of the status surface."""
        with self._lock:
            pools = list(self._pools.items())
            plans = dict(self._last_plan)
            builds = dict(self._last_build)
            artifacts = dict(self._artifacts)

        def bucket_row(sess: Session, k: Tuple, v: int) -> Dict[str, Any]:
            # decompose/sharded buckets carry shape-class meta; everything
            # else is a stream-stage key (see Session._bucket_hit)
            kind = sess._bucket_meta.get(k, {}).get("kind")
            if kind == "decompose":
                return {"n_r_pad": k[4], "n_s_pad": k[5], "count": int(v)}
            if kind == "sharded":
                return {"n_r_pad": k[4], "n_s_pad": k[5],
                        "shards": int(k[8]), "count": int(v)}
            return {"stream_stage": str(k[0]), "count": int(v)}

        pool_rows = []
        for key, sess in pools:
            with sess._stats_lock:
                stats = {k: v for k, v in sess.stats.items()
                         if k != "buckets"}
                buckets = [bucket_row(sess, k, v)
                           for k, v in sess.stats["buckets"].items()]
            warm, cold = stats["warm"], stats["cold"]
            plan = plans.get(key)
            pool_rows.append({
                "config": sess.config.to_dict(),
                "plan": None if plan is None else plan.to_dict(),
                "stats": stats,
                "hit_rate": warm / max(warm + cold, 1),
                "buckets": buckets,
                "build": builds.get(key),
            })
        artifact_rows = {
            name: {"version": dec.version, "n_r": dec.n_r,
                   "r": dec.config.r, "s": dec.config.s}
            for name, (dec, _key) in artifacts.items()}
        return {"pools": pool_rows, "artifacts": artifact_rows}
