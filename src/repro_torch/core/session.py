"""Warm ``Session``: decompose many graphs, counted by pow2 shape buckets.

Counterpart of ``repro.core.session``.  A serving process decomposes a
stream of similar graphs; ``Session`` is its front door:

  * **Shape buckets.**  Each problem lands in a shape class (``n_r``/``n_s``
    rounded up to the next power of two, floor ``bucket_floor``).
  * **Schedule canonicalization.**  Exact schedules never read the vertex
    count ``n`` (pinned to 1); approximate schedules read it only through
    ``cap()``, so ``n`` is replaced by the smallest vertex count with the
    same cap: same behaviour, one schedule per (delta, C, cap) class.
  * **Bucket bookkeeping.**  ``stats`` tallies warm and cold calls and the
    per-bucket hit counts (an LRU bounded by ``bucket_cap``), and
    ``manifest``/``prewarm`` carry the seen buckets across a restart.

Where the port departs from the reference:

  * **No padding.**  The reference pads each problem to its bucket (ghost
    s-rows, pre-peeled ghost r-cliques) so one compiled executable serves
    the whole shape class.  A CUDA kernel has no per-shape executable:
    padding would only add work (a pow2 incidence table and link state),
    and the real prefix of the padded run is bit-identical to the unpadded
    one.  So every call runs ``execute_plan``, the same path as
    ``decompose()``, and the bucket is bookkeeping: the reference's key,
    counters and gate, so a stream gives the reference's warm, cold and
    fallback counts.
  * **The bucket key has no ``ScatterSpec``.**  The reference keys its
    Pallas buckets on the segment-sum tiles and a chunk-span bound.  The
    port's megakernel is a CSR kernel with no tiles, so the key's kernel
    field is the reference's padded plan edge length
    ``e_pad = bucket_size(n_s * C, PLAN_EDGE_FLOOR)`` (None when the kernel
    is off).  The key stays shape-only and builds no plan arrays.  The
    gate is the reference's, ``4 * e_pad * C <= MEGAKERNEL_PLAN_BUDGET_BYTES``
    (else the call counts as a fallback), and ``serve.frontend`` admits
    requests by the same bytes.
  * **Dense (1, 2) pools take the k-core lane**, as the port's
    ``decompose`` does (``kcore.takes_kcore_lane``; the plan's reasons
    record it).
  * **The manifest** has its own format, ``"repro_torch.session-manifest"``,
    because its bucket records carry ``e_pad`` in place of a
    ``ScatterSpec``; a reference manifest is refused.
  * **Sharded pools** run ``execute_plan`` on the sharded backend, unpadded
    like the dense ones.  Their bucket is the reference's: ``shards`` is
    the mesh's length and ``n_s_pad`` the shard-multiple class
    (``shard_bucket_size``); kind ``"sharded"`` keeps them out of the
    manifest, so a restarted server warms them on first traffic.

The kernels are built once per process (and loaded from the build cache
across restarts, ``serve.cache.init_persistent_cache``); ``prewarm`` launches
the pool's kernel once, which loads the library, and registers the buckets.
"""
from __future__ import annotations

import dataclasses
import threading
from math import comb
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..graph.container import INT
from ..kernels.peel_round import PEELED, fused_peel_round
from ..kernels.segment_sum import segment_sum
from .api import (Decomposition, NucleusConfig, execute_plan, mesh_size,
                  plan_config, resolve_problem)
from .engine import MEGAKERNEL_PLAN_BUDGET_BYTES, kernel_by_default
from .incidence import NucleusProblem
from .kcore import takes_kcore_lane
from .schedule import PeelSchedule

DEFAULT_BUCKET_FLOOR = 64
# default LRU bound on stats["buckets"]: generous for real serving mixes
# while keeping a long-lived process O(1)
DEFAULT_BUCKET_CAP = 256
# the edge-axis floor of the reference's padded megakernel plan (its
# segment-sum chunk length), so the gate and admission bytes equal its own
PLAN_EDGE_FLOOR = 512

# the session-manifest wire format (serve.cache persists it so a restarted
# server can pre-warm the same shape buckets before taking traffic)
MANIFEST_FORMAT = "repro_torch.session-manifest"
MANIFEST_VERSION = 1
REFERENCE_MANIFEST_FORMAT = "repro.session-manifest"


def bucket_size(n: int, floor: int = DEFAULT_BUCKET_FLOOR) -> int:
    """Next power of two >= max(n, floor): the shape-class boundary."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def shard_bucket_size(n: int, n_shards: int,
                      floor: int = DEFAULT_BUCKET_FLOOR) -> int:
    """Shard-aware shape class: the pow2 bucket rounded UP to a multiple
    of ``n_shards`` (the sharded pools' s-clique axis, as the
    reference's)."""
    b = bucket_size(n, floor)
    n_shards = max(int(n_shards), 1)
    return -(-b // n_shards) * n_shards


def padded_plan_edges(problem: NucleusProblem) -> int:
    """The reference's padded megakernel plan edge length ``e_pad``."""
    return bucket_size(problem.n_s * problem.n_sub, PLAN_EDGE_FLOOR)


def canonical_schedule(method: str, s_choose_r: int, delta: float,
                       n: int) -> PeelSchedule:
    """The behaviour-preserving schedule representative of (method, C,
    delta, n)'s class: exact schedules never read ``n`` or ``delta``;
    approximate ones read ``n`` only through ``cap()``, so the smallest
    ``n`` with the same cap is substituted (cap is nondecreasing in n)."""
    if method == "exact":
        return PeelSchedule(kind="exact", s_choose_r=s_choose_r)

    def mk(nn: int) -> PeelSchedule:
        return PeelSchedule(kind="approx", s_choose_r=s_choose_r,
                            delta=delta, n=nn)
    target = mk(n).cap()
    lo, hi = 2, max(int(n), 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if mk(mid).cap() >= target:
            hi = mid
        else:
            lo = mid + 1
    return mk(lo)


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One shape class.  ``astuple`` is the hashable stats key, in the
    reference's field order (positional consumers index the prefix)."""

    method: str
    r: int
    s: int
    fused: bool
    n_r_pad: int
    n_s_pad: int
    schedule: PeelSchedule
    # the reference's padded plan edge length (None = no kernel)
    kernel: Optional[int] = None
    # mesh device count of a sharded bucket (0 = single device)
    shards: int = 0

    def astuple(self) -> Tuple:
        return (self.method, self.r, self.s, self.fused, self.n_r_pad,
                self.n_s_pad, self.schedule, self.kernel, self.shards)


class Session:
    """Warm decompose-many: ``Session(config).decompose(graph)``.

    The config is fixed at construction (keyword overrides apply on top,
    like ``decompose``); every call runs the same pipeline as the module's
    ``decompose()`` (same planner, validation and ``Decomposition``) and
    counts its shape bucket.  ``device=None`` means the card (raising
    without one).
    """

    def __init__(self, config: Optional[NucleusConfig] = None, *,
                 bucket_floor: int = DEFAULT_BUCKET_FLOOR,
                 bucket_cap: int = DEFAULT_BUCKET_CAP,
                 device: DeviceLike = None, **overrides):
        if config is None:
            config = NucleusConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.bucket_floor = int(bucket_floor)
        # bound on tracked shape classes (0 disables the cap)
        self.bucket_cap = int(bucket_cap)
        self.stats: Dict[str, Any] = {
            "decompositions": 0,   # total artifacts produced
            "warm": 0,             # dense engine calls that hit a bucket
            "cold": 0,             # dense engine calls opening a bucket
            "fallback": 0,         # calls off the bucketed dense engine
            "updates": 0,          # incremental update() calls served
            "stream_warm": 0,      # update stages hitting a known bucket
            "stream_cold": 0,      # update stages opening a bucket
            "evictions": 0,        # bucket entries dropped by the LRU cap
            "prewarmed": 0,        # buckets warmed ahead of traffic
            "buckets": {},         # bucket key -> call count (LRU order)
        }
        # counters and the bucket table take this lock so a status reader
        # never sees torn LRU state; the engine path stays single-writer
        # by frontend discipline (the lock guards bookkeeping only)
        self._stats_lock = threading.Lock()
        # decompose-bucket extras the manifest needs
        self._bucket_meta: Dict[Tuple, Dict[str, Any]] = {}

    # -- front door --------------------------------------------------------
    def _wants_kernel(self, config: NucleusConfig) -> bool:
        return bool(config.use_kernel or (
            config.use_kernel is None and kernel_by_default(self.device)))

    def decompose(self, graph_or_problem) -> Decomposition:
        """Same contract (and bit-identical arrays) as
        ``api.decompose(graph_or_problem, self.config)``."""
        problem, config = resolve_problem(graph_or_problem, self.config,
                                          self.device)
        config, plan = plan_config(problem, config)
        self._count("decompositions")
        wants_kernel = self._wants_kernel(config)
        # the reference's gate: what its padded plan allocates, (e_pad, C)
        # int32 with the edge axis pow2-bucketed
        plan_bytes = 4 * padded_plan_edges(problem) * problem.n_sub
        if config.backend == "sharded" and problem.n_r > 0:
            warm = self._bucket_hit(self._bucket(problem, config).astuple(),
                                    meta={"kind": "sharded"})
            self._count("warm" if warm else "cold")
        elif config.backend != "dense" or problem.n_r == 0 or (
                wants_kernel and plan_bytes > MEGAKERNEL_PLAN_BUDGET_BYTES):
            self._count("fallback")
        else:
            bucket = self._bucket(problem, config, wants_kernel=wants_kernel)
            meta: Dict[str, Any] = {"kind": "decompose"}
            if bucket.kernel is not None:
                meta["e_pad"] = bucket.kernel
            warm = self._bucket_hit(bucket.astuple(), meta=meta)
            self._count("warm" if warm else "cold")
        return execute_plan(problem, config, plan)

    def decompose_many(self, graphs) -> List[Decomposition]:
        """Decompose a stream; same-bucket members after the first are
        warm.  Results keep the input order."""
        return [self.decompose(g) for g in graphs]

    def update(self, dec: Decomposition, delta) -> Decomposition:
        """Incrementally patch ``dec`` (``Decomposition.update``), counting
        the local stages' shape classes in ``stats['buckets']`` (and the
        LRU cap) as ``stream_warm``/``stream_cold``."""
        self._count("updates")

        def hook(key: Tuple) -> None:
            warm = self._bucket_hit(key)
            self._count("stream_warm" if warm else "stream_cold")

        return dec.update(delta, bucket_hook=hook)

    # -- shape buckets -----------------------------------------------------
    def _bucket(self, problem: NucleusProblem, config: NucleusConfig, *,
                wants_kernel: Optional[bool] = None) -> _Bucket:
        """The shape class ``problem`` lands in under ``config``: on the
        sharded backend the reference's shard-multiple class over the
        mesh's devices, with no kernel plan."""
        shards = 0
        n_s_pad = bucket_size(problem.n_s, self.bucket_floor)
        kernel = None
        if config.backend == "sharded":
            shards = mesh_size(config, problem.device)
            n_s_pad = shard_bucket_size(problem.n_s, shards,
                                        self.bucket_floor)
        else:
            if wants_kernel is None:
                wants_kernel = self._wants_kernel(config)
            if wants_kernel and problem.n_s > 0:
                kernel = padded_plan_edges(problem)
        return _Bucket(
            method=config.method, r=config.r, s=config.s,
            fused=config.hierarchy == "fused",
            n_r_pad=bucket_size(problem.n_r, self.bucket_floor),
            n_s_pad=n_s_pad,
            schedule=canonical_schedule(config.method, problem.n_sub,
                                        config.delta, problem.g.n),
            kernel=kernel, shards=shards)

    def bucket_key(self, problem: NucleusProblem,
                   config: Optional[NucleusConfig] = None) -> Tuple:
        """The hashable shape-class key (``stats['buckets']`` is indexed
        by it), from shapes only: probing a key builds no plan arrays."""
        return tuple(self._bucket(problem, config or self.config).astuple())

    # -- manifest export / prewarm (the persistent warm path) --------------
    def manifest(self) -> Dict[str, Any]:
        """Serializable record of every decompose shape bucket this session
        has seen: the statics and padded shapes, nothing graph-specific.
        Stream-stage buckets (from ``update``) are left out."""
        with self._stats_lock:
            items = list(self.stats["buckets"].items())
            meta = {k: dict(v) for k, v in self._bucket_meta.items()}
        entries = []
        for key, count in items:
            m = meta.get(key)
            if m is None or m.get("kind") != "decompose":
                continue
            b = _Bucket(*key)
            entries.append({
                "method": b.method, "r": b.r, "s": b.s, "fused": b.fused,
                "n_r_pad": b.n_r_pad, "n_s_pad": b.n_s_pad,
                "schedule": dataclasses.asdict(b.schedule),
                "e_pad": m.get("e_pad"),
                "count": int(count)})
        return {"format": MANIFEST_FORMAT, "version": MANIFEST_VERSION,
                "config": self.config.to_dict(),
                "bucket_floor": self.bucket_floor,
                "bucket_cap": self.bucket_cap,
                "buckets": entries}

    def prewarm(self, manifest_or_buckets) -> int:
        """Register each manifest bucket before traffic; returns the number
        of buckets prewarmed.

        A bucket with a kernel launches the pool's kernel once (the
        megakernel, or the segment sum of a (1,2) pool's k-core lane) on a
        one-row input, which loads the kernel library; the buckets are
        then registered, so the first real same-bucket decompose counts as
        warm."""
        buckets = manifest_or_buckets
        if isinstance(buckets, dict):
            fmt = buckets.get("format")
            if fmt != MANIFEST_FORMAT:
                hint = (" (a manifest of the reference package: its buckets"
                        " carry a ScatterSpec, not this package's e_pad)"
                        if fmt == REFERENCE_MANIFEST_FORMAT else "")
                raise ValueError(
                    f"not a session manifest: format={fmt!r} (expected "
                    f"{MANIFEST_FORMAT!r}){hint} — regenerate it with "
                    f"Session.manifest()")
            buckets = buckets["buckets"]
        done = 0
        launched = False
        for e in buckets:
            r, s = int(e["r"]), int(e["s"])
            e_pad = e.get("e_pad")
            if e_pad is not None and not launched:
                self._load_kernel(r, s)
                launched = True
            key = _Bucket(method=e["method"], r=r, s=s, fused=bool(e["fused"]),
                          n_r_pad=int(e["n_r_pad"]),
                          n_s_pad=int(e["n_s_pad"]),
                          schedule=PeelSchedule(**e["schedule"]),
                          kernel=None if e_pad is None else int(e_pad)
                          ).astuple()
            meta: Dict[str, Any] = {"kind": "decompose"}
            if e_pad is not None:
                meta["e_pad"] = int(e_pad)
            with self._stats_lock:
                if key not in self.stats["buckets"]:
                    self.stats["buckets"][key] = 1
                    self._bucket_meta[key] = meta
                    self.stats["prewarmed"] += 1
            done += 1
        return done

    def _load_kernel(self, r: int, s: int) -> None:
        """One launch of the pool's kernel on a one-row input: a zero
        decrement (the k-core lane's segment sum), or one r-clique already
        peeled (the megakernel skips it)."""
        dev = self.device
        if takes_kcore_lane(r, s, self.config.use_kernel):
            segment_sum(torch.zeros((1, 1), dtype=INT, device=dev),
                        torch.zeros((1,), dtype=INT, device=dev), 1)
            return
        offsets = torch.tensor([0, 1], dtype=INT, device=dev)
        state = torch.zeros((1,), dtype=INT, device=dev)
        fused_peel_round(offsets,
                         torch.full((1, comb(s, r)), -1, dtype=INT,
                                    device=dev),
                         state, torch.full_like(state, PEELED),
                         state - 1, state - 1, 0, 0)

    def _count(self, name: str, by: int = 1) -> None:
        """Lock-guarded counter bump (no lost updates under threads)."""
        with self._stats_lock:
            self.stats[name] += by

    def _bucket_hit(self, key: Tuple,
                    meta: Optional[Dict[str, Any]] = None) -> bool:
        """Count one engine call against ``key``'s bucket, LRU-style.

        ``stats['buckets']`` is insertion-ordered; a hit reinserts the key
        at the back, and opening a new bucket past ``bucket_cap`` evicts
        the stalest entry (a re-seen key then counts cold again).  ``meta``
        attaches the manifest extras of a decompose bucket.  Returns True
        when the bucket was already warm."""
        with self._stats_lock:
            buckets = self.stats["buckets"]
            seen = buckets.pop(key, 0)
            buckets[key] = seen + 1
            if meta is not None:
                self._bucket_meta[key] = meta
            if seen == 0 and self.bucket_cap \
                    and len(buckets) > self.bucket_cap:
                stale = next(iter(buckets))
                del buckets[stale]
                self._bucket_meta.pop(stale, None)
                self.stats["evictions"] += 1
            return seen > 0
