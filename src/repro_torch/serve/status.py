"""The status surface: one JSON report for the whole server.

Counterpart of ``repro.serve.status``, with the same ``STATUS_FORMAT`` and
schema, so one validator checks the report of either package:

  * per pool: the canonical config, the embedded ``Plan`` of the last
    decomposition, the Session's counter block, the warm/cold hit rate and
    the tracked shape buckets;
  * per artifact: name -> live version (+ size/axes);
  * server-wide: queue depth, intake counters and the admission budget.

``validate_status`` is the schema gate: it raises naming the missing or
malformed path.
"""
from __future__ import annotations

from typing import Any, Dict

STATUS_FORMAT = "repro.nucleus-server-status"
STATUS_VERSION = 1

# required keys and their types, by path
_TOP_KEYS = {"format": str, "version": int, "queue_depth": int,
             "admission_budget_bytes": int, "frontend": dict,
             "pools": list, "artifacts": dict}
_FRONTEND_KEYS = ("submitted", "served", "failed", "rejected_admission",
                  "rejected_queue", "batches", "coalesced")
_POOL_KEYS = {"config": dict, "plan": (dict, type(None)), "stats": dict,
              "hit_rate": float, "buckets": list,
              # builder telemetry of the pool's last decomposition (None
              # until one carries build_stats); sharded builds report
              # n_shards / chunks_per_shard / skew / exchange_bytes here
              "build": (dict, type(None))}
_POOL_STAT_KEYS = ("decompositions", "warm", "cold", "fallback", "updates",
                   "stream_warm", "stream_cold", "evictions", "prewarmed")
_ARTIFACT_KEYS = ("version", "n_r", "r", "s")


def status_report(frontend) -> Dict[str, Any]:
    """Snapshot the frontend and router into the status schema (reads under
    the stats locks: safe from any thread while the worker serves)."""
    with frontend._stats_lock:
        fstats = dict(frontend.stats)
    report = frontend.router.report()
    return {
        "format": STATUS_FORMAT,
        "version": STATUS_VERSION,
        "queue_depth": int(frontend.queue_depth),
        "admission_budget_bytes": int(frontend.admission_budget_bytes),
        "frontend": fstats,
        "pools": report["pools"],
        "artifacts": report["artifacts"],
    }


def validate_status(d: Dict[str, Any]) -> Dict[str, Any]:
    """Assert ``d`` matches the status schema; returns ``d``.  Raises
    ``ValueError`` naming the first offending path."""
    def fail(path: str, why: str):
        raise ValueError(f"status schema violation at {path}: {why}")

    for key, typ in _TOP_KEYS.items():
        if key not in d:
            fail(key, "missing")
        if not isinstance(d[key], typ):
            fail(key, f"expected {typ}, got {type(d[key]).__name__}")
    if d["format"] != STATUS_FORMAT:
        fail("format", f"expected {STATUS_FORMAT!r}, got {d['format']!r}")
    for key in _FRONTEND_KEYS:
        if not isinstance(d["frontend"].get(key), int):
            fail(f"frontend.{key}", "missing or non-integer")
    for i, pool in enumerate(d["pools"]):
        for key, typ in _POOL_KEYS.items():
            if key not in pool:
                fail(f"pools[{i}].{key}", "missing")
            if not isinstance(pool[key], typ):
                fail(f"pools[{i}].{key}",
                     f"expected {typ}, got {type(pool[key]).__name__}")
        for key in _POOL_STAT_KEYS:
            if not isinstance(pool["stats"].get(key), int):
                fail(f"pools[{i}].stats.{key}", "missing or non-integer")
        if pool["plan"] is not None and "backend" not in pool["plan"]:
            fail(f"pools[{i}].plan", "plan dict lacks 'backend'")
        if not 0.0 <= pool["hit_rate"] <= 1.0:
            fail(f"pools[{i}].hit_rate", f"out of [0,1]: {pool['hit_rate']}")
    for name, art in d["artifacts"].items():
        for key in _ARTIFACT_KEYS:
            if not isinstance(art.get(key), int):
                fail(f"artifacts[{name!r}].{key}", "missing or non-integer")
    return d
