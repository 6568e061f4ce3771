"""The multi-tenant nucleus server (counterpart of ``repro.serve``).

Four layers over the port's ``Session``/planner stack:

  * ``router``   — per-canonical-config ``Session`` pools, named live
                   artifacts, per-pool Plan and hit-rate introspection.
  * ``cache``    — the persistent warm path: the kernel build cache and the
                   session manifest, so a restarted server pre-warms its
                   pools before taking traffic.
  * ``frontend`` — bounded intake queue, one single-writer worker (the
                   only thread that runs the engine on the device),
                   same-bucket coalescing, typed admission control.
  * ``status``   — the JSON status schema and validator (the reference's);
                   ``httpd`` serves it with decompose/query/update.

Entry point: ``python -m repro_torch.launch.serve --arch nucleus --server``.
"""
from .cache import (init_persistent_cache, load_manifest, prewarm_router,
                    router_manifest, save_manifest)
from .frontend import (AdmissionError, Frontend, QueueFullError,
                       padded_plan_bytes)
from .httpd import NucleusHTTPServer
from .router import Request, Router, canonical_config, pool_key
from .status import (STATUS_FORMAT, STATUS_VERSION, status_report,
                     validate_status)

__all__ = [
    "AdmissionError", "Frontend", "NucleusHTTPServer", "QueueFullError",
    "Request", "Router", "STATUS_FORMAT", "STATUS_VERSION",
    "canonical_config", "init_persistent_cache", "load_manifest",
    "padded_plan_bytes", "pool_key", "prewarm_router", "router_manifest",
    "save_manifest", "status_report", "validate_status",
]
