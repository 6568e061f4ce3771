"""``repro_torch.distbuild`` (counterpart of ``repro.distbuild``).

Only the single-device piece is ported: ``estimate_eager_build_bytes``,
which ``core.api.resolve_problem`` reads to upgrade an eager build to the
chunked one under ``backend="auto"`` and a memory budget.  The sharded
build (planner, builder, exchange) is ROADMAP Queue 1.9.
"""
from .planner import estimate_eager_build_bytes

__all__ = ["estimate_eager_build_bytes"]
