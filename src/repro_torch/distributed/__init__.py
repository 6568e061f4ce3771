"""Runtime services around the train loop (counterpart of
``repro.distributed``'s ``runtime``).  The LM sharding rules
(``repro.distributed.sharding``) are not yet ported."""
from .runtime import (StragglerMonitor, PreemptionGuard, ElasticPlan,
                      HeartbeatLog)
