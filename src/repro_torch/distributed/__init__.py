"""Runtime services around the train loop and the sharding rules
(counterpart of ``repro.distributed``): ``runtime``'s guards and
``sharding``'s specs, rule tables and sharded tensors."""
from .runtime import (StragglerMonitor, PreemptionGuard, ElasticPlan,
                      HeartbeatLog)
