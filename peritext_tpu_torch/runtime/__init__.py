"""Host runtime of the PyTorch port: causal ordering and anti-entropy sync, the chaos, health,
SLO and telemetry planes, queues, change logs, pub/sub, the serving plane
and its sharded tier (live migration and the autoscaler, the document
lifecycle).

Copies of ``peritext_tpu/runtime`` bound to the port, so the port imports
nothing of the JAX package.  ``checkpoint`` is imported on its own (it
imports the universe, which imports this package).
"""
from peritext_tpu_torch.runtime import faults, health, slo, telemetry
from peritext_tpu_torch.runtime.elastic import ElasticController, migrate_session
from peritext_tpu_torch.runtime.faults import FaultError, FaultPlan
from peritext_tpu_torch.runtime.health import BreakerOpenError, CircuitBreaker, HealthPlan
from peritext_tpu_torch.runtime.lifecycle import DocLifecycle
from peritext_tpu_torch.runtime.log import ChangeLog
from peritext_tpu_torch.runtime.pubsub import Publisher
from peritext_tpu_torch.runtime.queue import ChangeQueue, QueueFullError
from peritext_tpu_torch.runtime.serve import (
    ServeClosedError,
    ServePlane,
    ServeSession,
    ServeShedError,
    Submission,
)
from peritext_tpu_torch.runtime.serve_shard import ShardedServePlane, ShardSession
from peritext_tpu_torch.runtime.slo import SloObjective, SloPlan
from peritext_tpu_torch.runtime.sync import (
    ConvergenceError,
    apply_available,
    apply_changes,
    causal_order,
    causal_sort,
    sync_pair,
)

__all__ = [
    "BreakerOpenError",
    "ChangeLog",
    "ChangeQueue",
    "CircuitBreaker",
    "ConvergenceError",
    "DocLifecycle",
    "ElasticController",
    "FaultError",
    "FaultPlan",
    "HealthPlan",
    "Publisher",
    "QueueFullError",
    "ServeClosedError",
    "ServePlane",
    "ServeSession",
    "ServeShedError",
    "ShardSession",
    "ShardedServePlane",
    "SloObjective",
    "SloPlan",
    "Submission",
    "apply_available",
    "apply_changes",
    "causal_order",
    "causal_sort",
    "faults",
    "health",
    "migrate_session",
    "slo",
    "sync_pair",
    "telemetry",
]
