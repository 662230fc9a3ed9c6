"""Host runtime of the PyTorch port: causal ordering, the chaos, health,
SLO and telemetry planes, queues, change logs and the serving plane.

Copies of ``peritext_tpu/runtime`` bound to the port, so the port imports
nothing of the JAX package.  ``checkpoint`` is imported on its own (it
imports the universe, which imports this package).
"""
from peritext_tpu_torch.runtime import faults, health, slo, telemetry
from peritext_tpu_torch.runtime.faults import FaultError, FaultPlan
from peritext_tpu_torch.runtime.health import BreakerOpenError, CircuitBreaker, HealthPlan
from peritext_tpu_torch.runtime.log import ChangeLog
from peritext_tpu_torch.runtime.queue import ChangeQueue, QueueFullError
from peritext_tpu_torch.runtime.serve import (
    ServeClosedError,
    ServePlane,
    ServeSession,
    ServeShedError,
    Submission,
)
from peritext_tpu_torch.runtime.slo import SloObjective, SloPlan
from peritext_tpu_torch.runtime.sync import causal_order

__all__ = [
    "BreakerOpenError",
    "ChangeLog",
    "ChangeQueue",
    "CircuitBreaker",
    "FaultError",
    "FaultPlan",
    "HealthPlan",
    "QueueFullError",
    "ServeClosedError",
    "ServePlane",
    "ServeSession",
    "ServeShedError",
    "SloObjective",
    "SloPlan",
    "Submission",
    "causal_order",
    "faults",
    "health",
    "slo",
    "telemetry",
]
