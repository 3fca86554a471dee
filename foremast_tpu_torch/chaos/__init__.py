"""Graceful degradation: the shared circuit breaker, transient
classification, the write-behind buffer, tick budgets and their counters.
(The JAX package's fault-injection half waits for a later slice.)"""

from foremast_tpu_torch.chaos.breaker import (
    BreakerOpen,
    BreakerRegistry,
    CircuitBreaker,
)
from foremast_tpu_torch.chaos.degrade import (
    DegradeStats,
    Degradation,
    WriteBehindBuffer,
    is_transient_error,
)

__all__ = [
    "BreakerOpen",
    "BreakerRegistry",
    "CircuitBreaker",
    "DegradeStats",
    "Degradation",
    "WriteBehindBuffer",
    "is_transient_error",
]
