"""Chaos plane: deterministic fault injection and graceful degradation.

* **Injection** (`plan.py`): a seeded `FaultPlan` (latency, error rate,
  blackhole, status, clock skew) threaded through one interception seam
  in each dependency client the port has: `PrometheusSource`,
  `ElasticsearchStore` (through `guard.py`'s `GuardedSession`), the
  ingest receiver, the mesh handoff and the watch plane's `HttpKube`. Activated by `FOREMAST_CHAOS_PLAN` (off in production:
  every seam is a `None` check) or injected directly in tests.
* **Degradation** (`breaker.py`, `degrade.py`): the shared circuit
  breaker, transient classification, the write-behind buffer, tick
  budgets and their counters.
* **Exposition** (`collector.py`): `ChaosCollector`, the
  `foremast_chaos_*`, `foremast_breaker_*` and `foremast_degraded_*`
  families of the JAX package.
"""

from foremast_tpu_torch.chaos.breaker import (
    BreakerOpen,
    BreakerRegistry,
    CircuitBreaker,
)
from foremast_tpu_torch.chaos.collector import ChaosCollector
from foremast_tpu_torch.chaos.degrade import (
    DegradeStats,
    Degradation,
    WriteBehindBuffer,
    is_transient_error,
)
from foremast_tpu_torch.chaos.guard import GuardedSession
from foremast_tpu_torch.chaos.plan import (
    EdgeChaos,
    FaultPlan,
    FaultRule,
    InjectedFault,
    InjectedTimeout,
    chaos_from_env,
)

__all__ = [
    "BreakerOpen",
    "BreakerRegistry",
    "ChaosCollector",
    "CircuitBreaker",
    "DegradeStats",
    "Degradation",
    "EdgeChaos",
    "FaultPlan",
    "FaultRule",
    "GuardedSession",
    "InjectedFault",
    "InjectedTimeout",
    "WriteBehindBuffer",
    "chaos_from_env",
    "is_transient_error",
]
