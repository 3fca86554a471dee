"""App instrumentation starter — the metrics-production leaf layer.

The port's copy of the JAX package's `foremast_tpu/instrument/`. Python
equivalent of `foremast-spring-boot-k8s-metrics-starter/` (SURVEY.md
section 2.4): standardizes how workloads emit HTTP metrics so foremast's
recording rules and scoring work out of the box. WSGI and aiohttp
middlewares, common tags, zero-initialized status counters, `/metrics`
aliasing, caller tagging, and runtime metric hiding.
"""

from foremast_tpu_torch.instrument.starter import (
    HttpMetrics,
    K8sMetricsConfig,
    MetricsFilter,
    instrument_aiohttp,
    wsgi_middleware,
)

__all__ = [
    "HttpMetrics",
    "K8sMetricsConfig",
    "MetricsFilter",
    "instrument_aiohttp",
    "wsgi_middleware",
]
