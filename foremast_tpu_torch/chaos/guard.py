"""`GuardedSession`: chaos and the circuit breaker at an HTTP session's
choke point (the port's copy of `foremast_tpu/chaos/guard.py`).

`ElasticsearchStore` issues every round trip through one session object;
rather than threading seams through a dozen methods, the session itself
is wrapped once. The wrapper:

  * checks the edge's circuit breaker before the call (`BreakerOpen`
    short-circuits in microseconds while the dependency is known-down);
  * applies the edge's chaos perturbation (latency / injected faults);
  * records the call's outcome on the breaker with the shared transient
    classification (connection/timeout errors and HTTP 429/5xx are
    failures that could heal; 4xx means the endpoint is alive and counts
    as breaker success).

Only the verbs the store uses are proxied (`get`/`post`/`put`);
everything else delegates via `__getattr__`.
"""

from __future__ import annotations

from foremast_tpu_torch.chaos.degrade import is_transient_error


class GuardedSession:
    def __init__(self, inner, chaos=None, breaker=None):
        self.inner = inner
        self.chaos = chaos
        self.breaker = breaker

    def _call(self, verb: str, url: str, **kw):
        from foremast_tpu_torch.metrics.source import RETRY_STATUSES

        breaker = self.breaker
        if breaker is not None:
            breaker.allow()
        try:
            if self.chaos is not None:
                self.chaos.perturb(url)
            resp = getattr(self.inner, verb)(url, **kw)
        except BaseException as e:
            if breaker is not None and is_transient_error(e):
                breaker.record_failure()
            raise
        if breaker is not None:
            if resp.status_code in RETRY_STATUSES:
                breaker.record_failure()
            else:
                breaker.record_success()
        return resp

    def get(self, url, **kw):
        return self._call("get", url, **kw)

    def post(self, url, **kw):
        return self._call("post", url, **kw)

    def put(self, url, **kw):
        return self._call("put", url, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)
