"""Ingest byte-rate envelopes.

The receiver half of tenant isolation: a token bucket per tenant that
has an ``ingest_bytes_per_s`` envelope configured. Admission runs
inside ``decode_apply`` — AFTER decode (tenant identity lives in the
series labels, so it cannot exist before the frame is parsed) and
BEFORE the ring apply, on both the JSON and FMW1 binary codecs by
construction (they share that one path). A batch whose dominant tenant
is over its envelope is shed whole with 429 + a computed Retry-After:
re-pushing is idempotent at the ring (same timestamps re-apply to the
same points), so atomically rejecting the batch is safe and keeps the
"which bytes were accepted" contract trivial.

Tenants without an envelope always admit — the global inflight cap and
decode-pool depth remain the backstops they are today, so an
unconfigured fleet sheds exactly as an untenanted one.

``blame()`` attributes pre-decode sheds (decode-pool busy, where no
tenant can be known yet): the most-over-budget governed tenant is
overwhelmingly the source of queue pressure, and charging it keeps the
``decode-shed included`` promise without decoding anything.
"""

from __future__ import annotations

import math
import threading

from foremast_tpu_torch.tenant.registry import TenantRegistry

RETRY_AFTER_MIN = 1
RETRY_AFTER_MAX = 60


class IngestGovernor:
    """Per-tenant token buckets over decoded push bytes. Thread-safe
    behind one leaf lock; only tenants with a configured
    ``ingest_bytes_per_s`` are governed."""

    def __init__(self, registry: TenantRegistry):
        self.registry = registry
        self._lock = threading.Lock()  # tenant.governor (leaf)
        # tenant -> [tokens, last_refill_monotonic]
        self._buckets: dict[str, list[float]] = {}

    def _burst(self, spec) -> float:
        # default burst = 2 s of envelope: one fat batch from a
        # well-behaved agent must not trip the governor
        return float(spec.burst_bytes or 2 * spec.ingest_bytes_per_s)

    def admit(self, tenant: str, nbytes: int, now: float) -> float:
        """0.0 = admitted (tokens burned); > 0 = shed, the value being
        the Retry-After seconds until the bucket can cover ``nbytes``.
        Ungoverned tenants always admit."""
        spec = self.registry.spec(tenant)
        rate = spec.ingest_bytes_per_s
        if rate <= 0:
            return 0.0
        burst = self._burst(spec)
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = [burst, now]
                self._buckets[tenant] = bucket
            tokens, last = bucket
            tokens = min(burst, tokens + (now - last) * rate)
            bucket[1] = now
            if tokens >= nbytes:
                bucket[0] = tokens - nbytes
                return 0.0
            bucket[0] = tokens
            retry = (nbytes - tokens) / rate
        return float(
            min(max(math.ceil(retry), RETRY_AFTER_MIN), RETRY_AFTER_MAX)
        )

    def blame(self, now: float) -> str | None:
        """The governed tenant deepest over its envelope right now
        (fullest bucket deficit relative to its rate), or None when
        every bucket has headroom — the attribution target for sheds
        that fire before decode can name a tenant."""
        worst = None
        worst_wait = 0.0
        with self._lock:
            for tenant, bucket in self._buckets.items():
                spec = self.registry.spec(tenant)
                rate = spec.ingest_bytes_per_s
                if rate <= 0:
                    continue
                burst = self._burst(spec)
                tokens = min(burst, bucket[0] + (now - bucket[1]) * rate)
                # seconds until this tenant's bucket is half-full again:
                # > 0 only when it has been draining faster than it
                # refills
                wait = (burst / 2 - tokens) / rate
                if wait > worst_wait:
                    worst_wait = wait
                    worst = tenant
        return worst

    def debug_state(self, now: float) -> dict:
        with self._lock:
            return {
                tenant: {
                    "tokens": int(
                        min(
                            self._burst(self.registry.spec(tenant)),
                            bucket[0]
                            + (now - bucket[1])
                            * self.registry.spec(tenant).ingest_bytes_per_s,
                        )
                    ),
                    "burst": int(self._burst(self.registry.spec(tenant))),
                }
                for tenant, bucket in sorted(self._buckets.items())
            }
