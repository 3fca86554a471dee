"""A small shared circuit breaker, per dependency edge.

Closed → (``failure_threshold`` consecutive transient failures) →
open → (``open_seconds`` cooldown) → half-open → one probe call:
success re-closes, failure re-opens. The point is FAIL-FAST
degradation: once an endpoint is known-down, every further call costs
one exception instead of a full client timeout — a dead Prometheus
stops stalling the tick pipeline behind per-doc timeouts, and the
write-behind buffer takes store writes the moment the store breaker
opens instead of after another round of retries.

Classification reuses `PrometheusSource`'s transient set (connection /
timeout errors, HTTP 429/5xx): only failures that *could* heal trip
the breaker — a 400 means the endpoint is alive and the request is
wrong, which no amount of breaking fixes.

`BreakerOpen` subclasses ConnectionError so every existing
transient-failure net (fetch-failure isolation, resilient store
writes) treats a short-circuited call exactly like a refused
connection — no new exception plumbing in product code.

Thread-safety: one Lock per breaker; the guarded section is a handful
of compares (the dependency call itself NEVER runs under the lock).
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding for foremast_breaker_state (docs/observability.md)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

DEFAULT_FAILURE_THRESHOLD = 5
DEFAULT_OPEN_SECONDS = 10.0


class BreakerOpen(ConnectionError):
    """Short-circuited call: the edge's breaker is open."""

    def __init__(self, edge: str, retry_in: float):
        super().__init__(
            f"circuit breaker open for {edge!r} "
            f"(retry in {max(retry_in, 0.0):.1f}s)"
        )
        self.edge = edge
        self.retry_in = retry_in


class CircuitBreaker:
    """One edge's breaker. ``allow()`` before the call, then exactly one
    of ``record_success()`` / ``record_failure()`` after it."""

    def __init__(
        self,
        edge: str,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        open_seconds: float = DEFAULT_OPEN_SECONDS,
        clock=time.monotonic,
    ):
        self.edge = edge
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_seconds = float(open_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False  # half-open: exactly one probe in flight
        self._probe_started = 0.0
        self.transitions: dict[str, int] = {}
        self.short_circuits = 0

    # -- state machine (all under _lock) --------------------------------

    def _transition(self, to: str) -> None:
        self._state = to
        self.transitions[to] = self.transitions.get(to, 0) + 1

    def allow(self) -> None:
        """Raise `BreakerOpen` when the call must not go out; otherwise
        reserve the call (in half-open, only one probe passes)."""
        with self._lock:
            if self._state == OPEN:
                remaining = (
                    self._opened_at + self.open_seconds - self._clock()
                )
                if remaining > 0.0:
                    self.short_circuits += 1
                    raise BreakerOpen(self.edge, remaining)
                self._transition(HALF_OPEN)
                self._probing = False
            if self._state == HALF_OPEN:
                # the probe reservation SELF-HEALS: a probe whose caller
                # died without record_success/record_failure (an
                # unclassified exception between allow() and the record —
                # say a truncated response parsing error) must not
                # short-circuit this edge forever. Past one cooldown the
                # reservation is considered abandoned and taken over.
                if self._probing and (
                    self._clock() - self._probe_started < self.open_seconds
                ):
                    self.short_circuits += 1
                    raise BreakerOpen(self.edge, 0.0)
                self._probing = True
                self._probe_started = self._clock()

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh cooldown
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and (
                self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(OPEN)

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and (
                self._clock() - self._opened_at >= self.open_seconds
            ):
                return HALF_OPEN  # would probe on the next allow()
            return self._state

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "short_circuits": self.short_circuits,
                "transitions": dict(self.transitions),
            }


class BreakerRegistry:
    """Edge-name → breaker, shared across clients so varz/metrics see
    every breaker in the process from one place."""

    def __init__(
        self,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        open_seconds: float = DEFAULT_OPEN_SECONDS,
        clock=time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.open_seconds = open_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    @staticmethod
    def from_env(env=None) -> "BreakerRegistry":
        import os

        e = os.environ if env is None else env
        return BreakerRegistry(
            failure_threshold=int(
                e.get("FOREMAST_BREAKER_FAILURES", "")
                or DEFAULT_FAILURE_THRESHOLD
            ),
            open_seconds=float(
                e.get("FOREMAST_BREAKER_OPEN_SECONDS", "")
                or DEFAULT_OPEN_SECONDS
            ),
        )

    def get(self, edge: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(edge)
            if br is None:
                br = CircuitBreaker(
                    edge,
                    failure_threshold=self.failure_threshold,
                    open_seconds=self.open_seconds,
                    clock=self._clock,
                )
                self._breakers[edge] = br
        return br

    def all(self) -> dict[str, CircuitBreaker]:
        with self._lock:
            return dict(self._breakers)

    def debug_state(self) -> dict:
        return {e: b.debug_state() for e, b in sorted(self.all().items())}
