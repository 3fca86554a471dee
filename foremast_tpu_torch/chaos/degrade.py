"""Graceful-degradation machinery: transient classification, the
write-behind buffer, tick budgets, and the shared counters.

The worker holds ONE `Degradation` object bundling all of it, so the
call sites stay one-liners and `/debug/state` has a single
``degradation`` section to render.

Semantics (docs/operations.md "Failure modes & degradation"):

* **Transient classification** is the one the JAX package standardized
  in its `PrometheusSource`: connection/timeout exceptions, HTTP
  429/5xx (via a ``response.status_code`` or ``.code`` attribute), and
  `BreakerOpen` by inheritance. Everything else is a permanent error and PROPAGATES —
  degrading on a programming error would hide bugs behind resilience.
* **Write-behind**: a store write that fails transiently parks its
  docs in a bounded buffer; every tick retries the backlog FIRST (the
  store may have healed). Entries older than ``max_age_seconds``
  (wired to MAX_STUCK_IN_SECONDS) are DROPPED, not replayed: past the
  stuck window another worker's claim-CAS takeover has re-judged those
  docs, and a late replay would double-write the verdict — the drop
  plus the takeover is the exactly-once net. The worker therefore
  stamps entries at the CLAIM instant, not the write-failure instant
  (`BrainWorker._tick_claim_mono`): takeover eligibility runs off the
  claim's ``modified_at``, so age must be measured from the same
  moment or a slow fetch/judge would stretch the replay window past
  the takeover boundary. Past the entry cap the OLDEST entries drop
  (counted), because an unbounded buffer against a store that never
  heals is a slow OOM.
* **Tick budget** (``FOREMAST_TICK_BUDGET_SECONDS``, 0 = off): docs
  whose fetch/judge did not start before the deadline are RELEASED
  un-judged — status back to ``preprocess_completed``, claimable next
  tick — instead of wedging the tick behind a slow dependency. Counted
  per reason; never silent.

The JAX package's `foremast_tpu/chaos/degrade.py`, copied; the
classification uses the port's own `metrics.source`. `PrometheusSource`
is not in the port yet, so here the transient exception types are the
builtin connection and timeout errors (and their subclasses).
"""

from __future__ import annotations

import os
import threading
import time

from foremast_tpu_torch.chaos.breaker import BreakerRegistry

DEFAULT_WRITE_BEHIND_DOCS = 65_536
DEFAULT_WRITE_BEHIND_AGE_SECONDS = 90.0

# write-behind / release reasons (foremast_degraded_docs{reason})
REASON_DEADLINE = "deadline_released"
REASON_FETCH = "fetch_released"
# a fast-tick admitted doc the columnar program could no longer score
# (joint window-bucket drift, and any future admission invariant that
# breaks mid-tick): re-routed to the slow path for a refit — counted
# here so demotions never ride the slow leftovers silently
REASON_DEMOTED = "fast_demoted"
# a sliced sweep aborted mid-flight (judge/write stage death): slices
# that were claimed + prepared but never judged give their docs back
# un-judged instead of parking them behind the stuck-takeover window
# (the bounded-slice philosophy applied to the abort path)
REASON_ABORT = "sweep_aborted"
REASON_BUFFERED = "write_buffered"
REASON_REPLAYED = "write_replayed"
REASON_DROPPED_CAP = "write_dropped_cap"
REASON_DROPPED_AGE = "write_dropped_age"


def is_transient_error(e: BaseException) -> bool:
    """The shared could-this-heal classification (see module doc)."""
    from foremast_tpu_torch.metrics.source import (
        RETRY_STATUSES,
        _transient_exceptions,
    )

    if isinstance(e, _transient_exceptions()):
        return True
    # urllib wraps socket-level transport failures (connection refused/
    # reset, DNS, timeouts) in URLError with the original OSError as
    # `.reason` — classify by that cause, or a refused peer would read
    # as a programming error and crash the caller's loop. HTTPError (a
    # URLError subclass) carries a string reason and falls through to
    # the status check below.
    import urllib.error

    if isinstance(e, urllib.error.URLError) and isinstance(
        getattr(e, "reason", None), OSError
    ):
        return True
    # requests.HTTPError carries .response; urllib's HTTPError has .code
    status = getattr(getattr(e, "response", None), "status_code", None)
    if status is None:
        status = getattr(e, "code", None)
    return isinstance(status, int) and status in RETRY_STATUSES


class DegradeStats:
    """Lock-guarded degradation counters (mutated from the tick thread,
    the pipeline writer thread, and receiver handler threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._docs: dict[str, int] = {}
        self._events: dict[tuple[str, str], int] = {}

    def count_docs(self, reason: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._docs[reason] = self._docs.get(reason, 0) + n

    def count_event(self, edge: str, action: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            key = (edge, action)
            self._events[key] = self._events.get(key, 0) + n

    def docs_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._docs)

    def events_snapshot(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._events)

    def debug_state(self) -> dict:
        return {
            "docs": dict(sorted(self.docs_snapshot().items())),
            "events": {
                f"{e}/{a}": n
                for (e, a), n in sorted(self.events_snapshot().items())
            },
        }


class WriteBehindBuffer:
    """Bounded FIFO of (buffered_at, doc) awaiting store replay.

    The buffer holds Document OBJECTS (the worker finalized their
    statuses already); replay re-sends them through the store's normal
    ``update_many``. One lock guards the deque; the store round trip
    never runs under it (``drain``/``requeue`` hand batches out)."""

    def __init__(
        self,
        max_docs: int = DEFAULT_WRITE_BEHIND_DOCS,
        max_age_seconds: float = DEFAULT_WRITE_BEHIND_AGE_SECONDS,
        stats: DegradeStats | None = None,
        clock=time.monotonic,
    ):
        self.max_docs = max(1, int(max_docs))
        self.max_age_seconds = float(max_age_seconds)
        self.stats = stats or DegradeStats()
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: list[tuple[float, object]] = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def add(self, docs, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        docs = list(docs)
        dropped = 0
        with self._lock:
            # newest entries win under the cap: the claim lease on the
            # oldest is closest to expiring into a CAS takeover anyway
            self._entries.extend((now, d) for d in docs)
            overflow = len(self._entries) - self.max_docs
            if overflow > 0:
                del self._entries[:overflow]
                dropped = overflow
        self.stats.count_docs(REASON_BUFFERED, len(docs))
        self.stats.count_docs(REASON_DROPPED_CAP, dropped)

    def drain(
        self, now: float | None = None, margin: float = 0.0
    ) -> list[tuple[float, object]]:
        """Take every (buffered_at, doc) entry still inside the age
        window (expired entries drop + count: claim-CAS takeover owns
        them now). The caller replays the docs and `requeue`s the SAME
        entries on another failure — original stamps preserved, so a
        store that stays down still ages entries out instead of
        replaying them forever.

        `margin` shrinks the window: the age check runs at DRAIN time
        but the replay write lands one store round trip later — without
        headroom for that RPC, an entry kept at age max_age-ε could
        land after the takeover boundary and double-write a doc a peer
        re-judged. Callers pass their store's timeout (bounded)."""
        now = self._clock() if now is None else now
        cutoff = now + margin - self.max_age_seconds
        with self._lock:
            entries, self._entries = self._entries, []
        live = [(at, d) for at, d in entries if at >= cutoff]
        self.stats.count_docs(REASON_DROPPED_AGE, len(entries) - len(live))
        return live

    def requeue(self, entries: list[tuple[float, object]]) -> None:
        """Put a failed replay back at the FRONT with its original
        buffered_at stamps (see `drain`)."""
        if not entries:
            return
        overflow = 0
        with self._lock:
            self._entries[:0] = list(entries)
            overflow = len(self._entries) - self.max_docs
            if overflow > 0:
                del self._entries[:overflow]
        self.stats.count_docs(REASON_DROPPED_CAP, max(overflow, 0))

    def debug_state(self) -> dict:
        with self._lock:
            n = len(self._entries)
            oldest = self._entries[0][0] if self._entries else None
        return {
            "buffered_docs": n,
            "max_docs": self.max_docs,
            "max_age_seconds": self.max_age_seconds,
            "oldest_age_seconds": (
                round(self._clock() - oldest, 3) if oldest is not None else None
            ),
        }


class Degradation:
    """Everything the worker needs to degrade instead of die, bundled:
    the write-behind buffer, the tick budget, the breaker registry, the
    stats they all report through, and the active chaos plan (None in
    production)."""

    def __init__(
        self,
        stats: DegradeStats | None = None,
        breakers: BreakerRegistry | None = None,
        write_behind: WriteBehindBuffer | None = None,
        tick_budget_seconds: float = 0.0,
        chaos_plan=None,
    ):
        self.stats = stats or DegradeStats()
        self.breakers = breakers or BreakerRegistry()
        self.write_behind = write_behind or WriteBehindBuffer(
            stats=self.stats
        )
        self.tick_budget_seconds = float(tick_budget_seconds)
        self.chaos_plan = chaos_plan

    @staticmethod
    def from_env(
        max_stuck_seconds: float = DEFAULT_WRITE_BEHIND_AGE_SECONDS,
        env=None,
        chaos_plan=None,
    ) -> "Degradation":
        e = os.environ if env is None else env
        stats = DegradeStats()
        return Degradation(
            stats=stats,
            breakers=BreakerRegistry.from_env(e),
            write_behind=WriteBehindBuffer(
                max_docs=int(
                    e.get("FOREMAST_WRITE_BEHIND_DOCS", "")
                    or DEFAULT_WRITE_BEHIND_DOCS
                ),
                # the exactly-once net: never replay past the stuck
                # window another worker may have taken the claim over
                max_age_seconds=max_stuck_seconds,
                stats=stats,
            ),
            tick_budget_seconds=float(
                e.get("FOREMAST_TICK_BUDGET_SECONDS", "") or 0.0
            ),
            chaos_plan=chaos_plan,
        )

    def deadline(self, t0: float) -> float | None:
        """The tick's wall deadline (perf_counter domain), or None."""
        if self.tick_budget_seconds <= 0.0:
            return None
        return t0 + self.tick_budget_seconds

    def debug_state(self) -> dict:
        return {
            "tick_budget_seconds": self.tick_budget_seconds or None,
            "write_behind": self.write_behind.debug_state(),
            "breakers": self.breakers.debug_state(),
            **self.stats.debug_state(),
            "chaos": (
                self.chaos_plan.debug_state()
                if self.chaos_plan is not None
                else None
            ),
        }
