"""`RingSource` — the worker-facing adapter of the ingest plane.

The port's copy of the JAX package's `foremast_tpu/ingest/source.py`,
the short-history admission of `hist_columns` included: the worker fits
a pure-push source's partial windows as provisional fits and refines
them as coverage grows (`jobs/refine.py`).

A `MetricSource` whose warm path is a resident ring-slice gather: the
worker's slow and fast tick paths only ever see the `MetricSource`
interface, so pull/push parity is structural — the same `_fetch_tasks`
/ `_fast_tick` code runs either way, only `fetch()`'s cost changes.
`concurrent_fetch` DELEGATES to the wrapped fallback: a warm fetch is
an in-memory gather, but the miss/stale path is the fallback's real
blocking I/O — a fleet-cold first tick (or a dead-pusher tick) must
fan 16k HTTP round trips over the fetch pool, not serialize them on
the tick thread. Pure-push mode (no fallback) declares False like the
other in-memory sources.

Miss handling (see `backfill`): unresolvable URLs bypass the ring;
resolvable misses are recorded in the subscription book, served by the
wrapped fallback source (the real `PrometheusSource` in production),
and backfilled so the next tick hits. With no fallback the source is
pure-push: a miss returns the empty series and the brain yields
UNKNOWN, never a crash.
"""

from __future__ import annotations

import logging
import os
import time

from foremast_tpu_torch.ingest.backfill import SubscriptionBook, backfill
from foremast_tpu_torch.ingest.ring import empty_series as _empty
from foremast_tpu_torch.ingest.shards import RingStore
from foremast_tpu_torch.ingest.wire import resolve_query_range
from foremast_tpu_torch.metrics.source import MetricSource, Series

log = logging.getLogger("foremast_tpu_torch.ingest")

# Short-history admission floor: a newcomer series whose
# live coverage span holds at least this many seconds of fresh data is
# admissible for a PROVISIONAL cold fit straight from the ring — a
# verdict-capable short history in its first tick instead of a miss.
# One day default: enough for every detector's measurability gates at
# the reference 60 s step (1,440 points >> min_historical_points and
# the LSTM 2-window floor) while staying well under the 7-day target
# the background refinement converges to.
DEFAULT_ADMIT_FLOOR_SECONDS = 86_400.0


class RingSource(MetricSource):
    # url -> (key, t0, t1, step) memo bound: a fleet's URL set is
    # stable (two per document per alias), so this is effectively
    # "decode each URL once per process"; the crude clear-on-overflow
    # matches the worker's admission-cache discipline
    RESOLVE_CACHE_MAX = 1_048_576

    def __init__(
        self,
        ring: RingStore,
        fallback: MetricSource | None = None,
        clock=time.time,
        admit_floor: float | None = None,
    ):
        self.ring = ring
        self.fallback = fallback
        self.book = SubscriptionBook()
        self._clock = clock
        if admit_floor is None:
            admit_floor = float(
                os.environ.get("FOREMAST_ADMIT_MIN_COVERAGE_SECONDS", "")
                or DEFAULT_ADMIT_FLOOR_SECONDS
            )
        # seconds of fresh coverage a series needs before a historical
        # range it cannot fully serve is admitted as a PROVISIONAL
        # short history (hist_columns); 0 disables partial admission
        self.admit_floor = float(admit_floor)
        # Warm fetches are the per-tick hot loop (one per window per
        # tick at fleet scale) and `resolve_query_range` — urlparse +
        # parse_qs + selector canonicalization — costs ~25-35 µs, an
        # order of magnitude more than the ring gather it guards.
        # Document URLs are immutable per doc id, so the resolution is
        # memoized: a warm fetch is a dict hit + ring slice.
        self._resolved: dict[str, tuple] = {}

    @property
    def concurrent_fetch(self) -> bool:
        # see module docstring: the miss path is the fallback's I/O
        return bool(
            self.fallback is not None
            and getattr(self.fallback, "concurrent_fetch", True)
        )

    def _resolve(self, url: str) -> tuple:
        resolved = self._resolved.get(url)
        if resolved is None:
            if len(self._resolved) > self.RESOLVE_CACHE_MAX:
                self._resolved.clear()  # crude bound; repopulates
            resolved = resolve_query_range(url)
            self._resolved[url] = resolved
        return resolved

    def fetch(self, url: str) -> Series:
        key, t0, t1, step = self._resolve(url)
        if key is None:
            # no recognizable series identity: never warmable, straight
            # through to the wrapped source
            if self.fallback is None:
                return _empty()
            return self.fallback.fetch(url)
        now = self._clock()
        status, ts, vs = self.ring.query(key, t0, t1, now, step=step)
        if status == "hit":
            return ts, vs
        self.book.record(key, url, status)
        if self.fallback is None:
            return ts, vs  # pure-push mode: empty series => UNKNOWN
        series = self.fallback.fetch(url)
        head = now if t1 is None else min(t1, now)
        backfill(self.ring, key, series, start=t0, end=head, now=now)
        return series

    # -- ring-resident historical reads ----------------------------------

    def hist_columns(self, url: str, now: float | None = None):
        """Serve a historical range straight from the ring's resident
        columns — the worker's cold-fit read path (jobs/worker.py
        `_fetch_hist`), which bypasses its host-side `_hist_cache`
        entirely when the ring can serve (no double-buffering, no HTTP,
        no JSON reassembly: the slice IS the stored column).

        Returns (status, times, values, (cov_from, cov_to), (t0, t1))
        with status "full" (the ring covers the whole requested range)
        or "partial" (short-history admission: the live span holds >=
        `admit_floor` seconds — a PROVISIONAL fit, refined in the
        background as coverage grows). None when the ring cannot serve:
        the caller falls back to `fetch()`, whose fallback result
        backfills the ring write-through so the NEXT cold fit of the
        same series is resident.

        Partial admission is PURE-PUSH only: with a fallback
        configured, an uncovered window start must keep degrading to
        the fallback — Prometheus may well hold the full 7-day history
        the ring lost (restart without a snapshot, eviction), and a
        partial fit would silently replace it with the short slice
        forever. A genuinely-new app costs one fallback round trip
        (short real history, backfilled with full-window authority) and
        is resident from then on; only a fleet with NO pull path needs
        the ring's own short-history admission."""
        key, t0, t1, step = self._resolve(url)
        if key is None:
            return None
        now = self._clock() if now is None else now
        status, ts, vs, cov = self.ring.hist_query(
            key, t0, t1, now, step=step,
            admit_floor=(
                self.admit_floor if self.fallback is None else 0.0
            ),
        )
        if status in ("full", "partial"):
            return status, ts, vs, cov, (t0, t1)
        # no book.record here: every unservable hist read falls through
        # to fetch(), which records the subscription (and the fetch
        # counters) for the SAME lookup — recording twice would double
        # the miss counts every fallback-path cold fit
        return None

    def hist_coverage(self, url: str, now: float | None = None):
        """Counter-free coverage probe for one historical URL: (state,
        points_in_window, (cov_from, cov_to), (t0, t1)) — the
        refinement planner's pacing read (no column copies, no LRU
        touch). state None when the ring cannot serve the series."""
        key, t0, t1, step = self._resolve(url)
        if key is None:
            return None
        now = self._clock() if now is None else now
        state, n, cov = self.ring.coverage(key, t0, t1, now, step=step)
        return state, n, cov, (t0, t1)

    def ingest_debug_state(self) -> dict:
        """The worker `/debug/state` `ingest` section (duck-typed hook:
        `BrainWorker.debug_state` includes any source exposing this)."""
        state = self.ring.stats()
        state["subscriptions"] = self.book.snapshot()
        state["fallback"] = type(self.fallback).__name__ if self.fallback else None
        state["admit_floor_seconds"] = self.admit_floor
        return state
