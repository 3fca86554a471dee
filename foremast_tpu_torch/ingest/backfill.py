"""Cold-miss subscription + backfill: how a series becomes warm.

The port's copy of the JAX package's `foremast_tpu/ingest/backfill.py`.
The ingest plane is opt-in and push-driven, so the first fetch of any
series necessarily misses. The contract: the miss is
RECORDED — the series is now "subscribed" — and the fallback fetch's
result is written straight into the ring with the query's own window
start as the coverage watermark, so the very next tick's fetch for the
same document is a resident-slice hit with zero HTTP. Pushers can read
the subscription book (receiver `/debug/state`, worker varz) to learn
which series the fleet actually wants — the push-plane analog of a
scrape config.

`SubscriptionBook` is bounded: keys arrive from document configs
(REST-supplied), the same unbounded-cardinality source the gauge-family
cap defends against, so past `cap` the oldest subscription record is
dropped (the series itself is unaffected — only the bookkeeping row).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from foremast_tpu_torch.ingest.shards import RingStore

DEFAULT_CAP = 16_384


class SubscriptionBook:
    """Thread-safe record of (series key -> last miss reason/URL)."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._subs: OrderedDict[str, dict] = OrderedDict()

    def record(self, key: str, url: str, reason: str) -> None:
        with self._lock:
            row = self._subs.get(key)
            if row is None:
                row = {"url": url, "reason": reason, "misses": 0}
                self._subs[key] = row
            row["reason"] = reason
            row["misses"] += 1
            self._subs.move_to_end(key)
            while len(self._subs) > self.cap:
                self._subs.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._subs)

    def snapshot(self, limit: int = 32) -> dict:
        """Bounded varz view: total + the most recent `limit` rows."""
        with self._lock:
            recent = list(self._subs.items())[-limit:]
            return {
                "total": len(self._subs),
                "recent": {k: dict(v) for k, v in recent},
            }


def backfill(
    store: RingStore,
    key: str,
    series,
    start: float | None,
    end: float | None = None,
    now: float | None = None,
) -> int:
    """Write a fallback fetch's result into the ring, stamping the
    query's window `[start, end]` as the coverage interval — the
    fallback is authoritative for exactly that range, INCLUDING its
    emptiness: a truly-empty series becomes a resident empty ring whose
    coverage serves subsequent fetches as empty hits (parity with the
    pull path) until staleness sends it back for a refresh. Backfilled
    samples never count as receiver lag (they are old by construction —
    see `RingStore.push(record_lag=...)`)."""
    times, values = series
    if start is None and end is None and not len(times):
        return 0  # nothing to store and no range to assert
    return store.push(
        key, times, values, start=start, end=end, now=now,
        record_lag=False,
    )
