"""Per-series columnar ring buffer: (int64 times, float32 values) columns.

The port's copy of the JAX package's `foremast_tpu/ingest/ring.py`: the
same pow2 capacities, merge (sorted, deduplicated, last write wins) and
coverage spans, so a query answers with the same samples in both.

One `SeriesRing` holds one metric series as a pair of pow2-sized numpy
columns written circularly — the in-memory mirror of the shape every
`MetricSource.fetch` already returns, so a warm query is two
`searchsorted` calls and a slice copy, never a parse. Capacity starts
small and doubles up to `max_points`; past that the ring overwrites its
oldest samples (a 7-day 60 s-step history is 10,080 points, so the
16,384-point default ceiling keeps a full reference history resident
with headroom).

Thread-ownership contract: a SeriesRing has NO lock of its own — it is
only ever touched under its owning shard's lock (`shards.RingShard`),
the same single-writer discipline the model caches use. Keeping the
lock one level up lets a shard evict and account bytes atomically with
the mutation that overflowed them.

Coverage intervals: the ring records the (few) contiguous spans it is
AUTHORITATIVE for — extended by live pushes and by backfills' requested
windows, advanced past samples dropped by overwrite. Coverage is a
bounded SET of disjoint intervals, not one: a 7-day-old historical
backfill and a live push stream are disjoint spans, and keeping only
whichever ended later would make every cold doc of the same app re-pay
the historical HTTP fetch the moment a live push landed (the fallback's
backfill write-through must stick).
What a set must still never imply is that the gap between two fetched
windows was empty: a query is served only when one single interval
covers it (within the staleness slack), so a window sliding into the
gap between the historical span and the live head degrades to the pull
path exactly as before. Intervals within the merge slack of each other
coalesce; past `MAX_COVER_INTERVALS` the span with the oldest head is
dropped (that authority degrades back to the pull path, never to a
wrong answer).
"""

from __future__ import annotations

import numpy as np

MIN_CAPACITY = 256
DEFAULT_MAX_POINTS = 16_384  # pow2 >= the reference 10,080-pt history

# Bound on the disjoint coverage-interval set (module docstring): one
# live span + a historical backfill span is the common case, a couple
# more absorbs racing backfills of different ranges; past it the span
# with the oldest head degrades to the pull path.
MAX_COVER_INTERVALS = 4

# fixed per-sample storage cost: int64 time + float32 value
BYTES_PER_POINT = 12


def _pow2(n: int) -> int:
    cap = 1
    while cap < n:
        cap <<= 1
    return cap


def empty_series() -> tuple[np.ndarray, np.ndarray]:
    """The ring dtypes' empty series — one definition for the package
    (shards' miss results, the source's pure-push empties)."""
    return np.zeros(0, np.int64), np.zeros(0, np.float32)


class SeriesRing:
    """One series' sample window. All methods assume the owning shard's
    lock is held (see module docstring)."""

    __slots__ = ("_times", "_values", "_start", "_count", "max_points",
                 "_cov")

    def __init__(
        self,
        capacity: int = MIN_CAPACITY,
        max_points: int = DEFAULT_MAX_POINTS,
    ):
        self.max_points = _pow2(max(int(max_points), 1))
        cap = _pow2(max(1, min(int(capacity), self.max_points)))
        self._times = np.zeros(cap, np.int64)
        self._values = np.zeros(cap, np.float32)
        self._start = 0
        self._count = 0
        # disjoint authoritative spans as [from, to] pairs, sorted by
        # `from` (disjointness makes that sorted by `to` as well, so
        # the LAST entry is always the live head span)
        self._cov: list[list[float]] = []

    # -- coverage --------------------------------------------------------

    @property
    def covered_from(self) -> float | None:
        """Start of the HEAD span (the one with the newest authority) —
        the single-interval view stats and staleness accounting keep."""
        return self._cov[-1][0] if self._cov else None

    @property
    def covered_to(self) -> float | None:
        return self._cov[-1][1] if self._cov else None

    @property
    def head_interval(self) -> tuple[float, float] | None:
        return tuple(self._cov[-1]) if self._cov else None

    def intervals(self) -> list[tuple[float, float]]:
        """Every authoritative span, oldest first (snapshot/debug)."""
        return [tuple(iv) for iv in self._cov]

    def covering(
        self, t0: float | None, step: float
    ) -> tuple[float, float] | None:
        """The best span authoritative AT `t0` (its start within one
        `step` of the window start), or the head span for unbounded
        queries; None when no span reaches back to `t0`."""
        best = None
        for iv in self._cov:
            if t0 is None or iv[0] <= t0 + step:
                if best is None or iv[1] > best[1]:
                    best = iv
        return None if best is None else tuple(best)

    def _cover(self, b0: float, b1: float, slack: float) -> None:
        """Fold the batch's authoritative window into the span set:
        spans overlapping (or within `slack` of) [b0, b1] coalesce with
        it; a disjoint window becomes its own span, bounded by
        MAX_COVER_INTERVALS (oldest-head span dropped past it)."""
        lo, hi = b0, b1
        keep = []
        for iv in self._cov:
            if iv[1] >= lo - slack and iv[0] <= hi + slack:
                lo = min(lo, iv[0])
                hi = max(hi, iv[1])
            else:
                keep.append(iv)
        keep.append([lo, hi])
        keep.sort(key=lambda iv: iv[0])
        while len(keep) > MAX_COVER_INTERVALS:
            keep.remove(min(keep, key=lambda iv: iv[1]))
        self._cov = keep

    def _clamp_coverage(self, dropped_to: float) -> None:
        """Overwrite dropped resident samples: no span may claim
        authority before the oldest RETAINED sample. (Spans are never
        clamped merely to the oldest sample — a covered range may be
        provably empty.)"""
        out = []
        for iv in self._cov:
            if iv[1] < dropped_to:
                continue  # entirely before the retained region
            out.append([max(iv[0], dropped_to), iv[1]])
        self._cov = out

    # -- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return len(self._times)

    @property
    def nbytes(self) -> int:
        """Allocated column bytes — what the shard budget accounts."""
        return self._times.nbytes + self._values.nbytes

    @property
    def oldest(self) -> int | None:
        if not self._count:
            return None
        return int(self._times[self._start])

    @property
    def newest(self) -> int | None:
        if not self._count:
            return None
        cap = len(self._times)
        return int(self._times[(self._start + self._count - 1) % cap])

    def _segments(self) -> tuple[np.ndarray, np.ndarray]:
        """The ring's live region as (times, values) in time order;
        zero-copy when unwrapped, one concatenate when wrapped."""
        cap = len(self._times)
        s, n = self._start, self._count
        if s + n <= cap:
            return self._times[s : s + n], self._values[s : s + n]
        head = cap - s
        return (
            np.concatenate([self._times[s:], self._times[: n - head]]),
            np.concatenate([self._values[s:], self._values[: n - head]]),
        )

    # -- mutation (shard lock held) --------------------------------------

    def append(
        self,
        times: np.ndarray,
        values: np.ndarray,
        start: float | None = None,
        end: float | None = None,
        slack: float = 0.0,
    ) -> int:
        """Insert samples; returns the number accepted. Strictly-newer
        ordered batches take the circular fast path; overlapping or
        out-of-order batches merge (sort + dedup, last write wins per
        timestamp — remote-write semantics).

        `start`/`end` are the batch's authoritative window (a backfill
        asserting "the fallback answered for exactly [start, end]");
        without them the batch covers its own sample span (a live
        push). The batch's window coalesces with any coverage span it
        overlaps or abuts within `slack` seconds; a DISJOINT batch
        becomes its own span (see module docstring — a historical
        backfill stays authoritative next to the live push stream,
        while the gap between them stays on the pull path). A batch may
        be empty when `start`/`end` are given (backfilling a
        provably-empty range)."""
        ts = np.asarray(times, np.int64)
        vs = np.asarray(values, np.float32)
        n = len(ts)
        if n != len(vs):
            raise ValueError("times/values length mismatch")
        dropped_to = None
        if n:
            ordered = bool(np.all(np.diff(ts) > 0))
            newest = self.newest
            if ordered and (newest is None or int(ts[0]) > newest):
                dropped_to = self._append_ordered(ts, vs)
            else:
                dropped_to = self._merge(ts, vs)
        # sample-derived bounds use min/max, not ts[0]/ts[-1]: an
        # out-of-order push batch must not record a collapsed window
        b0 = float(start) if start is not None else (
            float(ts.min()) if n else None
        )
        b1 = float(end) if end is not None else (
            float(ts.max()) if n else None
        )
        if b0 is None and b1 is not None:
            # empty backfill of an unbounded-start window: the fallback
            # vouched for emptiness up to `end` — record point coverage
            # at the head so the series still warms (an unbounded query
            # passes no tail requirement)
            b0 = b1
        if b0 is not None:
            b1 = b0 if b1 is None else max(b0, b1)
            self._cover(b0, b1, slack)
        if dropped_to is not None and self._cov:
            self._clamp_coverage(float(dropped_to))
        return n

    def _append_ordered(self, ts: np.ndarray, vs: np.ndarray):
        """Returns the oldest retained timestamp when samples were
        dropped (the caller clamps coverage there), else None."""
        n = len(ts)
        dropped = False
        if n >= self.max_points:
            # batch alone fills the ring: keep its newest tail
            dropped = self._count > 0 or n > self.max_points
            ts, vs = ts[-self.max_points :], vs[-self.max_points :]
            n = len(ts)
        while self._count + n > self.capacity and self.capacity < self.max_points:
            self._grow()
        cap = self.capacity
        overflow = self._count + n - cap
        if overflow > 0:  # drop oldest resident samples
            self._start = (self._start + overflow) % cap
            self._count -= overflow
            dropped = True
        pos = (self._start + self._count) % cap
        first = min(n, cap - pos)
        self._times[pos : pos + first] = ts[:first]
        self._values[pos : pos + first] = vs[:first]
        if first < n:
            self._times[: n - first] = ts[first:]
            self._values[: n - first] = vs[first:]
        self._count += n
        return self.oldest if dropped else None

    def _merge(self, ts: np.ndarray, vs: np.ndarray):
        """Returns the oldest retained timestamp when the max_points
        trim dropped samples, else None (see _append_ordered)."""
        old_t, old_v = self._segments()
        all_t = np.concatenate([old_t, ts])
        all_v = np.concatenate([old_v, vs])
        order = np.argsort(all_t, kind="stable")
        all_t = all_t[order]
        all_v = all_v[order]
        # stable sort keeps insertion order within equal timestamps, so
        # keeping the LAST of each run is last-write-wins
        keep = np.ones(len(all_t), bool)
        keep[:-1] = all_t[1:] != all_t[:-1]
        all_t = all_t[keep]
        all_v = all_v[keep]
        dropped = len(all_t) > self.max_points
        if dropped:
            all_t = all_t[-self.max_points :]
            all_v = all_v[-self.max_points :]
        cap = _pow2(max(len(all_t), MIN_CAPACITY))
        cap = min(max(cap, self.capacity), self.max_points)
        self._times = np.zeros(cap, np.int64)
        self._values = np.zeros(cap, np.float32)
        self._times[: len(all_t)] = all_t
        self._values[: len(all_v)] = all_v
        self._start = 0
        self._count = len(all_t)
        return int(all_t[0]) if dropped and len(all_t) else None

    def _grow(self) -> None:
        t, v = self._segments()
        cap = min(self.capacity * 2, self.max_points)
        self._times = np.zeros(cap, np.int64)
        self._values = np.zeros(cap, np.float32)
        self._times[: len(t)] = t
        self._values[: len(v)] = v
        self._start = 0
        self._count = len(t)

    # -- queries (shard lock held) ---------------------------------------

    def window(self, t0: float | None, t1: float | None) -> tuple[np.ndarray, np.ndarray]:
        """Copy of the samples with ``t0 <= t <= t1`` (either bound may
        be None for "unbounded"), in time order."""
        t, v = self._segments()
        lo = 0 if t0 is None else int(np.searchsorted(t, t0, side="left"))
        hi = len(t) if t1 is None else int(np.searchsorted(t, t1, side="right"))
        return t[lo:hi].copy(), v[lo:hi].copy()

    def count_window(self, t0: float | None, t1: float | None) -> int:
        """How many samples ``t0 <= t <= t1`` holds — no column copy
        (the coverage probe of `RingShard.coverage`)."""
        t, _ = self._segments()
        lo = 0 if t0 is None else int(np.searchsorted(t, t0, side="left"))
        hi = len(t) if t1 is None else int(np.searchsorted(t, t1, side="right"))
        return hi - lo
