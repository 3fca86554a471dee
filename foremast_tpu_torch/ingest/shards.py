"""Sharded, byte-budgeted resident-series store: the ring TSDB proper.

The port's copy of the JAX package's `foremast_tpu/ingest/shards.py`,
with its per-tenant ring-bytes envelopes (`_RingTenancy`) and the worker
mesh's rebalance hook (`evict_unowned`: a member drops the series a
healed ring gave to another member; `mesh/node.py` calls it on a
membership change).

`RingStore` spreads series over N `RingShard`s by key hash (crc32 —
deterministic across processes, unlike Python's randomized `hash`).
Each shard owns one `threading.Lock` guarding its series map, its LRU
order, and its byte account, so the receiver's push threads, the
worker's tick-thread fetches, and the varz scrape handler contend on
1/N of the keyspace instead of one global lock — the same reasoning as
the per-thread Sessions in `PrometheusSource`.

Budget + eviction: `FOREMAST_INGEST_BUDGET_BYTES` divides evenly across
shards; when a push overflows a shard's slice, least-recently-USED
series (queries refresh recency, not just pushes) are dropped whole —
an evicted-but-subscribed series re-warms through the source's
cold-miss fallback on its next fetch, so eviction degrades to the pull
path rather than to wrong answers. A shard never evicts its last
resident series: one series larger than the slice must not thrash.

Staleness: a query whose window reaches `min(end, now)` is only a hit
when the newest resident sample is within `stale_seconds` of it — a
pusher that died must degrade to the pull path, not freeze every
verdict at its last pushed value.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import OrderedDict

import numpy as np

from foremast_tpu_torch.ingest.ring import (
    DEFAULT_MAX_POINTS,
    SeriesRing,
    empty_series as _empty,
)
from foremast_tpu_torch.ingest.wire import canonical_series

DEFAULT_BUDGET_BYTES = 268_435_456  # 256 MB
DEFAULT_SHARDS = 8
DEFAULT_STALE_SECONDS = 300.0

_COUNT_KEYS = (
    "hits", "partial", "misses", "stale", "uncovered", "samples",
    "evictions",
)


def _serving_span(ring, t0, t1, now, step, stale_seconds):
    """THE serve rule, shared by query/hist_query/coverage (one
    definition or the refinement planner's view of servability drifts
    from what the read paths actually serve): the best span covering
    the window start, IF it is fresh enough for the window head —
    (span, head, covering) where span is None when nothing serves and
    covering is the raw covering interval regardless (so callers can
    split uncovered from stale without re-walking the span list).
    Caller holds the shard lock."""
    iv = ring.covering(t0, step)
    head = now if t1 is None else min(t1, now)
    if iv is not None and iv[1] >= head - stale_seconds and not (
        # a window starting past the span head has ZERO overlap with
        # what the ring can vouch for — an "empty hit" there would
        # hide samples the pull path has
        t0 is not None
        and iv[1] < t0 - step
    ):
        return iv, head, iv
    return None, head, iv


class _RingTenancy:
    """One store's tenant view: the registry resolves a pushed key's
    tenant (OUTSIDE any shard lock — the registry's cache lock is a peer
    leaf), per-tenant ring-bytes envelopes divide evenly across shards
    exactly like the global budget, and residency deltas + eviction
    charges flush into the shared `TenantAccounting` ledger AFTER the
    shard lock releases."""

    def __init__(self, registry, shards: int):
        from foremast_tpu_torch.tenant.accounting import accounting_for

        self.registry = registry
        self.accounting = accounting_for(registry)
        self.shards = max(1, int(shards))

    def tenant_of(self, key: str) -> str:
        return self.registry.tenant_of_series(key)

    def shard_envelope(self, tenant: str) -> int:
        """The tenant's per-shard byte envelope slice; 0 = no envelope.
        Lock-free (spec lookup reads an immutable dict), so it is safe
        under a shard lock."""
        rb = self.registry.spec(tenant).ring_bytes
        return max(rb // self.shards, 1) if rb > 0 else 0

    def flush(self, byte_deltas: dict, evictions: dict) -> None:
        for tenant, delta in byte_deltas.items():
            self.accounting.add_ring_bytes(tenant, delta)
        for tenant, n in evictions.items():
            self.accounting.count_eviction(tenant, n)


class RingShard:
    """One lock's worth of series. All state behind `_lock`; the
    SeriesRing objects inside are only touched while holding it."""

    def __init__(self, budget_bytes: int, max_points: int, tenancy=None):
        self.budget_bytes = int(budget_bytes)
        self.max_points = int(max_points)
        self._lock = threading.Lock()
        self._series: OrderedDict[str, SeriesRing] = OrderedDict()
        self._bytes = 0
        self._counts = dict.fromkeys(_COUNT_KEYS, 0)
        # tenant QoS view; None = untenanted, every path below keeps its
        # zero-cost check
        self._tenancy = tenancy
        self._t_bytes: dict[str, int] = {}  # tenant -> resident bytes
        self._t_of: dict[str, str] = {}  # resident key -> tenant

    def push(
        self,
        key: str,
        times,
        values,
        start: float | None = None,
        end: float | None = None,
        slack: float = 0.0,
        journal=None,
    ) -> int:
        """`journal` (optional, the snapshot plane's append-log hook) is
        invoked INSIDE the lock, after a successful apply: replayed log
        order must equal apply order, or a restore could resurrect the
        stale side of two same-timestamp revisions that raced on the
        receiver's handler threads. The cost is a page-cache write +
        flush inside the lock hold — microseconds, and only when
        durability is mounted."""
        return self.push_many(
            [(key, times, values, start, end)], slack=slack, journal=journal
        )[0]

    def push_many(
        self,
        items: list[tuple[str, np.ndarray, np.ndarray, float | None, float | None]],
        slack: float = 0.0,
        journal=None,
    ) -> list[int]:
        """Striped batch append: apply every ``(key, times, values,
        start, end)`` in ``items`` under ONE lock acquisition instead of
        one per series — the wire decode path groups a whole frame by
        shard and lands each group in a single hold (`push` is the
        one-item case). Returns per-item accepted counts, aligned with
        ``items``. Budget eviction runs per item (identical semantics to
        N push() calls); the journal hook fires per item IN APPLY ORDER,
        still under the lock (the replay-order contract is per apply,
        not per acquisition)."""
        out = []
        ten = self._tenancy
        # tenant resolution OUTSIDE the shard lock (the registry's cache
        # lock is a peer leaf, never nested under a shard's); residency
        # deltas + eviction charges accumulate here and flush into the
        # shared ledger after the lock releases
        tenants = [ten.tenant_of(key) for key, _, _, _, _ in items] if ten is not None else None
        byte_deltas: dict[str, int] = {}
        evict_charges: dict[str, int] = {}
        with self._lock:
            for j, (key, times, values, start, end) in enumerate(items):
                ring = self._series.get(key)
                prev = 0
                if ring is None:
                    ring = SeriesRing(max_points=self.max_points)
                    self._series[key] = ring
                else:
                    prev = ring.nbytes
                n = ring.append(
                    times, values, start=start, end=end, slack=slack
                )
                self._bytes += ring.nbytes - prev
                self._series.move_to_end(key)
                self._counts["samples"] += n
                if ten is not None:
                    t = tenants[j]
                    self._t_of[key] = t
                    delta = ring.nbytes - prev
                    if delta:
                        self._t_bytes[t] = self._t_bytes.get(t, 0) + delta
                        byte_deltas[t] = byte_deltas.get(t, 0) + delta
                    # per-tenant envelope: a tenant past its ring-bytes
                    # slice loses its OWN least-recently-used series
                    # first, charged to itself — never another tenant's
                    # residency, and never the series just pushed (one
                    # series larger than the envelope must not thrash,
                    # same rule as the global budget)
                    env = ten.shard_envelope(t)
                    if env:
                        self._evict_tenant(t, env, key, byte_deltas, evict_charges)
                while (
                    self._bytes > self.budget_bytes and len(self._series) > 1
                ):
                    if ten is not None:
                        # global overflow: prefer an over-envelope
                        # tenant's series, charge the pusher causing the
                        # pressure
                        self._evict_global(tenants[j], byte_deltas, evict_charges)
                    else:
                        _, old = self._series.popitem(last=False)
                        self._bytes -= old.nbytes
                        self._counts["evictions"] += 1
                if journal is not None and (
                    n or start is not None or end is not None
                ):
                    # empty backfills still carry an authority claim
                    # worth persisting; pure no-op pushes do not.
                    # DELIBERATELY under the shard lock (the
                    # replay-order contract, see `push`): journaling
                    # outside it would let two racing same-timestamp
                    # revisions restore stale.
                    # foremast: ignore[blocking-under-lock] — the replay-order contract, see `push`
                    journal(key, times, values, start, end)
                out.append(n)
        if ten is not None and (byte_deltas or evict_charges):
            ten.flush(byte_deltas, evict_charges)
        return out

    # -- tenant-aware eviction --------------------------------------------
    # These helpers run ONLY inside a `with self._lock:` block (push_many's;
    # `_pop_series` evict_unowned's too): the lock is not reentrant, so
    # they cannot retake it, and their guarded accesses carry the
    # suppression instead.

    def _pop_series(self, key: str, byte_deltas: dict) -> None:
        old = self._series.pop(key)  # foremast: ignore[lock-discipline] — caller holds _lock
        self._bytes -= old.nbytes  # foremast: ignore[lock-discipline] — caller holds _lock
        self._counts["evictions"] += 1  # foremast: ignore[lock-discipline] — caller holds _lock
        t = self._t_of.pop(key, None)  # foremast: ignore[lock-discipline] — caller holds _lock
        if t is not None:
            left = self._t_bytes.get(t, 0) - old.nbytes  # foremast: ignore[lock-discipline] — caller holds _lock
            if left > 0:
                self._t_bytes[t] = left  # foremast: ignore[lock-discipline] — caller holds _lock
            else:
                self._t_bytes.pop(t, None)  # foremast: ignore[lock-discipline] — caller holds _lock
            byte_deltas[t] = byte_deltas.get(t, 0) - old.nbytes

    def _evict_tenant(self, tenant: str, envelope: int, pushed_key: str, byte_deltas: dict,
                      evict_charges: dict) -> None:
        # foremast: ignore[lock-discipline] — caller holds _lock
        while self._t_bytes.get(tenant, 0) > envelope and len(self._series) > 1:
            # foremast: ignore[lock-discipline] — caller holds _lock
            victim = next((k for k in self._series if k != pushed_key and self._t_of.get(k) == tenant), None)
            if victim is None:
                break
            self._pop_series(victim, byte_deltas)
            evict_charges[tenant] = evict_charges.get(tenant, 0) + 1

    def _evict_global(self, causer: str, byte_deltas: dict, evict_charges: dict) -> None:
        victim = None
        for k in self._series:  # foremast: ignore[lock-discipline] — caller holds _lock
            t = self._t_of.get(k)  # foremast: ignore[lock-discipline] — caller holds _lock
            if t is None:
                continue
            env = self._tenancy.shard_envelope(t)
            if env and self._t_bytes.get(t, 0) > env:  # foremast: ignore[lock-discipline] — caller holds _lock
                victim = k
                break
        if victim is None:
            victim = next(iter(self._series))  # foremast: ignore[lock-discipline] — caller holds _lock
        self._pop_series(victim, byte_deltas)
        evict_charges[causer] = evict_charges.get(causer, 0) + 1

    def query(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float,
        stale_seconds: float,
    ) -> tuple[str, np.ndarray, np.ndarray]:
        """(status, times, values); status "hit" | "miss" (not resident)
        | "uncovered" (no single authoritative span reaches the window
        start — including the gap between two disjoint fetched windows)
        | "stale" (the serving span's head too far behind the window
        head: pusher dead or backfill aged out). A window is only ever
        served out of ONE coverage span (ring.SeriesRing.covering), so
        disjoint backfills never imply the gap between them was empty."""
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                self._counts["misses"] += 1
                return ("miss",) + _empty()
            self._series.move_to_end(key)  # queries refresh LRU recency
            iv, _head, cov = _serving_span(
                ring, t0, t1, now, step, stale_seconds
            )
            if iv is not None:
                self._counts["hits"] += 1
                return ("hit",) + ring.window(t0, t1)
            if cov is None:
                self._counts["uncovered"] += 1
                return ("uncovered",) + _empty()
            self._counts["stale"] += 1
            return ("stale",) + _empty()

    def hist_query(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float,
        stale_seconds: float,
        admit_floor: float,
    ) -> tuple:
        """Historical-range read with short-history admission:
        (status, times, values, (cov_from, cov_to) | None).

        "full" is exactly `query`'s hit — one span covers the window.
        "partial" serves the LIVE span's slice of the window when the
        span cannot reach back to `t0` but holds at least `admit_floor`
        seconds of fresh coverage: a newcomer's 1-2 pushed days become
        a verdict-capable short-history fit instead of a miss that the
        fallback (which has no more data for a true newcomer either)
        or pure-push UNKNOWN would be. The partial slice is clamped to
        the span — never a silently truncated view of a covered range.

        Only SERVED outcomes (full/partial) bump the fetch counters:
        every unservable hist read falls straight through to `fetch()`,
        which counts the same lookup — counting here too would double
        every fallback-path miss in foremast_ingest_fetches and the
        hit_ratio denominator."""
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                return ("miss",) + _empty() + (None,)
            self._series.move_to_end(key)
            iv, head, cov = _serving_span(
                ring, t0, t1, now, step, stale_seconds
            )
            if iv is not None:
                self._counts["hits"] += 1
                return ("full",) + ring.window(t0, t1) + (iv,)
            hd = ring.head_interval
            if (
                admit_floor > 0
                and hd is not None
                and hd[1] >= head - stale_seconds
                and (t0 is None or hd[0] > t0 + step)
                and min(head, hd[1]) - hd[0] >= admit_floor
            ):
                self._counts["partial"] += 1
                return ("partial",) + ring.window(hd[0], t1) + (hd,)
            if cov is None:
                return ("uncovered",) + _empty() + (None,)
            return ("stale",) + _empty() + (None,)

    def coverage(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float,
        stale_seconds: float,
    ) -> tuple:
        """(state, points_in_window, (cov_from, cov_to)) without column
        copies and without touching LRU order or the serve counters —
        the refinement planner's pacing probe (the worker's
        `_refine_provisional` runs it per provisional fit per idle tick). state
        "full" | "partial" (live span short of t0) | None (not resident /
        dead pusher)."""
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                return None, 0, None
            iv, head, _cov = _serving_span(
                ring, t0, t1, now, step, stale_seconds
            )
            if iv is not None:
                return "full", ring.count_window(t0, t1), iv
            hd = ring.head_interval
            if hd is not None and hd[1] >= head - stale_seconds:
                lo = hd[0] if t0 is None else max(t0, hd[0])
                return "partial", ring.count_window(lo, t1), hd
            return None, 0, None

    def evict_unowned(self, owns) -> int:
        """Drop every resident series the predicate disowns: the mesh
        rebalance hook (a healed ring moved these keys to another member,
        and keeping their columns would spend this worker's budget on
        series it will not be asked for again). Under tenancy the residency
        moves, but a rebalance is no tenant's pressure: nothing is charged
        as a tenant eviction."""
        byte_deltas: dict[str, int] = {}
        with self._lock:
            doomed = [k for k in self._series if not owns(k)]
            for k in doomed:
                if self._tenancy is not None:
                    self._pop_series(k, byte_deltas)
                else:
                    old = self._series.pop(k)
                    self._bytes -= old.nbytes
                    self._counts["evictions"] += 1
        if self._tenancy is not None and byte_deltas:
            self._tenancy.flush(byte_deltas, {})
        return len(doomed)

    def snapshot_state(self) -> list[tuple]:
        """Consistent copy of every resident series for the snapshot
        writer: (key, times, values, covered_from, covered_to, extras)
        — the head coverage span plus any OLDER disjoint spans (a
        restored ring must keep serving historical backfills). Columns copied under the shard lock so a concurrent
        push can never interleave half a mutation into the on-disk
        state."""
        with self._lock:
            out = []
            for key, ring in self._series.items():
                t, v = ring.window(None, None)  # ordered copies
                ivs = ring.intervals()
                out.append(
                    (
                        key,
                        t,
                        v,
                        ring.covered_from,
                        ring.covered_to,
                        ivs[:-1],  # all but the head span
                    )
                )
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "bytes": self._bytes,
                **self._counts,
            }


class RingStore:
    """The sharded ring TSDB: push/query/stats over canonical series
    keys (`wire.canonical_series` — push and query sides agree on label
    order by construction)."""

    def __init__(
        self,
        budget_bytes: int = DEFAULT_BUDGET_BYTES,
        shards: int = DEFAULT_SHARDS,
        stale_seconds: float = DEFAULT_STALE_SECONDS,
        max_points: int = DEFAULT_MAX_POINTS,
        tenancy=None,
    ):
        shards = max(1, int(shards))
        self.budget_bytes = int(budget_bytes)
        self.stale_seconds = float(stale_seconds)
        self.max_points = int(max_points)
        # tenant QoS plane: a TenantRegistry activates per-tenant
        # ring-bytes envelopes + eviction attribution; None keeps the
        # untenanted eviction loop byte-identical
        self.tenancy = _RingTenancy(tenancy, shards) if tenancy is not None else None
        self._shards = tuple(
            RingShard(max(self.budget_bytes // shards, 1), self.max_points, tenancy=self.tenancy)
            for _ in range(shards)
        )
        self._lock = threading.Lock()
        self._lag = {"receiver_lag_seconds": None, "last_push_at": None}
        # optional push write-through hook (ingest.snapshot attaches the
        # append-log writer here): called AFTER a successful apply with
        # (shard_index, canonical key, times, values, start, end),
        # UNDER the owning shard's lock so replay order equals apply
        # order (see RingShard.push).
        self.journal = None

    @staticmethod
    def from_env(env=None) -> "RingStore":
        """The store the environment configures; its tenancy is the
        process-global registry (`FOREMAST_TENANTS`, `tenant.get_tenancy`)."""
        from foremast_tpu_torch.tenant.registry import get_tenancy

        e = os.environ if env is None else env
        return RingStore(
            budget_bytes=int(
                e.get("FOREMAST_INGEST_BUDGET_BYTES", "")
                or DEFAULT_BUDGET_BYTES
            ),
            shards=int(e.get("FOREMAST_INGEST_SHARDS", "") or DEFAULT_SHARDS),
            stale_seconds=float(
                e.get("FOREMAST_INGEST_STALE_SECONDS", "")
                or DEFAULT_STALE_SECONDS
            ),
            max_points=int(
                e.get("FOREMAST_INGEST_MAX_POINTS", "") or DEFAULT_MAX_POINTS
            ),
            tenancy=get_tenancy(),
        )

    def _shard_index(self, key: str) -> int:
        """THE key→shard mapping — the journal hook pairs snapshot
        files with logs by this index, so there must be exactly one
        definition of it."""
        return zlib.crc32(key.encode()) % len(self._shards)

    def _shard(self, key: str) -> RingShard:
        return self._shards[self._shard_index(key)]

    @property
    def shard_count(self) -> int:
        return len(self._shards)

    def shard_state(self, index: int) -> list[tuple]:
        """One shard's resident series as consistent column copies —
        the snapshot writer's read path (ingest/snapshot.py)."""
        return self._shards[index].snapshot_state()

    def push(
        self,
        alias: str,
        times,
        values,
        start: float | None = None,
        end: float | None = None,
        now: float | None = None,
        record_lag: bool = True,
    ) -> int:
        """Direct push API (the receiver, backfill, and tests all land
        here). `alias` is the series identity — a bare selector in any
        label order, or an opaque expression string. `start`/`end`
        bound the batch's authoritative window (backfill); plain pushes
        cover their own sample span, with gaps up to the staleness
        cutoff treated as contiguous. `record_lag=False` keeps a
        backfill of old history from reporting as receiver lag."""
        key = canonical_series(alias)
        idx = self._shard_index(key)
        journal = self.journal
        n = self._shards[idx].push(
            key, times, values, start=start, end=end,
            slack=self.stale_seconds,
            journal=(
                None
                if journal is None
                else lambda k, t, v, s, e: journal(idx, k, t, v, s, e)
            ),
        )
        if n and record_lag:
            now = time.time() if now is None else now
            newest = float(np.max(np.asarray(times, np.int64)))
            with self._lock:
                self._lag["receiver_lag_seconds"] = max(0.0, now - newest)
                self._lag["last_push_at"] = now
        return n

    def push_batch(
        self,
        entries: list[tuple[str, np.ndarray, np.ndarray, float | None]],
        now: float | None = None,
        record_lag: bool = True,
        canonical: bool = False,
    ) -> list[int]:
        """Batch push for decoded wire payloads: ``(key, times, values,
        start)`` tuples (exactly what ``wire.parse_push`` and
        ``wire.decode_frame`` return) are grouped by shard and applied
        with ONE lock acquisition per touched shard (`RingShard.
        push_many`) — a 4k-series frame takes ~`shards` acquisitions
        instead of 4k. Returns per-entry accepted counts aligned with
        ``entries``. ``canonical=True`` skips `canonical_series` (the
        binary codec's keys are canonical by contract; the JSON path
        passes False). One lag sample is recorded for the whole batch."""
        journal = self.journal
        keys = (
            [k for k, _, _, _ in entries]
            if canonical
            else [canonical_series(k) for k, _, _, _ in entries]
        )
        by_shard: dict[int, list[int]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self._shard_index(key), []).append(i)
        counts = [0] * len(entries)
        newest = None
        for idx in sorted(by_shard):
            order = by_shard[idx]
            got = self._shards[idx].push_many(
                [
                    (keys[i], entries[i][1], entries[i][2], entries[i][3], None)
                    for i in order
                ],
                slack=self.stale_seconds,
                journal=(
                    None
                    if journal is None
                    else lambda k, t, v, s, e, _i=idx: journal(_i, k, t, v, s, e)
                ),
            )
            for i, n in zip(order, got):
                counts[i] = n
                if n:
                    m = float(np.max(np.asarray(entries[i][1], np.int64)))
                    newest = m if newest is None else max(newest, m)
        if newest is not None and record_lag:
            now = time.time() if now is None else now
            with self._lock:
                self._lag["receiver_lag_seconds"] = max(0.0, now - newest)
                self._lag["last_push_at"] = now
        return counts

    def query(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float = 60.0,
    ) -> tuple[str, np.ndarray, np.ndarray]:
        return self._shard(key).query(
            key, t0, t1, now, step, self.stale_seconds
        )

    def hist_query(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float = 60.0,
        admit_floor: float = 0.0,
    ) -> tuple:
        """Historical-range read with short-history admission — see
        `RingShard.hist_query`."""
        return self._shard(key).hist_query(
            key, t0, t1, now, step, self.stale_seconds, admit_floor
        )

    def coverage(
        self,
        key: str,
        t0: float | None,
        t1: float | None,
        now: float,
        step: float = 60.0,
    ) -> tuple:
        """Counter-free coverage probe — see `RingShard.coverage`."""
        return self._shard(key).coverage(
            key, t0, t1, now, step, self.stale_seconds
        )

    def evict_unowned(self, owns) -> int:
        """Drop resident series `owns(key)` rejects (mesh rebalance);
        returns how many were evicted across all shards."""
        return sum(s.evict_unowned(owns) for s in self._shards)

    def stats(self) -> dict:
        out = {"series": 0, "bytes": 0}
        out.update(dict.fromkeys(_COUNT_KEYS, 0))
        for shard in self._shards:
            for k, v in shard.stats().items():
                out[k] += v
        out["shards"] = len(self._shards)
        out["budget_bytes"] = self.budget_bytes
        looked = (
            out["hits"] + out["partial"] + out["misses"] + out["stale"]
            + out["uncovered"]
        )
        out["hit_ratio"] = round(out["hits"] / looked, 4) if looked else None
        with self._lock:
            out.update(self._lag)
        return out
