"""The dirty-series set: the ingest half of the reactive plane.

The port's copy of the JAX package's `foremast_tpu/reactive/dirty.py`.

Detection in a tick-paced worker waits for the next full sweep to claim
a pushed anomaly's document. The ingest plane already KNOWS the instant
a sample arrives (the receiver's handler thread), so this module turns
that arrival into work: the receiver marks the sample's route key dirty,
and the worker drains the dirty set between full ticks through
micro-ticks (`BrainWorker.micro_tick`) that claim JUST the dirty
documents; full ticks demote to repair sweeps that catch whatever
micro-ticks missed.

`DirtySet` is a bounded, lock-guarded, insertion-ordered map of

    route key (an app name, or the whole canonical series key for
    label-less series)  ->  arrival stamp

with these contracts:

  * **Arrival stamps are the RECEIVER's clock.** The stamp is taken when
    the push handler marks the key (`clock()`, wall time on the
    receiving worker), never from the pusher's sample timestamps: the
    push->verdict latency (`foremast_verdict_latency_seconds`) must be
    immune to client clock skew. A pusher replaying yesterday's samples
    measures the time WE took, not the age of its data.
  * **Coalescing keeps the EARLIEST stamp.** Many pushes for one key
    before a drain are one unit of pending work; the latency a verdict
    finally observes is the oldest un-judged arrival's wait, counted on
    ``coalesced``.
  * **Bounded, drop-oldest, never a leak.** Past ``max_keys`` the oldest
    entry drops and is counted on ``dropped``; the full sweep still
    judges those documents on its own cadence, so an overflow degrades
    latency attribution, never correctness.
  * **Ownership-filtered.** With an ``owns`` predicate wired, pushes for
    series another worker owns are counted on ``foreign`` and NOT
    marked: this worker will never be able to claim their documents.

Thread-safety: receiver handler threads mark while the worker's tick
thread takes and requeues; everything sits behind one leaf lock (the
ownership probe runs BEFORE the lock is taken).

The route keys are the worker mesh's (`series_route_key` /
`doc_route_key`, which `mesh/routing.py` re-exports); the CLI wires the
mesh router's `owns_series` as the ``owns`` predicate. With two or more tenants
configured (`tenancy=`), `take` serves tenants deficit-weighted instead
of strictly oldest-first.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from collections import OrderedDict

# the module, not the function: `ingest.wire` reaches the worker (and so
# this module) through `metrics` while it is itself half built
from foremast_tpu_torch.ingest import wire

DEFAULT_DIRTY_MAX = 8_192
DEFAULT_MICROTICK_DOCS = 256
# Sliced, preemptible sweeps: the slice size that bounds a sweep's
# preemption latency; 0 = monolithic sweeps. Resolved here, next to the
# other reactive pacing knobs, so the worker and the CLI's startup log
# share one warn-and-default parser.
DEFAULT_SWEEP_SLICE_DOCS = 2_048
DEFAULT_ROUTE_LABEL = "app"

_EVENTS = (
    "marked", "coalesced", "dropped", "foreign", "requeued",
    "unattributed",
    # sliced-sweep preemption outcomes (worker-side via count()): an
    # arrival triaged at a slice boundary either PROMOTED its pooled
    # documents to the next slice, or was requeued because its document's
    # slice was already in flight (windows possibly pre-arrival, retried
    # once the slice's write releases the doc)
    "promoted", "inflight_requeued",
)

log = logging.getLogger("foremast_tpu_torch.reactive")

# label extraction from a CANONICAL selector (label values are escaped
# and sorted by wire.canonical_series, so a plain scan for
# `label="value"` is exact, not heuristic)
_LABEL_RE_CACHE: dict[str, re.Pattern] = {}


def _label_re(label: str) -> re.Pattern:
    pat = _LABEL_RE_CACHE.get(label)
    if pat is None:
        pat = re.compile(r'[{,]\s*%s="((?:[^"\\]|\\.)*)"' % re.escape(label))
        _LABEL_RE_CACHE[label] = pat
    return pat


def doc_route_key(doc) -> str:
    """A document's partition identity: its app (all of a service's docs
    go together), falling back to the id for app-less docs."""
    return doc.app_name or doc.id


def series_route_key(key: str, route_label: str = DEFAULT_ROUTE_LABEL) -> str:
    """A series' partition identity: the routing label's value when the
    canonical selector carries it, else the whole key."""
    canon = wire.canonical_series(key)
    m = _label_re(route_label).search(canon)
    if m:
        return m.group(1)
    return canon


def _num(raw: str, default, cast, name: str):
    """Warn-and-default numeric env parse: a malformed knob must not kill
    worker startup with a raw traceback."""
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        log.warning("ignoring malformed %s=%r; using %r", name, raw, default)
        return default


def microtick_seconds_from_env() -> float:
    """THE resolution of FOREMAST_MICROTICK_SECONDS (empty = unset, 0 =
    micro-ticks off): one definition so the worker's pacing and the
    CLI's startup log can never report different values."""
    return _num(os.environ.get("FOREMAST_MICROTICK_SECONDS", ""), 0.0, float, "FOREMAST_MICROTICK_SECONDS")


def microtick_docs_from_env() -> int:
    """THE resolution of FOREMAST_MICROTICK_DOCS (dirty route keys
    drained per micro-tick)."""
    return _num(
        os.environ.get("FOREMAST_MICROTICK_DOCS", ""), DEFAULT_MICROTICK_DOCS, int, "FOREMAST_MICROTICK_DOCS"
    )


def sweep_slice_docs_from_env() -> int:
    """THE resolution of FOREMAST_SWEEP_SLICE_DOCS (sweep slice size, 0 =
    monolithic): warn-and-default like every reactive knob, so an empty
    templated value degrades instead of killing worker startup."""
    return _num(
        os.environ.get("FOREMAST_SWEEP_SLICE_DOCS", ""), DEFAULT_SWEEP_SLICE_DOCS, int, "FOREMAST_SWEEP_SLICE_DOCS"
    )


class DirtySet:
    """Bounded arrival ledger keyed by route key; see the module
    docstring."""

    def __init__(
        self,
        max_keys: int = DEFAULT_DIRTY_MAX,
        route_label: str = DEFAULT_ROUTE_LABEL,
        owns=None,
        clock=time.time,
        tenancy=None,
    ):
        self.max_keys = max(1, int(max_keys))
        self.route_label = route_label
        self.owns = owns  # series-key predicate
        self._clock = clock
        self._lock = threading.Lock()
        self._keys: OrderedDict[str, float] = OrderedDict()
        self._counts = dict.fromkeys(_EVENTS, 0)
        # Tenant-fair drain: with >= 2 tenants configured, take() serves
        # tenants deficit-weighted instead of strictly oldest-first, so a
        # whale tenant's backlog cannot starve a quiet tenant's arrival.
        # With one (or zero) tenants, tenancy stays None here and every
        # path below is byte-identical to the untenanted drain (the
        # parity pin).
        self.tenancy = tenancy if tenancy is not None and tenancy.fair else None
        self._tenants: dict[str, str] = {}
        self._drr = None
        if self.tenancy is not None:
            from foremast_tpu_torch.tenant.fairness import DeficitRoundRobin

            self._drr = DeficitRoundRobin(self.tenancy.weights())

    @staticmethod
    def from_env(route_label: str = DEFAULT_ROUTE_LABEL, owns=None, env=None):
        """The set the environment configures; its tenancy is the
        process-global registry (`FOREMAST_TENANTS`, `tenant.get_tenancy`)."""
        from foremast_tpu_torch.tenant.registry import get_tenancy

        e = os.environ if env is None else env
        return DirtySet(
            max_keys=_num(
                e.get("FOREMAST_MICROTICK_DIRTY_MAX", ""), DEFAULT_DIRTY_MAX, int, "FOREMAST_MICROTICK_DIRTY_MAX"
            ),
            route_label=route_label,
            owns=owns,
            tenancy=get_tenancy(),
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    # -- marking (receiver handler threads) -----------------------------

    def mark_series(self, key: str, now: float | None = None) -> bool:
        """Mark one pushed series' route key dirty, stamped with THIS
        process's clock (the receiver's arrival instant). Returns whether
        the key was marked (False = foreign under the ownership
        predicate)."""
        owns = self.owns
        if owns is not None and not owns(key):
            # probe OUTSIDE the dirty lock: the predicate may take its own
            with self._lock:
                self._counts["foreign"] += 1
            return False
        # tenant resolution OUTSIDE the dirty lock too (the registry's
        # cache lock is a peer leaf, never nested under this one)
        tenant = self.tenancy.tenant_of_series(key) if self.tenancy is not None else None
        self.mark(series_route_key(key, self.route_label), self._clock() if now is None else now, tenant=tenant)
        return True

    def mark(self, route_key: str, now: float | None = None, requeue: bool = False,
             tenant: str | None = None) -> None:
        """Insert keeping the EARLIEST stamp; evict the oldest past the
        cap. ``requeue=True`` is the worker giving back an arrival it
        could not attribute yet (released docs, claim brownout): counted
        separately so the marked/coalesced counters stay push-only, and
        re-inserted at the FRONT of the drain order, since its stamp is
        the original (oldest-running) arrival."""
        if now is None:
            now = self._clock()
        with self._lock:
            if tenant is not None:
                self._tenants[route_key] = tenant
            cur = self._keys.get(route_key)
            if cur is not None:
                if now < cur:
                    self._keys[route_key] = now
                if requeue:
                    self._keys.move_to_end(route_key, last=False)
                self._counts["requeued" if requeue else "coalesced"] += 1
                return
            self._keys[route_key] = now
            if requeue:
                self._keys.move_to_end(route_key, last=False)
            self._counts["requeued" if requeue else "marked"] += 1
            while len(self._keys) > self.max_keys:
                old, _ = self._keys.popitem(last=False)
                self._tenants.pop(old, None)
                self._counts["dropped"] += 1

    # -- draining (worker tick thread) ----------------------------------

    def take(self, limit: int) -> list[tuple[str, float]]:
        """Pop up to `limit` entries as (key, stamp): oldest-marked first,
        and — when tenant fairness is active — deficit-weighted across
        tenants so a whale's backlog cannot push a quiet tenant's arrival
        past one drain. Within a tenant the order stays oldest-first; with
        fairness off this is the plain FIFO pop."""
        with self._lock:
            n = min(max(0, int(limit)), len(self._keys))
            if self._drr is None or n == len(self._keys):
                # fairness off, or draining everything anyway: plain FIFO
                # (identical order when every key is served)
                out = [self._keys.popitem(last=False) for _ in range(n)]
            else:
                # group pending keys by tenant (insertion order is
                # preserved per tenant), then serve in DRR order
                queues: dict[str, list[str]] = {}
                for rk in self._keys:
                    t = self._tenants.get(rk, "default")
                    queues.setdefault(t, []).append(rk)
                order = self._drr.pick({t: len(q) for t, q in queues.items()}, n)
                out = []
                for t in order:
                    rk = queues[t].pop(0)
                    out.append((rk, self._keys.pop(rk)))
            # the tenant map survives a take so a worker requeue
            # (mark(..., requeue=True)) keeps its attribution; prune
            # entries for keys no longer pending once it bloats past
            # twice the dirty cap
            if len(self._tenants) > 2 * self.max_keys:
                self._tenants = {rk: t for rk, t in self._tenants.items() if rk in self._keys}
            return out

    def take_all(self) -> list[tuple[str, float]]:
        """Pop everything (the full sweep's catch-all drain)."""
        with self._lock:
            out = list(self._keys.items())
            self._keys.clear()
            return out

    def count(self, event: str, n: int = 1) -> None:
        """Fold a worker-side accounting event (``unattributed``) into the
        shared counter dict so one collector exports them all."""
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + n

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._keys),
                "max_keys": self.max_keys,
                "route_label": self.route_label,
                "owned_only": self.owns is not None,
                "tenant_fair": self._drr is not None,
                **self._counts,
            }


class ReactiveCollector:
    """prometheus_client custom collector over a `DirtySet`: the
    `foremast_microtick_dirty_*` families, materialized at scrape time so
    the push and mark hot path never touches prometheus_client."""

    def __init__(self, dirty: DirtySet):
        self._dirty = dirty

    def collect(self):
        from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

        counts = self._dirty.counts()
        events = CounterMetricFamily(
            "foremast_microtick_dirty_events",
            "dirty-set traffic (marked=new key, coalesced=key already "
            "pending, dropped=evicted past FOREMAST_MICROTICK_DIRTY_MAX, "
            "foreign=owned by another mesh member, requeued=given back "
            "un-judged, unattributed=arrival no judged doc matched, "
            "promoted=sweep slice pulled forward for the arrival, "
            "inflight_requeued=arrival retried behind an in-flight slice)",
            labels=["event"],
        )
        for event in _EVENTS:
            events.add_metric([event], counts.get(event, 0))
        yield events
        yield GaugeMetricFamily(
            "foremast_microtick_dirty_pending",
            "route keys currently pending in the dirty set",
            value=len(self._dirty),
        )
