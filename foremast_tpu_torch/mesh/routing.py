"""Route keys and the router: documents and pushed series -> one owner.

The port's copy of the JAX package's `foremast_tpu/mesh/routing.py`. The
partition unit is the application: `doc_route_key` is a document's app
(every doc of a service lands on one worker, so its fit cache, arena rows
and ring series stay together) and `series_route_key` reads the same
identity off a pushed series' canonical selector through the routing
label (default ``app``, `FOREMAST_MESH_ROUTE_LABEL`). Both are the dirty
set's definitions (`reactive/dirty.py`), so the receiver's marks, the
claim filter and the redirect hints agree by construction. A series
without the label hashes its whole canonical key: a home every worker
agrees on, only not co-resident with a document.

`MeshRouter` holds two rings and swaps them only when the live member
set (or a member's state or capacity) changes, so the per-claim
`owns_doc` filter is a lock, a dict peek and one blake2b hash.

`RoutingPusher` is the mesh-aware push client: it learns each series'
owner from the receivers' `redirects` hints, retries transport failures
and transient statuses with jittered backoff, buffers past the retry
budget, and forgets an address only after `FORGET_AFTER_FAILURES`
consecutive failed cycles. It speaks HTTP through `urllib`.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request

from foremast_tpu_torch.mesh.membership import CLAIM_STATES, TARGET_STATES, MemberRecord, Membership
from foremast_tpu_torch.mesh.partition import HashRing
from foremast_tpu_torch.reactive.dirty import DEFAULT_ROUTE_LABEL, doc_route_key, series_route_key

log = logging.getLogger("foremast_tpu_torch.mesh")

__all__ = ["DEFAULT_ROUTE_LABEL", "MeshRouter", "RoutingPusher", "doc_route_key", "series_route_key"]

DEFAULT_REPLICAS = 64
DEFAULT_REFRESH_SECONDS = 2.0


class MeshRouter:
    """Membership-backed ownership oracle. Thread-safe: the receiver's
    handler threads and the worker's tick thread both consult it.

    The CLAIM ring (states active and draining) answers "who judges this
    document now"; the TARGET ring (active and joining) "who owns this key
    once the planned change completes": it routes redirect hints and picks
    handoff destinations. With no planned change in flight the two rings
    are the same."""

    def __init__(
        self,
        membership: Membership,
        replicas: int = DEFAULT_REPLICAS,
        route_label: str = DEFAULT_ROUTE_LABEL,
        refresh_seconds: float = DEFAULT_REFRESH_SECONDS,
        clock=time.time,
    ):
        self.membership = membership
        self.replicas = int(replicas)
        self.route_label = route_label
        self.refresh_seconds = float(refresh_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring = HashRing((), replicas=self.replicas)
        self._target_ring = HashRing((), replicas=self.replicas)
        self._members: dict[str, MemberRecord] = {}
        self._last_refresh = 0.0
        # rebalances: ring swaps after the first build; redirect_hints and
        # foreign_series: receiver traffic. Monotonic telemetry, bumped
        # without the lock (one writer per key in practice)
        self.counters = {"rebalances": 0, "redirect_hints": 0, "foreign_series": 0}

    @property
    def self_id(self) -> str:
        return self.membership.worker_id

    def refresh(self, force: bool = False) -> bool:
        """Re-list membership (rate-limited) and swap the rings when the
        live set, or any member's state or capacity, changed. Returns True
        on such a change."""
        now = self._clock()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_seconds:
                return False
            self._last_refresh = now
            first = not self._members
        members = {m.worker_id: m for m in self.membership.live_members(now)}
        with self._lock:
            if set(members) == set(self._members) and all(
                members[k].capacity == self._members[k].capacity and members[k].state == self._members[k].state
                for k in members
            ):
                self._members = members  # refreshed addresses and leases
                return False
            old = set(self._members)
            self._members = members
            self._ring = HashRing(
                {m.worker_id: m.capacity for m in members.values() if m.state in CLAIM_STATES},
                replicas=self.replicas,
            )
            self._target_ring = HashRing(
                {m.worker_id: m.capacity for m in members.values() if m.state in TARGET_STATES},
                replicas=self.replicas,
            )
        if not first:
            self.counters["rebalances"] += 1
            log.info("mesh rebalance: members %s -> %s", sorted(old), sorted(members))
        return True

    def members(self) -> list[MemberRecord]:
        with self._lock:
            return sorted(self._members.values(), key=lambda m: m.worker_id)

    def member(self, worker_id: str) -> MemberRecord | None:
        with self._lock:
            return self._members.get(worker_id)

    # -- ownership ------------------------------------------------------

    def owner_of_doc(self, doc) -> str | None:
        with self._lock:
            return self._ring.owner(doc_route_key(doc))

    def owns_doc(self, doc) -> bool:
        # a worker alone on the ring (or with membership unreadable) owns
        # everything: a degraded mesh degrades to one worker's behavior,
        # never to an unclaimable fleet
        with self._lock:
            ring = self._ring
        if len(ring) == 0:
            return True
        return ring.owns(doc_route_key(doc), self.self_id)

    def owner_of_series(self, key: str) -> str | None:
        with self._lock:
            return self._ring.owner(series_route_key(key, self.route_label))

    def owns_series(self, key: str) -> bool:
        with self._lock:
            ring = self._ring
        if len(ring) == 0:
            return True
        return ring.owns(series_route_key(key, self.route_label), self.self_id)

    def retains_series(self, key: str) -> bool:
        """Whether this member's ring should KEEP a resident series: owned
        on the claim ring (served now) or on the target ring (about to be
        owned: a just-transferred series must survive an eviction pass that
        runs while the planned change is in flight)."""
        rk = series_route_key(key, self.route_label)
        with self._lock:
            claim, target = self._ring, self._target_ring
        if len(claim) == 0 and len(target) == 0:
            return True
        return (len(claim) == 0 or claim.owns(rk, self.self_id)) or (
            len(target) > 0 and target.owns(rk, self.self_id)
        )

    def target_owner_of_route(self, route_key: str) -> str | None:
        """The TARGET-ring owner of a route key."""
        with self._lock:
            return self._target_ring.owner(route_key)

    def transfer_target(self, route_key: str) -> str | None:
        """Where a planned change moves this route key: the target-ring
        owner, if this member owns the key on the claim ring now and the
        target ring hands it to someone else; otherwise None."""
        with self._lock:
            claim, target = self._ring, self._target_ring
        if len(claim) == 0 or len(target) == 0:
            return None
        if not claim.owns(route_key, self.self_id):
            return None
        owner = target.owner(route_key)
        return None if owner in (None, self.self_id) else owner

    def redirect_hint(self, key: str) -> str | None:
        """The owner's advertised ingest address for a series this worker
        does NOT own on the target ring (None when owned, when the owner is
        unknown or when it advertises no receiver): during a planned change
        pushers converge on the post-change owner while the transfer is in
        flight. Counts receiver traffic."""
        with self._lock:
            ring = self._target_ring
            if len(ring) == 0:
                ring = self._ring  # degenerate: every member draining
        if len(ring) == 0:
            return None
        owner = ring.owner(series_route_key(key, self.route_label))
        if owner is None or owner == self.self_id:
            return None
        self.counters["foreign_series"] += 1
        rec = self.member(owner)
        if rec is None or not rec.ingest_address:
            return None
        self.counters["redirect_hints"] += 1
        return rec.ingest_address


DEFAULT_PUSH_RETRIES = 2
DEFAULT_PUSH_BACKOFF_SECONDS = 0.2
DEFAULT_PUSH_BUFFER_BYTES = 4 * 1024 * 1024


class _PushRejected(Exception):
    """The receiver answered with a permanent error status (400 malformed,
    413 over the body cap): never retried, never buffered."""

    def __init__(self, code: int):
        super().__init__(f"push rejected with HTTP {code}")
        self.code = code


class RoutingPusher:
    """A mesh-aware push client (tests, benchmarks, sidecar pushers).

    Pushes every series to its learned route (a seed address until a hint
    arrives) and learns from the `redirects` map of each response, so by
    the next cycle every series lands on its owner. A failed POST retries
    with jittered exponential backoff (`retries` attempts past the first);
    past the budget the batch is buffered and re-sent at the front of the
    next cycle, up to `buffer_bytes` (beyond it the oldest buffered series
    drop, counted on ``counters["dropped_series"]``). 429 and 5xx answers
    retry like transport failures; another 4xx is the receiver's verdict on
    the batch: dropped and counted on ``rejected_series``.

    A learned route survives one failed cycle of its address; after
    `FORGET_AFTER_FAILURES` consecutive failed cycles the routes still
    pointing there are forgotten, and a dead fallback seed rotates to the
    next seed (after a drain the departed member's address may be a seed)."""

    FORGET_AFTER_FAILURES = 2

    def __init__(
        self,
        addresses: list[str],
        timeout: float = 10.0,
        retries: int = DEFAULT_PUSH_RETRIES,
        backoff_seconds: float = DEFAULT_PUSH_BACKOFF_SECONDS,
        buffer_bytes: int = DEFAULT_PUSH_BUFFER_BYTES,
        sleep=time.sleep,
        rng=None,
        chaos=None,
    ):
        if not addresses:
            raise ValueError("RoutingPusher needs at least one address")
        self.addresses = list(addresses)
        self.timeout = timeout
        # chaos.EdgeChaos at the POST choke point: injected faults are
        # OSErrors, so they take the retry-then-buffer path of an outage
        self.chaos = chaos
        self.retries = max(0, int(retries))
        self.backoff_seconds = float(backoff_seconds)
        self.buffer_bytes = int(buffer_bytes)
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._route: dict[str, str] = {}  # series key -> "host:port"
        self._seed_idx = 0  # routeless series go to addresses[_seed_idx % n]
        self._addr_fails: dict[str, int] = {}  # consecutive failed cycles
        self._buffer: list[tuple[int, str, dict]] = []  # (bytes, key, entry), oldest first
        self._buffer_nbytes = 0
        self.counters = {
            "retries": 0,
            "buffered_series": 0,
            "resent_series": 0,
            "dropped_series": 0,
            "rejected_series": 0,
        }

    def _post(self, address: str, entries: list[dict]) -> dict:
        from foremast_tpu_torch.ingest.receiver import WRITE_PATH

        if self.chaos is not None:
            self.chaos.perturb(address)
        req = urllib.request.Request(
            f"http://{address}{WRITE_PATH}",
            data=json.dumps({"timeseries": entries}).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _post_with_retry(self, address: str, entries: list[dict]) -> dict | None:
        """POST with jittered exponential backoff; None past the retry
        budget (the caller buffers). Raises `_PushRejected` on a hard 4xx
        (HTTPError is an OSError, so it is told apart first)."""
        for attempt in range(self.retries + 1):
            try:
                return self._post(address, entries)
            except urllib.error.HTTPError as e:
                code = e.code
                e.close()
                if code < 500 and code != 429:
                    self.counters["rejected_series"] += len(entries)
                    raise _PushRejected(code) from None
            except OSError:
                pass
            if attempt == self.retries:
                return None
            self.counters["retries"] += 1
            delay = self.backoff_seconds * (2.0**attempt)
            self._sleep(delay * (0.5 + self._rng.random()))
        return None

    def _buffer_failed(self, keyed: list[tuple[str, dict]]) -> None:
        """Keep a failed batch for the next cycle; past the byte cap the
        OLDEST series drop (recent samples are what recovery needs)."""
        for key, entry in keyed:
            nbytes = len(json.dumps(entry))
            self._buffer.append((nbytes, key, entry))
            self._buffer_nbytes += nbytes
            self.counters["buffered_series"] += 1
        while self._buffer and self._buffer_nbytes > self.buffer_bytes:
            old_bytes, _, _ = self._buffer.pop(0)
            self._buffer_nbytes -= old_bytes
            self.counters["dropped_series"] += 1

    @property
    def buffered(self) -> int:
        return len(self._buffer)

    def push_cycle(self, series: list[tuple[str, list, list, float | None]]) -> dict:
        """One cycle: re-send the buffered backlog first, group by learned
        route, POST (with retry), learn hints. `series` entries are (key,
        times, values, start | None); returns {"accepted", "redirects",
        "errors", "buffered", "rejected", "dropped", "by_address"}."""
        by_addr: dict[str, list[tuple[str, dict]]] = {}
        fallback = self.addresses[self._seed_idx % len(self.addresses)]
        backlog, self._buffer, self._buffer_nbytes = self._buffer, [], 0
        self.counters["resent_series"] += len(backlog)
        for _, key, entry in backlog:
            by_addr.setdefault(self._route.get(key, fallback), []).append((key, entry))
        for key, ts, vs, start in series:
            entry = {"alias": key, "times": list(ts), "values": [float(v) for v in vs]}
            if start is not None:
                entry["start"] = float(start)
            by_addr.setdefault(self._route.get(key, fallback), []).append((key, entry))
        accepted = redirected = errors = rejected = 0
        for addr, keyed in by_addr.items():
            try:
                body = self._post_with_retry(addr, [e for _, e in keyed])
            except _PushRejected:
                # the receiver said no: buffering would re-merge the batch
                # into every later cycle
                errors += 1
                rejected += len(keyed)
                continue
            if body is None:
                errors += 1
                strikes = self._addr_fails.get(addr, 0) + 1
                if len(self._addr_fails) > 256:
                    self._addr_fails.clear()  # crude bound; repopulates
                self._addr_fails[addr] = strikes
                if strikes >= self.FORGET_AFTER_FAILURES:
                    # persistently dead: forget the routes STILL pointing
                    # here (a route re-learned meanwhile is kept)
                    for key, _ in keyed:
                        if self._route.get(key) == addr:
                            self._route.pop(key, None)
                    if addr == fallback:
                        self._seed_idx += 1
                self._buffer_failed(keyed)
                continue
            self._addr_fails.pop(addr, None)
            accepted += int(body.get("accepted_samples", 0))
            for key, owner_addr in (body.get("redirects") or {}).items():
                self._route[key] = owner_addr
                redirected += 1
        return {
            "accepted": accepted,
            "redirects": redirected,
            "errors": errors,
            "buffered": len(self._buffer),
            "rejected": rejected,
            "dropped": self.counters["dropped_series"],
            "by_address": {a: len(e) for a, e in by_addr.items()},
        }
