"""`MeshNode`: one worker's seat in the mesh, wired into the tick.

The port's copy of the JAX package's `foremast_tpu/mesh/node.py`. It
composes membership, the router, the worker's ring (optional) and the
handoff plane (optional) behind what the worker loop consumes:

  * ``claim_filter(doc)``: the predicate `JobStore.claim` applies before
    it flips a document in progress, so a worker claims only its
    partition (claim-CAS stays the net for stale views);
  * ``on_tick()``: lease renewal (rate-limited), ring refresh, the
    handoff plane (stream to joiners, activate a fenced join), and on a
    membership change the eviction of ring series this worker neither
    serves nor is about to own;
  * ``stream_drain()`` / ``drain()``: the planned scale-down;
  * ``debug_state()``: the worker's `/debug/state` ``mesh`` section.

`MeshCollector` exports the counters as the `foremast_mesh_*` and
`foremast_handoff_*` families, built at scrape time: nothing on the tick
path touches prometheus_client.
"""

from __future__ import annotations

import logging
import threading
import time

from foremast_tpu_torch.mesh.handoff import RECEIVE_RESULTS, SEND_RESULTS, HandoffManager
from foremast_tpu_torch.mesh.membership import (
    MEMBER_STATES,
    STATE_ACTIVE,
    STATE_DRAINING,
    STATE_JOINING,
    Membership,
)
from foremast_tpu_torch.mesh.routing import MeshRouter

log = logging.getLogger("foremast_tpu_torch.mesh")


class MeshNode:
    def __init__(
        self,
        membership: Membership,
        router: MeshRouter,
        ring_store=None,  # ingest.shards.RingStore (optional)
        clock=time.time,
        handoff: HandoffManager | None = None,
        join_fenced: bool | None = None,
    ):
        """`handoff` mounts the planned-handoff plane; `join_fenced`
        (default: handoff wired) makes `start()` register as a fenced
        ``joining`` member when active peers exist, so the current owners
        stream this worker its partition before it claims."""
        self.membership = membership
        self.router = router
        self.ring_store = ring_store
        self._clock = clock
        self.handoff = handoff
        self.join_fenced = (handoff is not None) if join_fenced is None else bool(join_fenced)
        # claim-filter traffic: owned vs skipped docs seen by claims
        self.claim_counts = {"owned": 0, "skipped": 0}
        self._started = False
        self._drain_out: dict | None = None  # stream_drain's result once it ran
        self._serve_thread: threading.Thread | None = None

    @property
    def worker_id(self) -> str:
        return self.membership.worker_id

    @property
    def state(self) -> str:
        return self.membership.state

    @property
    def draining(self) -> bool:
        return self.membership.state == STATE_DRAINING

    @property
    def joining(self) -> bool:
        return self.membership.state == STATE_JOINING

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self.join_fenced and self.handoff is not None:
            # fence only when there is someone to hand off FROM (a solo first
            # member comes up claiming), and never when re-taking a seat
            # whose lease is still live (a restart with a persisted id: its
            # ring never moved, and fencing would hand its partition away
            # cold)
            records = self.membership.live_members()
            self_alive = any(m.worker_id == self.worker_id for m in records)
            peers = [m for m in records if m.state == STATE_ACTIVE and m.worker_id != self.worker_id]
            if peers and not self_alive:
                self.membership.state = STATE_JOINING
                self.handoff.begin_join({m.worker_id for m in peers})
                log.info("mesh join (fenced): %s waits for handoff from %s (deadline %.1fs)",
                         self.worker_id, sorted(m.worker_id for m in peers), self.handoff.deadline_seconds)
        self.membership.join()
        self.router.refresh(force=True)
        self._started = True

    def close(self) -> None:
        if self._started:
            self.membership.leave()
            self._started = False

    def stream_drain(self) -> dict:
        """The streaming half of a planned scale-down: publish ``draining``
        and stream every owned ring series and fit to its new owner,
        WITHOUT leaving, so the loop keeps claiming and judging the
        partition while the transfer is in flight. Idempotent: a second call
        returns the first call's outcomes. Returns per-target outcomes."""
        if not self._started:
            return {}
        if self._drain_out is not None:
            return self._drain_out
        self.membership.set_state(STATE_DRAINING)
        self.router.refresh(force=True)
        out: dict = {"targets": {}, "state": "drained"}
        if self.handoff is not None:
            # joiners are targets too: the target ring may hand part of this
            # partition to a still-fenced joiner, and a draining member's
            # tick no longer serves joiners
            targets = [
                m
                for m in self.router.members()
                if m.state in (STATE_ACTIVE, STATE_JOINING) and m.worker_id != self.worker_id and m.ingest_address
            ]
            sent = self.handoff.send_all(targets, self.router, self.worker_id)
            out["targets"] = {tid: "ok" if ok else "failed" for tid, ok in sent.items()}
        self._drain_out = out
        return out

    def drain(self) -> dict:
        """Planned scale-down: `stream_drain()` (a no-op if it already ran),
        then leave. Returns the per-target outcomes."""
        if not self._started:
            return self._drain_out or {}
        out = self.stream_drain()
        self.membership.leave()
        self._started = False
        log.info("mesh drain complete: %s (%s)", self.worker_id, out)
        return out

    # -- tick hooks ---------------------------------------------------------

    def on_tick(self) -> None:
        """Called at the top of every worker tick, idle ones too (the lease
        must outlive quiet fleets). Lease and refresh timing run on the
        membership's and the router's own clocks.

        A transient store failure degrades: the lease holds until expiry and
        retries next tick, and the ring keeps its last view (a stale ring
        only mis-scopes claims, and claim-CAS nets double judgment)."""
        if not self._started:
            self.start()
            return
        from foremast_tpu_torch.chaos.degrade import is_transient_error

        try:
            self.membership.renew()
            changed = self.router.refresh()
        except Exception as e:
            if not is_transient_error(e):
                raise
            log.warning("mesh renew/refresh degraded (transient store error: %s); keeping the last ring view", e)
            return
        if self.handoff is not None:
            self._drive_handoff()
        if changed and self.ring_store is not None:
            dropped = self.ring_store.evict_unowned(self._retains)
            if dropped:
                log.info("mesh rebalance: evicted %d series no longer owned by %s", dropped, self.worker_id)

    def _retains(self, key: str) -> bool:
        """Eviction retention: keep a series owned on the claim ring, on the
        target ring, or just transferred here (a transfer may land before
        this router has seen the planned state that justifies it)."""
        if self.handoff is None:
            return self.router.owns_series(key)
        return self.router.retains_series(key) or self.handoff.is_protected(key)

    def _drive_handoff(self) -> None:
        """Per-tick handoff work: an active member streams state to newly
        visible joiners (on a side thread, one stream at a time); a fenced
        joiner activates once every live active member's `done` arrived or
        its deadline passed."""
        handoff = self.handoff
        members = self.router.members()
        handoff.note_members(members)
        handoff.purge_protected()
        if self.membership.state == STATE_ACTIVE:
            t = self._serve_thread
            if t is not None and not t.is_alive():
                self._serve_thread = t = None
            if t is None:
                pending = handoff.pending_joiners(members, self.worker_id)
                if pending:
                    # served even if the send fails: the joiner's deadline
                    # owns the degradation
                    for rec in pending:
                        handoff.mark_served(rec.worker_id)
                    t = threading.Thread(
                        target=handoff.send_all,
                        args=(pending, self.router, self.worker_id),
                        name="handoff-serve",
                        daemon=True,
                    )
                    self._serve_thread = t
                    t.start()
        elif self.membership.state == STATE_JOINING:
            live_active = {m.worker_id for m in members if m.state == STATE_ACTIVE}
            if handoff.join_ready(live_active):
                self.membership.set_state(STATE_ACTIVE)
                self.router.refresh(force=True)
                log.info("mesh join complete: %s active after %.2fs handoff wait",
                         self.worker_id, handoff.join_wait_seconds or 0.0)

    def wait_handoff_streams(self, timeout: float | None = None) -> bool:
        """Block until the in-flight joiner stream (if any) finished: a
        test and benchmark hook; the tick never waits on it."""
        t = self._serve_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def claim_filter(self, doc) -> bool:
        owned = self.router.owns_doc(doc)
        self.claim_counts["owned" if owned else "skipped"] += 1
        return owned

    # -- observability --------------------------------------------------------

    def debug_state(self) -> dict:
        members = self.router.members()
        return {
            "worker_id": self.worker_id,
            "state": self.membership.state,
            "live_members": len(members),
            "members": [
                {
                    "worker_id": m.worker_id,
                    "state": m.state,
                    "ingest_address": m.ingest_address,
                    "observe_port": m.observe_port,
                    "capacity": m.capacity,
                    "lease_seconds": m.lease_seconds,
                    "lease_age_seconds": round(max(0.0, self._clock() - m.renewed_at), 2),
                }
                for m in members
            ],
            "route_label": self.router.route_label,
            "replicas": self.router.replicas,
            "rebalances": self.router.counters["rebalances"],
            "redirect_hints": self.router.counters["redirect_hints"],
            "foreign_series": self.router.counters["foreign_series"],
            "claim_docs": dict(self.claim_counts),
            "handoff": self.handoff.debug_state() if self.handoff is not None else None,
        }


class MeshCollector:
    """prometheus_client custom collector over a `MeshNode`."""

    def __init__(self, node: MeshNode):
        self._node = node

    def collect(self):
        from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

        node = self._node
        members = GaugeMetricFamily(
            "foremast_mesh_members",
            "live mesh members (fresh leases, including this worker), by lifecycle state (active=claiming, "
            "draining=planned scale-down streaming its state out, joining=fenced until handoff completes)",
            labels=["state"],
        )
        by_state = dict.fromkeys(MEMBER_STATES, 0)
        for m in node.router.members():
            by_state[m.state] = by_state.get(m.state, 0) + 1
        for state in MEMBER_STATES:
            members.add_metric([state], by_state[state])
        yield members
        yield CounterMetricFamily(
            "foremast_mesh_rebalances", "hash-ring swaps after membership changes",
            value=node.router.counters["rebalances"],
        )
        yield CounterMetricFamily(
            "foremast_mesh_redirect_hints",
            "receiver responses carrying an owning-member address for a series this worker does not own",
            value=node.router.counters["redirect_hints"],
        )
        claims = CounterMetricFamily(
            "foremast_mesh_claim_docs",
            "documents seen by the partition claim filter, by outcome (owned=claimed here, "
            "skipped=another member's partition)",
            labels=["result"],
        )
        for result, n in node.claim_counts.items():
            claims.add_metric([result], n)
        yield claims
        # zeros when no handoff manager is wired: a stable exposition
        counters = node.handoff.counters_snapshot() if node.handoff is not None else None
        state = CounterMetricFamily(
            "foremast_handoff_state",
            "ring series and fit-cache entries moved by planned handoff, by payload kind and direction",
            labels=["kind", "direction"],
        )
        for kind in ("series", "fits"):
            for direction in ("sent", "received"):
                state.add_metric([kind, direction], counters[f"{kind}_{direction}"] if counters else 0)
        yield state
        transfers = CounterMetricFamily(
            "foremast_handoff_transfers",
            "planned-handoff transfer outcomes by role (send=this member streaming out, receive=transfer "
            "batches applied here); failed/torn/rejected transfers degrade the moved state to a cold refit, "
            "never a wedge",
            labels=["role", "result"],
        )
        for result in SEND_RESULTS:
            transfers.add_metric(["send", result], counters["send"][result] if counters else 0)
        for result in RECEIVE_RESULTS:
            transfers.add_metric(["receive", result], counters["receive"][result] if counters else 0)
        yield transfers
