"""Mesh membership: heartbeat documents in the job store.

The port's copy of the JAX package's `foremast_tpu/mesh/membership.py`.
Workers register as documents in the store the fleet's jobs live in (id
``mesh::<worker_id>``, app ``__foremast_mesh__``): the store is the one
piece of shared infrastructure every worker already reaches, so
membership needs no other system. The record's status, ``mesh_member``,
is outside every claimable and terminal set of `jobs/models.py`, so
member documents never reach a claim; discovery is a `list_app` on the
mesh app. The record's JSON is byte for byte the JAX package's, so a
mixed fleet reads both ways.

Liveness is lease based: a member stamps ``renewedAt`` (its own clock)
every ``lease_seconds / 3``, and readers treat a record older than
``lease_seconds`` by THEIR clock as dead. A reader whose clock runs fast
by strictly less than ``2/3 * lease_seconds`` never sees a renewing peer
expire (`CLOCK_SKEW_TOLERANCE_FRACTION`); keep skew at or below half the
lease. A slow reader only delays death detection. The clock is
injectable (the chaos ``clock`` edge skews it: `EdgeChaos.clock()`).

Death is handled lazily: an expired record stops counting in
`live_members`, the hash ring heals around it, and the dead worker's
in-flight claims age out through the store's stuck-claim CAS takeover.
Claim-CAS stays the one safety net against double judgment.

Lifecycle states (planned elasticity, `mesh/handoff.py`):

  * ``active``: claims its partition and takes planned moves;
  * ``draining``: a planned scale-down in flight; it still claims and
    judges its partition, while receivers hint pushers at the post-drain
    owners and it streams its ring series and fits to them;
  * ``joining``: a planned scale-up in flight; its lease counts and its
    record advertises the transfer endpoint, but it is fenced from claims
    until the current owners have streamed it its partition.

A record whose state this build does not know reads as ``active``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time

from foremast_tpu_torch.jobs.models import Document
from foremast_tpu_torch.jobs.store import JobStore

log = logging.getLogger("foremast_tpu_torch.mesh")

# the app every member record shares: the `list_app` discovery key
MESH_APP = "__foremast_mesh__"
# outside the claimable, terminal and in-progress sets: never claimed
STATUS_MESH_MEMBER = "mesh_member"
# a clean leave: the record stays but drops out of membership at once
STATUS_MESH_LEFT = "mesh_left"

STATE_ACTIVE = "active"
STATE_DRAINING = "draining"
STATE_JOINING = "joining"
MEMBER_STATES = (STATE_ACTIVE, STATE_DRAINING, STATE_JOINING)
# the CLAIM ring answers "who judges this doc now" (a draining member
# judges until it leaves; a joining one is fenced); the TARGET ring "who
# owns this key once the planned change completes" (hints, handoff
# destinations, eviction retention)
CLAIM_STATES = frozenset({STATE_ACTIVE, STATE_DRAINING})
TARGET_STATES = frozenset({STATE_ACTIVE, STATE_JOINING})

DEFAULT_LEASE_SECONDS = 15.0
# a fast reader tolerates skew < lease * (1 - 1/3 renewal cadence)
CLOCK_SKEW_TOLERANCE_FRACTION = 2.0 / 3.0


def member_doc_id(worker_id: str) -> str:
    return f"mesh::{worker_id}"


@dataclasses.dataclass(frozen=True)
class MemberRecord:
    """One worker's advertisement: identity, addresses, share weight."""

    worker_id: str
    ingest_address: str = ""  # "host:port" of the push receiver ("" = none)
    observe_port: int = 0  # the worker's /debug/state port
    capacity: int = 1  # hash-ring share weight
    lease_seconds: float = DEFAULT_LEASE_SECONDS
    renewed_at: float = 0.0  # the member's clock, unix seconds
    state: str = STATE_ACTIVE

    def expired(self, now: float) -> bool:
        return now - self.renewed_at > self.lease_seconds

    def to_payload(self) -> str:
        return json.dumps(
            {
                "workerId": self.worker_id,
                "ingestAddress": self.ingest_address,
                "observePort": self.observe_port,
                "capacity": self.capacity,
                "leaseSeconds": self.lease_seconds,
                "renewedAt": self.renewed_at,
                "state": self.state,
            }
        )

    @staticmethod
    def from_payload(raw: str) -> "MemberRecord | None":
        try:
            d = json.loads(raw)
            state = str(d.get("state", STATE_ACTIVE))
            if state not in MEMBER_STATES:
                state = STATE_ACTIVE  # a newer build's state reads as plain membership
            return MemberRecord(
                worker_id=str(d["workerId"]),
                ingest_address=str(d.get("ingestAddress", "")),
                observe_port=int(d.get("observePort", 0)),
                capacity=max(1, int(d.get("capacity", 1))),
                lease_seconds=float(d.get("leaseSeconds", DEFAULT_LEASE_SECONDS)),
                renewed_at=float(d.get("renewedAt", 0.0)),
                state=state,
            )
        except (ValueError, TypeError, KeyError, AttributeError):
            return None  # a corrupt record is a dead record, not a crash


def live_members(store: JobStore, now: float | None = None) -> list[MemberRecord]:
    """Every member whose lease is fresh at `now` (the reader's clock when
    None), sorted by worker id."""
    now = time.time() if now is None else now
    out = []
    for doc in store.list_app(MESH_APP):
        if doc.status != STATUS_MESH_MEMBER:
            continue
        rec = MemberRecord.from_payload(doc.current_config)
        if rec is not None and not rec.expired(now):
            out.append(rec)
    out.sort(key=lambda r: r.worker_id)
    return out


class Membership:
    """This worker's seat: join / renew / leave. Renewals are rate-limited
    to lease/3, so the per-tick `renew()` is almost always a compare."""

    def __init__(
        self,
        store: JobStore,
        worker_id: str,
        lease_seconds: float = DEFAULT_LEASE_SECONDS,
        ingest_address: str = "",
        observe_port: int = 0,
        capacity: int = 1,
        clock=time.time,
        state: str = STATE_ACTIVE,
    ):
        self.store = store
        self.worker_id = worker_id
        self.lease_seconds = float(lease_seconds)
        self.ingest_address = ingest_address
        self.observe_port = int(observe_port)
        self.capacity = max(1, int(capacity))
        self._clock = clock
        self.state = state
        self._doc: Document | None = None
        self._last_renew = 0.0

    def _record(self, now: float) -> MemberRecord:
        return MemberRecord(
            worker_id=self.worker_id,
            ingest_address=self.ingest_address,
            observe_port=self.observe_port,
            capacity=self.capacity,
            lease_seconds=self.lease_seconds,
            renewed_at=now,
            state=self.state,
        )

    def set_state(self, state: str) -> None:
        """Flip the lifecycle state and publish it at once (a forced renew):
        the fence and the hint routing both hang off it."""
        if state not in MEMBER_STATES:
            raise ValueError(f"unknown member state {state!r}")
        if state == self.state:
            return
        self.state = state
        self.renew(force=True)
        log.info("mesh state: %s -> %s", self.worker_id, state)

    def join(self) -> MemberRecord:
        now = self._clock()
        rec = self._record(now)
        doc = Document(
            id=member_doc_id(self.worker_id),
            app_name=MESH_APP,
            status=STATUS_MESH_MEMBER,
            processing_content=self.worker_id,
            current_config=rec.to_payload(),
        )
        # idempotent create, then an unconditional update: a restart that
        # reuses its worker id re-takes its old seat with a fresh lease
        self._doc, _ = self.store.create(doc)
        self._doc.status = STATUS_MESH_MEMBER
        self._doc.current_config = rec.to_payload()
        self._doc = self.store.update(self._doc)
        self._last_renew = now
        log.info("mesh join: %s (lease %.1fs)", self.worker_id, self.lease_seconds)
        return rec

    def renew(self, force: bool = False) -> bool:
        """Refresh the lease once a third of it has passed (or `force`);
        returns whether a store write happened."""
        if self._doc is None:
            self.join()
            return True
        now = self._clock()
        if not force and now - self._last_renew < self.lease_seconds / 3.0:
            return False
        self._doc.current_config = self._record(now).to_payload()
        self._doc = self.store.update(self._doc)
        self._last_renew = now
        return True

    def leave(self) -> None:
        """Clean departure: the record flips to `mesh_left`, so peers drop
        this member at once instead of waiting out the lease."""
        if self._doc is None:
            return
        self._doc.status = STATUS_MESH_LEFT
        try:
            self.store.update(self._doc)
        except Exception as e:  # noqa: BLE001 - leaving must never crash shutdown
            log.warning("mesh leave failed for %s: %s", self.worker_id, e)
        self._doc = None
        log.info("mesh leave: %s", self.worker_id)

    def live_members(self, now: float | None = None) -> list[MemberRecord]:
        return live_members(self.store, self._clock() if now is None else now)
