"""Job stores: the durable queue + state store.

The port's own copy of the JAX package's `foremast_tpu/jobs/store.py`:
the `JobStore` interface and the in-memory backend. (`ElasticsearchStore`
comes with a later slice: its HTTP client is not on the card's machine.)

The reference uses Elasticsearch as both durable queue and state store
(`foremast-service/pkg/search/elasticsearchstore.go:16-19`), with
search-first idempotent creation (`CreateNewDoc`, `:22-62`) and a
`ByStatus` search used by the brain to claim work (`:124-149`).
Semantics preserved here:

  * idempotent create — same id (HMAC of request) never duplicates;
  * claimable = status in {initial, *_inprogress stuck > MAX_STUCK_IN_SECONDS,
    preprocess_completed} — the lease-style work-stealing of
    `design.md:39` / `foremast-brain.yaml:80-81`;
  * claiming is a compare-and-set on (status, modified_at) under one
    lock, so two workers cannot double-claim.
"""

from __future__ import annotations

import threading
import time
from datetime import datetime, timezone

from foremast_tpu_torch.jobs.models import (
    CLAIMABLE_STATUSES,
    STATUS_INITIAL,
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_INPROGRESS,
    TERMINAL_STATUSES,
    Document,
)


def now_rfc3339() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def parse_time(s: str) -> float:
    """Unix-seconds or ISO-8601/RFC3339 (any offset/fraction form) ->
    epoch seconds; 0.0 when empty or unparseable."""
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:
        pass
    try:
        dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    except ValueError:
        return 0.0


class JobStore:
    """Interface: idempotent create, lookup, claim, update."""

    def create(self, doc: Document) -> tuple[Document, bool]:
        """Insert if no document with doc.id exists. Returns
        (stored_document, created) — on conflict the existing doc wins
        (CreateNewDoc search-first, elasticsearchstore.go:22-62)."""
        raise NotImplementedError

    def get(self, doc_id: str) -> Document | None:
        raise NotImplementedError

    def claim(
        self,
        worker_id: str,
        max_stuck_seconds: float,
        limit: int = 64,
        claim_filter=None,
    ) -> list[Document]:
        """Atomically take up to `limit` claimable docs: status==initial or
        preprocess_completed (re-check loop), or in-progress but stuck
        longer than max_stuck_seconds (work stealing).

        `claim_filter` (doc -> bool, optional) restricts WHICH claimable
        docs this worker takes. It runs BEFORE the status flip: a
        filtered doc stays claimable for its owner, it is never parked
        in-progress by a worker that won't judge it."""
        raise NotImplementedError

    def update(self, doc: Document) -> Document:
        raise NotImplementedError

    def update_many(self, docs: list[Document]) -> None:
        """Persist a batch of updated docs. Default: loop over update();
        stores with a cheaper bulk path (one lock, one bulk request)
        override — a fleet tick writes back thousands of docs."""
        for doc in docs:
            self.update(doc)

    def list_open(self) -> list[Document]:
        raise NotImplementedError

    def count_open(self) -> int:
        """Open (non-terminal) document count — the queue-depth varz."""
        return len(self.list_open())


def _is_claimable(doc: Document, now: float, max_stuck: float) -> bool:
    if doc.status in (STATUS_INITIAL, STATUS_PREPROCESS_COMPLETED):
        return True
    if doc.status in TERMINAL_STATUSES:
        return False
    if doc.status in CLAIMABLE_STATUSES:  # *_inprogress
        return now - parse_time(doc.modified_at) > max_stuck
    return False


class InMemoryStore(JobStore):
    def __init__(self):
        self._docs: dict[str, Document] = {}
        self._lock = threading.Lock()

    def create(self, doc: Document) -> tuple[Document, bool]:
        with self._lock:
            existing = self._docs.get(doc.id)
            if existing is not None:
                return existing, False
            doc.created_at = doc.created_at or now_rfc3339()
            doc.modified_at = now_rfc3339()
            self._docs[doc.id] = doc
            return doc, True

    def get(self, doc_id: str) -> Document | None:
        with self._lock:
            return self._docs.get(doc_id)

    def claim(
        self,
        worker_id: str,
        max_stuck_seconds: float,
        limit: int = 64,
        claim_filter=None,
    ):
        now = time.time()
        stamp = now_rfc3339()  # one strftime per claim, not per doc
        out = []
        with self._lock:
            for doc in self._docs.values():
                if len(out) >= limit:
                    break
                # claimability first (cheap), the filter second
                if not _is_claimable(doc, now, max_stuck_seconds):
                    continue
                if claim_filter is None or claim_filter(doc):
                    # flip to in-progress inside the lock so a concurrent
                    # claimer sees the doc as taken (not claimable again
                    # until the stuck timeout)
                    doc.status = STATUS_PREPROCESS_INPROGRESS
                    doc.modified_at = stamp
                    doc.processing_content = worker_id
                    out.append(doc)
        return out

    def update(self, doc: Document) -> Document:
        with self._lock:
            doc.modified_at = now_rfc3339()
            self._docs[doc.id] = doc
            return doc

    def update_many(self, docs: list[Document]) -> None:
        stamp = now_rfc3339()
        with self._lock:
            for doc in docs:
                doc.modified_at = stamp
                self._docs[doc.id] = doc

    def list_open(self):
        with self._lock:
            return [d for d in self._docs.values() if d.status not in TERMINAL_STATUSES]
