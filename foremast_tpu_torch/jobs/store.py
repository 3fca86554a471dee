"""Job stores: the durable queue + state store.

The port's own copy of the JAX package's `foremast_tpu/jobs/store.py`:
the `JobStore` interface, the in-memory backend and `ElasticsearchStore`,
which speaks the ES REST API through the port's standard-library HTTP
session (`foremast_tpu_torch/httpclient.py`; the card's machine has no
`requests`) and sends the JAX store's requests byte for byte.

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
    lock (in memory) or on ES's seq_no/primary_term, so two workers
    cannot double-claim.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from datetime import datetime, timezone

from foremast_tpu_torch.jobs.models import (
    CLAIMABLE_STATUSES,
    INPROGRESS_STATUSES,
    STATUS_INITIAL,
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_INPROGRESS,
    TERMINAL_STATUSES,
    Document,
)
from foremast_tpu_torch.observe.spans import span

log = logging.getLogger("foremast_tpu_torch.jobs.store")


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

    def list_app(self, app_name: str) -> list[Document]:
        """Every open document of one app: mesh membership discovery (the
        member records share one app). Stores with a server-side query
        override it, because a fleet-sized list_open page can starve out a
        handful of member records."""
        return [d for d in self.list_open() if d.app_name == app_name]


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

    def list_app(self, app_name: str) -> list[Document]:
        # one filtered pass, not list_open(): the router refreshes
        # membership every few seconds against a fleet-sized store
        with self._lock:
            return [d for d in self._docs.values() if d.app_name == app_name and d.status not in TERMINAL_STATUSES]


# Explicit mapping for the `documents` index. The claim query depends on
# exact-match `terms` over `status`/`processingContent` and `range`+`sort`
# over `modifiedAt` (see `ElasticsearchStore.claim`); with dynamic mapping
# those land as analyzed `text` and date detection depends on the
# cluster's settings, so the template pins them. Config/content blobs are
# stored but never queried, so they are unindexed.
INDEX_MAPPINGS = {
    "properties": {
        "id": {"type": "keyword"},
        "appName": {"type": "keyword"},
        "status": {"type": "keyword"},
        "statusCode": {"type": "keyword"},
        "strategy": {"type": "keyword"},
        "processingContent": {"type": "keyword"},
        "createdAt": {"type": "date"},
        "modifiedAt": {"type": "date"},
        "startTime": {"type": "date", "ignore_malformed": True},
        "endTime": {"type": "date", "ignore_malformed": True},
        "currentConfig": {"type": "keyword", "index": False, "doc_values": False},
        "baselineConfig": {"type": "keyword", "index": False, "doc_values": False},
        "historicalConfig": {"type": "keyword", "index": False, "doc_values": False},
        "currentMetricStore": {"type": "keyword", "index": False, "doc_values": False},
        "baselineMetricStore": {"type": "keyword", "index": False, "doc_values": False},
        "historicalMetricStore": {"type": "keyword", "index": False, "doc_values": False},
        "reason": {"type": "keyword", "index": False, "doc_values": False},
        "traceId": {"type": "keyword", "index": False, "doc_values": False},
        "anomalyInfo": {"type": "object", "enabled": False},
    }
}


class MappingDivergence(RuntimeError):
    """The live `documents` index mapping contradicts the claim-critical
    field types: a permanent config error (ES cannot retype in place)."""


class ElasticsearchStore(JobStore):
    """ES REST backend (index `documents`, type `document`, as
    `elasticsearchstore.go:16-19`).

    `wait_ready` is the reference's forever-retry connect loop, bounded
    on request (`max_wait` / `stop`), and creates the index with the
    explicit `INDEX_MAPPINGS`; `connect_state` shows its progress on
    `/debug/state`. `session` is any object with the `get / put / post`
    seam of `httpclient.Session` (the default). `chaos` / `breaker` wrap
    the main session once (`chaos.guard.GuardedSession`); the probe
    session that `count_open` uses stays unwrapped so varz reports
    through an outage.
    """

    INDEX = "documents"
    TYPE = "document"

    def __init__(self, endpoint: str, session=None, timeout: float = 10.0, chaos=None, breaker=None):
        from foremast_tpu_torch import httpclient

        self.endpoint = endpoint.rstrip("/")
        self._s = session if session is not None else httpclient.Session()
        # wait_ready's retry-loop progress, replaced (never mutated) so
        # varz threads always read a consistent snapshot
        self.connect_state = {"connected": False, "attempts": 0, "waiting_seconds": 0.0, "last_error": None}
        # probe/varz handlers (count_open) run on their own threads and a
        # session is not thread-safe: they get a session of their own
        # with the main one's headers. Injected test doubles are reused.
        if isinstance(self._s, httpclient.Session):
            self._probe_s = httpclient.Session(headers=self._s.headers)
        else:
            self._probe_s = self._s
        # several probe threads can overlap: serialize their use of it
        self._probe_lock = threading.Lock()
        self.timeout = timeout
        if chaos is not None or breaker is not None:
            from foremast_tpu_torch.chaos.guard import GuardedSession

            self._s = GuardedSession(self._s, chaos=chaos, breaker=breaker)

    def _url(self, *parts: str) -> str:
        return "/".join((self.endpoint, self.INDEX, *parts))

    def wait_ready(self, retry_seconds: float = 3.0, max_wait: float | None = None, stop=None):
        """Block until ES answers and the index is ensured. Returns False
        when `max_wait` seconds elapse or `stop()` turns true. Progress
        is published on `connect_state`."""
        start = time.time()
        attempts = 0
        last_error = None
        # probe with the RAW session, bypassing any chaos/breaker guard:
        # the connect loop's failures must not open the store breaker,
        # and the operator must read the real connection error
        probe_s = getattr(self._s, "inner", self._s)
        while True:
            reachable = False
            attempts += 1
            try:
                r = probe_s.get(self.endpoint, timeout=self.timeout)
                reachable = r.ok
                if not reachable:
                    last_error = f"HTTP {r.status_code}"
            except Exception as e:
                last_error = f"{type(e).__name__}: {e}"
            self.connect_state = {
                "connected": False,
                "attempts": attempts,
                "waiting_seconds": round(time.time() - start, 3),
                "last_error": last_error,
            }
            if reachable:
                # index/mapping problems are CONFIG errors: permanent
                # (4xx, divergence) raises, transient (5xx) retries
                try:
                    self.ensure_index()
                    self.connect_state = {
                        "connected": True,
                        "attempts": attempts,
                        "waiting_seconds": round(time.time() - start, 3),
                        "last_error": None,
                    }
                    return True
                except MappingDivergence:
                    raise
                except Exception as e:
                    status = getattr(getattr(e, "response", None), "status_code", None)
                    if status is not None and 400 <= status < 500 and status != 429:
                        raise
                    last_error = f"ensure_index: {e}"
                    log.warning("ensure_index failed, retrying: %s", e)
            if max_wait is not None and time.time() - start > max_wait:
                return False
            # short sleep slices, so a stop request (SIGTERM during
            # startup) is honored within about a quarter second
            deadline = time.time() + retry_seconds
            while True:
                if stop is not None and stop():
                    return False
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                time.sleep(min(0.25, remaining))

    # claim()'s server-side semantics stand on exactly these field types
    CLAIM_CRITICAL_TYPES = {
        "status": "keyword",
        "processingContent": "keyword",
        "appName": "keyword",
        "createdAt": "date",
        "modifiedAt": "date",
    }

    def ensure_index(self) -> bool:
        """Create the `documents` index with the explicit mappings. An
        existing index answers 400 resource_already_exists; its live
        mapping is then checked against the claim-critical field types
        (`MappingDivergence` on a mismatch) and fields the template
        gained since are added in place (best effort)."""
        r = self._s.put(self._url(), json={"mappings": INDEX_MAPPINGS}, timeout=self.timeout)
        if r.status_code == 400:
            body = {}
            try:
                body = r.json()
            except Exception:
                pass
            err = str(body.get("error", body))
            if "resource_already_exists" not in err:
                r.raise_for_status()
            rm = self._s.get(self._url("_mapping"), timeout=self.timeout)
            rm.raise_for_status()
            props = rm.json().get(self.INDEX, {}).get("mappings", {}).get("properties", {})
            bad = {
                f: (props.get(f) or {}).get("type")
                for f, want in self.CLAIM_CRITICAL_TYPES.items()
                if (props.get(f) or {}).get("type") != want
            }
            if bad:
                raise MappingDivergence(
                    f"index '{self.INDEX}' exists with incompatible mappings "
                    f"{bad}; claim semantics require "
                    f"{self.CLAIM_CRITICAL_TYPES} — reindex required"
                )
            missing = {f: spec for f, spec in INDEX_MAPPINGS["properties"].items() if f not in props}
            if missing:
                pm = self._s.put(self._url("_mapping"), json={"properties": missing}, timeout=self.timeout)
                if pm.status_code >= 400:
                    log.warning(
                        "could not add %s to existing '%s' mapping "
                        "(HTTP %d); new fields will be dynamically mapped",
                        sorted(missing), self.INDEX, pm.status_code,
                    )
            return True
        r.raise_for_status()
        return True

    # -- JobStore -------------------------------------------------------

    def create(self, doc: Document) -> tuple[Document, bool]:
        existing = self.get(doc.id)
        if existing is not None:
            return existing, False
        doc.created_at = doc.created_at or now_rfc3339()
        doc.modified_at = now_rfc3339()
        r = self._s.put(self._url("_doc", doc.id) + "?op_type=create", json=doc.to_json(), timeout=self.timeout)
        if r.status_code == 409:  # lost the race: fetch the winner
            return self.get(doc.id) or doc, False
        r.raise_for_status()
        return doc, True

    def get(self, doc_id: str) -> Document | None:
        r = self._s.get(self._url("_doc", doc_id), timeout=self.timeout)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        body = r.json()
        if not body.get("found"):
            return None
        return Document.from_json(body["_source"])

    def claim(self, worker_id: str, max_stuck_seconds: float, limit: int = 64, claim_filter=None):
        """Claim up to `limit` docs in two round trips: a server-side
        claimability search (fresh work, or in-progress docs older than
        the stuck cutoff, oldest first), then one `_bulk` request with a
        seq_no/primary_term CAS per doc; items another worker won come
        back 409 and are skipped. The page is oversampled (2x limit) and
        its fresh hits shuffled, so concurrent claimers CAS mostly
        disjoint subsets; stuck takeovers keep strict oldest-first
        priority. `claim_filter` applies client-side before the CAS, so
        a filtered doc stays claimable for its owner."""
        now = time.time()
        cutoff = datetime.fromtimestamp(now - max_stuck_seconds, timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        query = {
            "size": min(2 * limit, limit + 512),
            "seq_no_primary_term": True,  # required for the CAS below
            "sort": [{"modifiedAt": {"order": "asc", "unmapped_type": "date"}}],
            "query": {
                "bool": {
                    "should": [
                        {"terms": {"status": [STATUS_INITIAL, STATUS_PREPROCESS_COMPLETED]}},
                        {
                            "bool": {
                                "must": [
                                    {"terms": {"status": list(INPROGRESS_STATUSES)}},
                                    {"range": {"modifiedAt": {"lt": cutoff}}},
                                ]
                            }
                        },
                    ],
                    "minimum_should_match": 1,
                }
            },
        }
        with span("es.claim_search", limit=limit):
            r = self._s.post(self._url("_search"), json=query, timeout=self.timeout)
            r.raise_for_status()
        hits = r.json().get("hits", {}).get("hits", [])
        if len(hits) > limit:
            stuck = [h for h in hits if h["_source"].get("status") in INPROGRESS_STATUSES]
            fresh = [h for h in hits if h["_source"].get("status") not in INPROGRESS_STATUSES]
            random.shuffle(fresh)
            hits = stuck + fresh

        lines: list[str] = []
        docs: list[Document] = []
        for h in hits:
            if len(docs) >= limit:
                break
            doc = Document.from_json(h["_source"])
            if claim_filter is not None and not claim_filter(doc):
                continue
            # defense in depth: a mapping/clock divergence must never
            # double-claim
            if not _is_claimable(doc, now, max_stuck_seconds):
                continue
            doc.status = STATUS_PREPROCESS_INPROGRESS
            doc.modified_at = now_rfc3339()
            doc.processing_content = worker_id
            action: dict = {"index": {"_id": doc.id}}
            if "_seq_no" in h:
                action["index"]["if_seq_no"] = h["_seq_no"]
                action["index"]["if_primary_term"] = h["_primary_term"]
            lines.append(json.dumps(action))
            lines.append(json.dumps(doc.to_json()))
            docs.append(doc)
        if not docs:
            return []
        with span("es.claim_bulk_cas", docs=len(docs)):
            rr = self._s.post(
                self._url("_bulk"),
                data="\n".join(lines) + "\n",
                headers={"Content-Type": "application/x-ndjson"},
                timeout=self.timeout,
            )
            rr.raise_for_status()
        out = []
        for doc, item in zip(docs, rr.json().get("items", [])):
            status = item.get("index", {}).get("status", 500)
            if status in (200, 201):
                out.append(doc)
            elif status != 409:
                # 409 = another worker won; anything else must surface
                raise RuntimeError(f"bulk claim item failed for {doc.id}: {item}")
        return out

    def update(self, doc: Document) -> Document:
        doc.modified_at = now_rfc3339()
        r = self._s.put(self._url("_doc", doc.id), json=doc.to_json(), timeout=self.timeout)
        r.raise_for_status()
        return doc

    def update_many(self, docs: list[Document]) -> None:
        """One `_bulk` request for a whole tick's write-backs (no CAS:
        the docs are this worker's claim; last writer wins, as
        `update`)."""
        if not docs:
            return
        stamp = now_rfc3339()
        lines = []
        for doc in docs:
            doc.modified_at = stamp
            lines.append(json.dumps({"index": {"_id": doc.id}}))
            lines.append(json.dumps(doc.to_json()))
        with span("es.update_bulk", docs=len(docs)):
            r = self._s.post(
                self._url("_bulk"),
                data="\n".join(lines) + "\n",
                headers={"Content-Type": "application/x-ndjson"},
                timeout=self.timeout,
            )
            r.raise_for_status()
        body = r.json()
        if body.get("errors"):
            for item in body.get("items", []):
                info = item.get("index", {})
                if info.get("status", 200) >= 300:
                    raise RuntimeError(f"bulk update item failed for {info.get('_id')}: {item}")

    _OPEN_QUERY = {"bool": {"must_not": {"terms": {"status": list(TERMINAL_STATUSES)}}}}

    def _search_docs(self, query: dict) -> list[Document]:
        r = self._s.post(self._url("_search"), json={"size": 1000, "query": query}, timeout=self.timeout)
        r.raise_for_status()
        return [Document.from_json(h["_source"]) for h in r.json().get("hits", {}).get("hits", [])]

    def list_open(self):
        return self._search_docs(self._OPEN_QUERY)

    def list_app(self, app_name: str) -> list[Document]:
        # a server-side term query, so an app's records are found however
        # many fleet documents share the index
        return self._search_docs(
            {
                "bool": {
                    "must": [{"terms": {"appName": [app_name]}}],
                    "must_not": {"terms": {"status": list(TERMINAL_STATUSES)}},
                }
            }
        )

    def count_open(self) -> int:
        # runs on probe/varz threads: the dedicated probe session (never
        # the tick thread's), serialized by its lock, with a short timeout.
        # _probe_lock exists to serialize the one probe Session between
        # scrape and health threads: the HTTP round trip IS its critical
        # section; worker ticks use the main session, never this lock
        with span("es.count_open"), self._probe_lock:
            # foremast: ignore[blocking-under-lock] — the round trip is the critical section
            r = self._probe_s.post(
                self._url("_count"), json={"query": self._OPEN_QUERY}, timeout=min(self.timeout, 2.0)
            )
            r.raise_for_status()
        return int(r.json().get("count", 0))
