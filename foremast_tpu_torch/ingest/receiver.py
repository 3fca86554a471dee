"""Remote-write receiver + Prometheus exposition of the ingest plane.

The port's copy of the JAX package's `foremast_tpu/ingest/receiver.py`.
`start_ingest_server` serves the push endpoint the way
`observe.spans.start_observe_server` serves the scrape endpoint — a
daemon-threaded `ThreadingHTTPServer`, so each pusher connection gets a
handler thread and the sharded store's per-shard locks absorb the
concurrency:

    POST /api/v1/write   remote-write-style push; TWO codecs on the
                         one route, negotiated by `Content-Type`:
                           - JSON (default / `application/json`):
                             wire.parse_push — the compat codec
                           - binary (`application/x-foremast-remote-
                             write`): wire.decode_frame — the columnar
                             frame decoded as np.frombuffer views
                             straight into the ring columns
                         plus `Content-Encoding: snappy` on either.
                         200 + {"accepted_samples", "series"} on
                         success, 400 with the reason on a malformed
                         payload — one bad entry rejects the batch so
                         pushers notice instead of silently losing
                         series — 413 when the body exceeds the byte
                         cap (`FOREMAST_INGEST_MAX_BODY_BYTES`) or the
                         DECLARED decoded size exceeds
                         `FOREMAST_INGEST_MAX_DECODED_BYTES`, 429 when
                         the receiver sheds overload
    GET  /healthz        liveness + version
    GET  /debug/state    the store's stats (series resident, bytes,
                         evictions, hit ratio, receiver lag) + the
                         per-codec/per-stage wire breakdown

Decode pool: handler threads do socket I/O only; decompress + decode +
apply run on `FOREMAST_INGEST_DECODE_WORKERS` pooled threads (0 =
inline), so decode CPU is bounded by the pool width however many
pusher connections pile up, and a full decode queue sheds 429 exactly
like the inflight cap. Both codecs share ONE apply path
(`RingStore.push_batch` + one response shape), which is what makes
statuses byte-identical across codecs by construction. Per-request
stage timings (read / decompress / decode / apply) accumulate into
`WireStats`, surfaced in /debug/state and the
`foremast_ingest_stage_seconds` / `foremast_ingest_requests` families.

Hardening: handler threads are daemons with a per-connection socket
timeout, request bodies are size-capped BEFORE json.loads (an
oversized push answers 413 without buffering the payload), the binary
path additionally rejects from the DECLARED size in the snappy
preamble / frame header before reading the rest of the body or
decompressing anything (snappy bomb guard — the same no-buffering
contract), and `stop_ingest_server` gives the worker's close path a
bounded drain — stop accepting, wait for in-flight handlers AND
pooled decode jobs up to a deadline, then abandon them to their
daemon fate instead of wedging shutdown. A push that reaches the pool
after close answers 503: it is never half-appended.

`IngestCollector` exports the same stats as the `foremast_ingest_*`
metric families via a custom collector — counters and gauges are
materialized from `RingStore.stats()` at scrape time, so the hot
push/fetch paths never touch prometheus_client.

Reactive plane: with a `dirty` set wired (`reactive.DirtySet`), every
accepted push marks its series' route key dirty so the worker's next
micro-tick judges the affected documents. **Arrival-clock contract:**
the dirty stamp is THIS process's wall clock taken at handler entry,
BEFORE the body is read or parsed (the RECEIVER's arrival instant),
never the pusher's sample timestamps, so the push->verdict latency
(`foremast_verdict_latency_seconds`) measures time spent inside this
system and is immune to client clock skew. Both codecs mark through the
one apply path.

Chaos and tenancy: `chaos` (chaos.EdgeChaos, the ``receiver`` edge)
answers an injected fault as its HTTP status, and `tenancy`
(tenant.TenantRegistry) enforces per-tenant ingest byte-rate envelopes
after decode, shedding the flooding tenant's batches with 429 +
Retry-After while every other tenant's pushes pass.

The JAX receiver's hooks of the worker mesh are left out of
`start_ingest_server`'s signature: the mesh router and the peer-to-peer
transfer endpoint (`router`, `handoff`: ROADMAP.md Queue 1 item 7). The
CLI refuses the mesh.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

from foremast_tpu_torch.ingest.shards import RingStore
from foremast_tpu_torch.ingest.wire import (
    BINARY_CONTENT_TYPE,
    WireError,
    decode_frame,
    frame_decoded_len,
    parse_push,
    snappy_decompress,
    snappy_uncompressed_len,
)

log = logging.getLogger("foremast_tpu_torch.ingest")

WRITE_PATH = "/api/v1/write"
DEFAULT_MAX_BODY_BYTES = 8 * 1024 * 1024
# decoded-size ceiling for the binary path: the snappy preamble / frame
# header DECLARES the decoded size, and anything past this cap is 413'd
# before a byte is decompressed (FOREMAST_INGEST_MAX_DECODED_BYTES)
DEFAULT_MAX_DECODED_BYTES = 32 * 1024 * 1024
# pooled decode worker threads (FOREMAST_INGEST_DECODE_WORKERS; 0 =
# decode inline on the handler thread)
DEFAULT_DECODE_WORKERS = 4
# concurrent push handlers allowed before the receiver sheds with
# 429 + Retry-After (FOREMAST_INGEST_MAX_INFLIGHT; 0 = unbounded)
DEFAULT_MAX_INFLIGHT = 64
# a handler stuck mid-read (pusher died with the body half-sent) frees
# its thread after this instead of holding it forever
HANDLER_TIMEOUT_SECONDS = 30.0

_STAGES = ("read", "decompress", "decode", "apply")


class WireStats:
    """Per-codec, per-stage wall-clock accumulation for the push path.
    One `record` per request, AFTER the shard locks are released — the
    stats lock never nests inside a store lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._codecs: dict[str, dict] = {}

    def record(
        self, codec: str, stages: dict, samples: int, ok: bool
    ) -> None:
        with self._lock:
            c = self._codecs.get(codec)
            if c is None:
                c = self._codecs[codec] = {
                    "requests": 0,
                    "rejected": 0,
                    "samples": 0,
                    "stage_seconds": dict.fromkeys(_STAGES, 0.0),
                }
            c["requests"] += 1
            if not ok:
                c["rejected"] += 1
            c["samples"] += samples
            acc = c["stage_seconds"]
            for stage, seconds in stages.items():
                acc[stage] = acc.get(stage, 0.0) + seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {
                codec: {
                    "requests": c["requests"],
                    "rejected": c["rejected"],
                    "samples": c["samples"],
                    "stage_seconds": dict(c["stage_seconds"]),
                }
                for codec, c in self._codecs.items()
            }


class _PoolClosed(Exception):
    """Submitted after close — the push answers 503 (never half-applied)."""


class _PoolBusy(Exception):
    """Decode queue full — the push answers 429 (pusher retries)."""


class _DecodeJob:
    """One pooled decode+apply. State machine keeps the shutdown
    contract honest: a job is either RUN TO COMPLETION (fully applied,
    200/400 answered) or CANCELLED BEFORE STARTING (503/429) — there is
    no state where half its series landed in the shards."""

    __slots__ = ("fn", "done", "result", "_state", "_lock")
    PENDING, RUNNING, CANCELLED = 0, 1, 2

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self._state = self.PENDING
        self._lock = threading.Lock()

    def try_start(self) -> bool:
        with self._lock:
            if self._state != self.PENDING:
                return False
            self._state = self.RUNNING
            return True

    def try_cancel(self) -> bool:
        with self._lock:
            if self._state != self.PENDING:
                return False
            self._state = self.CANCELLED
            return True


class _DecodePool:
    """Bounded decode worker pool. Width bounds decode CPU (handler
    threads scale with connections; these do not), the queue bounds
    memory, and `close` is the pooled half of the shutdown drain."""

    def __init__(self, workers: int, queue_depth: int | None = None):
        self.workers = max(0, int(workers))
        self._lock = threading.Lock()
        self._closed = False
        self._pending = 0
        self._q: queue.Queue | None = None
        if self.workers:
            self._q = queue.Queue(maxsize=queue_depth or 4 * self.workers)
            for i in range(self.workers):
                threading.Thread(
                    target=self._run,
                    name=f"foremast-ingest-decode-{i}",
                    daemon=True,
                ).start()

    def _admit(self) -> None:
        with self._lock:
            if self._closed:
                raise _PoolClosed
            self._pending += 1

    def _done(self) -> None:
        with self._lock:
            self._pending -= 1

    def run(self, fn, wait_seconds: float = HANDLER_TIMEOUT_SECONDS):
        """Execute `fn` on a pool thread (inline when workers=0) and
        return its result. Raises _PoolClosed after close, _PoolBusy
        when the queue stays full or the job cannot start in time."""
        self._admit()
        if self._q is None:
            try:
                return _run_guarded(fn)
            finally:
                self._done()
        job = _DecodeJob(fn)
        try:
            self._q.put(job, timeout=0.25)
        except queue.Full:
            self._done()
            raise _PoolBusy from None
        if not job.done.wait(wait_seconds):
            if job.try_cancel():
                # never started: nothing applied, safe to shed
                self._done()
                raise _PoolBusy from None
            # already running: the apply itself is bounded, wait it out
            job.done.wait()
        self._done()
        return job.result

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return  # poison pill from close()
            if not job.try_start():
                job.done.set()  # cancelled while queued
                continue
            job.result = _run_guarded(job.fn)
            job.done.set()

    def close(self, deadline: float) -> bool:
        """Stop admitting, wait for pending jobs until the monotonic
        `deadline`, then poison the workers. True when fully drained."""
        with self._lock:
            self._closed = True
        clean = True
        while True:
            with self._lock:
                pending = self._pending
            if pending == 0:
                break
            if time.monotonic() >= deadline:
                log.warning(
                    "ingest decode pool drain timed out with %d job(s) "
                    "pending; abandoning them (daemon threads)",
                    pending,
                )
                clean = False
                break
            time.sleep(0.02)
        if self._q is not None:
            for _ in range(self.workers):
                try:
                    self._q.put_nowait(None)
                except queue.Full:
                    break
        return clean


def _run_guarded(fn):
    """A decode job must always produce an HTTP answer: an unexpected
    exception becomes a logged 500, never a dead handler thread."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — answer, don't die
        log.exception("ingest decode job failed")
        return 500, json.dumps({"reason": str(e)}).encode()


class IngestCollector:
    """prometheus_client custom collector over `RingStore.stats()`."""

    def __init__(self, store: RingStore, book=None, wire: WireStats | None = None):
        self._store = store
        self._book = book
        self._wire = wire

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        s = self._store.stats()
        fetches = CounterMetricFamily(
            "foremast_ingest_fetches",
            "ring TSDB fetch outcomes (hit=resident slice served, "
            "partial=short-history admission slice served, "
            "miss=series not resident, stale=pusher behind the window, "
            "uncovered=resident but not authoritative back to start)",
            labels=["result"],
        )
        for result, count_key in (
            ("hit", "hits"),
            ("partial", "partial"),
            ("miss", "misses"),
            ("stale", "stale"),
            ("uncovered", "uncovered"),
        ):
            fetches.add_metric([result], s[count_key])
        yield fetches
        yield CounterMetricFamily(
            "foremast_ingest_samples",
            "samples accepted by the ingest plane (receiver + direct push)",
            value=s["samples"],
        )
        yield CounterMetricFamily(
            "foremast_ingest_evictions",
            "whole series evicted under FOREMAST_INGEST_BUDGET_BYTES",
            value=s["evictions"],
        )
        yield GaugeMetricFamily(
            "foremast_ingest_series_resident",
            "series currently resident in the ring TSDB",
            value=s["series"],
        )
        yield GaugeMetricFamily(
            "foremast_ingest_bytes_resident",
            "column bytes currently allocated by resident series",
            value=s["bytes"],
        )
        lag = s.get("receiver_lag_seconds")
        yield GaugeMetricFamily(
            "foremast_ingest_receiver_lag_seconds",
            "now minus the newest sample timestamp of the latest push "
            "(-1 until the first push arrives)",
            value=-1.0 if lag is None else lag,
        )
        if self._wire is not None:
            w = self._wire.snapshot()
            requests = CounterMetricFamily(
                "foremast_ingest_requests",
                "push requests decoded by the receiver, by wire codec "
                "(json=compat codec, binary=columnar frame)",
                labels=["codec"],
            )
            stage = CounterMetricFamily(
                "foremast_ingest_stage_seconds",
                "wall-clock seconds spent per receiver pipeline stage "
                "(read / decompress / decode / apply), by wire codec",
                labels=["codec", "stage"],
            )
            for codec in sorted(w):
                requests.add_metric([codec], w[codec]["requests"])
                for st in _STAGES:
                    stage.add_metric(
                        [codec, st],
                        w[codec]["stage_seconds"].get(st, 0.0),
                    )
            yield requests
            yield stage


def start_ingest_server(
    port: int,
    store: RingStore,
    host: str = "0.0.0.0",
    book=None,
    max_body_bytes: int | None = None,
    max_inflight: int | None = None,
    chaos=None,
    degrade_stats=None,
    dirty=None,
    decode_workers: int | None = None,
    max_decoded_bytes: int | None = None,
    tenancy=None,
):
    """Serve the push plane; returns (server, thread). Port 0 binds an
    ephemeral port (tests) — read it back from server.server_address.

    `max_body_bytes` caps request bodies (413 past it); None reads
    `FOREMAST_INGEST_MAX_BODY_BYTES` (default 8 MiB).

    Overload shedding: `max_inflight` bounds concurrent push handlers
    (None reads ``FOREMAST_INGEST_MAX_INFLIGHT``, default 64; 0
    disables) — past it a push is answered 429 + ``Retry-After`` BEFORE
    its body is read, so a pusher flood degrades to client-side
    retry-then-buffer instead of a handler-thread pileup. `chaos`
    (chaos.EdgeChaos) injects latency/errors at the handler seam —
    faults are ANSWERED as their HTTP status, never raised into the
    server loop. `degrade_stats` (chaos.DegradeStats) counts sheds.

    `dirty` (reactive.DirtySet): every entry a push APPLIES samples for
    marks its route key dirty, stamped with the receiver's arrival clock
    (see the module docstring's clock contract): the micro-tick trigger.
    Re-pushes mark too: a last-write-wins revision of an existing
    timestamp is exactly the spike-correction case that must re-judge.
    Only entries the ring wholly ignored (empty sample arrays) mark
    nothing. The contract is codec-independent.

    `decode_workers` / `max_decoded_bytes`: pooled decode width (None
    reads ``FOREMAST_INGEST_DECODE_WORKERS``, default 4; 0 decodes
    inline) and the declared-decoded-size 413 ceiling (None reads
    ``FOREMAST_INGEST_MAX_DECODED_BYTES``, default 32 MiB).

    `tenancy` (tenant.TenantRegistry; None reads the process-global
    ``FOREMAST_TENANTS`` registry): per-tenant ingest byte-rate
    envelopes enforced AFTER decode (tenant identity lives in the series
    labels) and BEFORE apply, on both codecs by construction — a batch
    whose dominant-by-bytes tenant is over its envelope is shed whole
    with 429 + a computed Retry-After charged to THAT tenant, while
    every other tenant's pushes pass. The global inflight cap and
    decode-pool depth remain tenant-blind backstops; decode-pool sheds
    are blamed on the deepest-over-envelope tenant
    (`IngestGovernor.blame`). Unconfigured fleets shed exactly as
    untenanted ones."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if max_body_bytes is None:
        max_body_bytes = int(
            os.environ.get("FOREMAST_INGEST_MAX_BODY_BYTES", "")
            or DEFAULT_MAX_BODY_BYTES
        )
    cap = int(max_body_bytes)
    if max_inflight is None:
        max_inflight = int(
            os.environ.get("FOREMAST_INGEST_MAX_INFLIGHT", "")
            or DEFAULT_MAX_INFLIGHT
        )
    inflight_cap = int(max_inflight)
    if decode_workers is None:
        decode_workers = int(
            os.environ.get("FOREMAST_INGEST_DECODE_WORKERS", "")
            or DEFAULT_DECODE_WORKERS
        )
    if max_decoded_bytes is None:
        max_decoded_bytes = int(
            os.environ.get("FOREMAST_INGEST_MAX_DECODED_BYTES", "")
            or DEFAULT_MAX_DECODED_BYTES
        )
    decoded_cap = int(max_decoded_bytes)
    if tenancy is None:
        from foremast_tpu_torch.tenant.registry import get_tenancy

        tenancy = get_tenancy()
    governor = None
    accounting = None
    if tenancy is not None:
        from foremast_tpu_torch.tenant.accounting import accounting_for
        from foremast_tpu_torch.tenant.envelopes import IngestGovernor

        accounting = accounting_for(tenancy)
        governor = IngestGovernor(tenancy)
    inflight = _Inflight()
    pool = _DecodePool(decode_workers)
    wire_stats = WireStats()
    # bytes -> canonical key str, shared across decode workers. Plain
    # dict on purpose: get/setitem are single-opcode atomic under the
    # GIL, and a racing double-insert writes the identical value.
    intern_cache: dict[bytes, str] = {}

    def decode_apply(raw, codec, snappy_enc, arrived_at, read_s):
        """The pooled stage pipeline: decompress → decode → apply, one
        codec switch and ONE shared apply path (push_batch + response
        shape), so the two codecs cannot drift apart in observable
        behavior. Returns (status, body) or (status, body, headers) —
        the tenant-shed 429 carries its computed Retry-After."""
        stages = {"read": read_s, "decompress": 0.0, "decode": 0.0,
                  "apply": 0.0}
        try:
            if snappy_enc:
                t0 = time.perf_counter()
                raw = snappy_decompress(raw, max_len=decoded_cap)
                stages["decompress"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if codec == "binary":
                entries = decode_frame(
                    raw, intern_cache, canonicalize=True
                )
            else:
                entries = parse_push(json.loads(raw or b"{}"))
            stages["decode"] = time.perf_counter() - t0
        # TypeError/KeyError/AttributeError backstop: a payload shape
        # the codec's explicit checks missed must still be a 400 to the
        # pusher, never a dropped handler thread
        except (WireError, ValueError, TypeError, KeyError,
                AttributeError) as e:
            wire_stats.record(codec, stages, samples=0, ok=False)
            return 400, json.dumps({"reason": str(e)}).encode()
        if governor is not None and entries:
            # tenant admission: post-decode because tenant identity lives
            # in the series labels, pre-apply so a shed batch lands
            # NOTHING. The whole batch is charged to its dominant-by-bytes
            # tenant and shed atomically — re-pushes are idempotent at the
            # ring, and a batching agent that mixes tenants shares the
            # dominant tenant's fate.
            by_tenant: dict[str, int] = {}
            total = 0
            for key, ts, vs, _start in entries:
                nb = int(getattr(ts, "nbytes", 0)) + int(getattr(vs, "nbytes", 0))
                t = tenancy.tenant_of_series(key)
                by_tenant[t] = by_tenant.get(t, 0) + nb
                total += nb
            dominant = max(by_tenant, key=by_tenant.get)
            retry = governor.admit(dominant, total, time.monotonic())
            if retry > 0:
                accounting.count_shed(dominant)
                if degrade_stats is not None:
                    degrade_stats.count_event("receiver", "tenant_shed")
                wire_stats.record(codec, stages, samples=0, ok=False)
                return (
                    429,
                    json.dumps({"reason": "tenant over ingest envelope", "tenant": dominant}).encode(),
                    {"Retry-After": str(int(retry))},
                )
        t0 = time.perf_counter()
        # striped shard-batch apply: one lock acquisition per touched
        # shard for the whole payload (binary keys are canonical out of
        # decode_frame's interning; JSON keys canonicalize in-store)
        counts = store.push_batch(entries, canonical=(codec == "binary"))
        accepted = sum(counts)
        if dirty is not None:
            # ONE arrival instant for the whole batch, taken at handler
            # entry: the latency clock starts when the samples reached
            # us, not when each ring shard finished applying
            for (key, _ts, _vs, _start), n_new in zip(entries, counts):
                if n_new:
                    dirty.mark_series(key, now=arrived_at)
        stages["apply"] = time.perf_counter() - t0
        wire_stats.record(codec, stages, samples=accepted, ok=True)
        body = {"accepted_samples": accepted, "series": len(entries)}
        return 200, json.dumps(body).encode()

    class Handler(BaseHTTPRequestHandler):
        # a half-sent body must free its daemon thread, not hold it
        # until process exit (StreamRequestHandler applies this to the
        # connection socket)
        timeout = HANDLER_TIMEOUT_SECONDS

        def log_message(self, *a):  # push traffic must not spam stderr
            pass

        def _send(
            self,
            code: int,
            body: bytes,
            ctype: str = "application/json",
            headers: dict | None = None,
        ):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            with inflight:
                self._post()

        def _post(self):
            # the arrival instant, BEFORE the body is read or parsed: a
            # near-cap batch on a slow link can spend seconds in read and
            # parse, and that is in-system time the push->verdict latency
            # must charge for
            arrived_at = time.time()
            path = self.path.split("?", 1)[0]
            if path != WRITE_PATH:
                self._send(404, b'{"reason": "not found"}')
                return
            # shed BEFORE reading the body: under overload the cheapest
            # possible answer, and the pusher's buffer (not our heap)
            # holds the samples until the flood passes
            if inflight_cap and inflight.count > inflight_cap:
                if degrade_stats is not None:
                    degrade_stats.count_event("receiver", "shed")
                self._send(
                    429,
                    b'{"reason": "receiver overloaded"}',
                    headers={"Retry-After": "1"},
                )
                return
            if chaos is not None:
                fault = chaos.perturb(path, raise_faults=False)
                if fault is not None:
                    self._send(fault.status, json.dumps({"reason": str(fault)}).encode())
                    return
            length = int(self.headers.get("Content-Length", "0") or 0)
            if length > cap:
                # reject BEFORE buffering: an oversized push must not
                # make this thread read (or json-parse) the whole body
                self._send(
                    413,
                    json.dumps(
                        {
                            "reason": f"body {length} bytes exceeds "
                            f"cap {cap}"
                        }
                    ).encode(),
                )
                return
            ctype = (
                (self.headers.get("Content-Type") or "")
                .split(";", 1)[0]
                .strip()
                .lower()
            )
            codec = "binary" if ctype == BINARY_CONTENT_TYPE else "json"
            enc = (
                (self.headers.get("Content-Encoding") or "identity")
                .strip()
                .lower()
            )
            if enc not in ("", "identity", "snappy"):
                self._send(
                    400,
                    json.dumps(
                        {
                            "reason": f"unsupported Content-Encoding "
                            f"{enc!r} (identity or snappy)"
                        }
                    ).encode(),
                )
                return
            snappy_enc = enc == "snappy"
            peek = b""
            t_read0 = time.perf_counter()
            if snappy_enc or codec == "binary":
                # snappy bomb guard: the DECLARED decoded size lives in
                # the first bytes (snappy varint preamble / FMW1 frame
                # header) — peek it and 413 before reading the rest of
                # the body, let alone decompressing it. A malformed
                # header falls through: the decode stage owns the 400.
                try:
                    peek = self.rfile.read(min(length, 32))
                except OSError:
                    return
                declared = None
                try:
                    declared = (
                        snappy_uncompressed_len(peek)
                        if snappy_enc
                        else frame_decoded_len(peek)
                    )
                except WireError:
                    pass
                if declared is not None and declared > decoded_cap:
                    self._send(
                        413,
                        json.dumps(
                            {
                                "reason": f"declared decoded size "
                                f"{declared} bytes exceeds cap "
                                f"{decoded_cap}"
                            }
                        ).encode(),
                    )
                    return
            try:
                raw = peek + self.rfile.read(length - len(peek))
            except OSError:
                return  # pusher died mid-body; nothing to answer
            read_s = time.perf_counter() - t_read0
            try:
                res = pool.run(
                    lambda: decode_apply(raw, codec, snappy_enc, arrived_at, read_s)
                )
            except _PoolClosed:
                # receiver draining: the job never started, so nothing
                # was applied — the pusher retries
                self._send(
                    503,
                    b'{"reason": "receiver draining"}',
                    headers={"Retry-After": "1"},
                )
                return
            except _PoolBusy:
                if degrade_stats is not None:
                    degrade_stats.count_event("receiver", "decode_shed")
                if governor is not None:
                    # pre-decode shed: no tenant can be KNOWN yet, but the
                    # deepest-over-envelope tenant is the queue pressure's
                    # overwhelmingly likely source — charge it so decode
                    # sheds stay attributed
                    blamed = governor.blame(time.monotonic())
                    if blamed is not None:
                        accounting.count_shed(blamed)
                self._send(
                    429,
                    b'{"reason": "decode queue full"}',
                    headers={"Retry-After": "1"},
                )
                return
            self._send(res[0], res[1], headers=res[2] if len(res) > 2 else None)

        def do_GET(self):
            with inflight:
                self._get()

        def _get(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                from foremast_tpu_torch import __version__

                self._send(
                    200,
                    json.dumps(
                        {"ok": True, "version": __version__}
                    ).encode(),
                )
            elif path == "/debug/state":
                state = store.stats()
                state["wire"] = wire_stats.snapshot()
                if book is not None:
                    state["subscriptions"] = book.snapshot()
                if tenancy is not None:
                    from foremast_tpu_torch.tenant.collector import debug_tenants

                    state["tenants"] = debug_tenants(tenancy, accounting, governor)
                self._send(
                    200, json.dumps(state, default=str, indent=2).encode()
                )
            else:
                self._send(404, b'{"reason": "not found"}')

    srv = ThreadingHTTPServer((host, port), Handler)
    # handler threads must never block interpreter exit (the wedge a
    # mid-shutdown push used to cause), and server_close must not join
    # them — stop_ingest_server does the bounded drain instead
    srv.daemon_threads = True
    srv.block_on_close = False
    srv._foremast_inflight = inflight  # stop_ingest_server reads this
    srv._foremast_decode_pool = pool  # ... and drains this
    srv._foremast_wire_stats = wire_stats  # collectors scrape this
    thread = threading.Thread(
        target=srv.serve_forever, name="foremast-ingest", daemon=True
    )
    thread.start()
    log.info("ingest receiver listening on :%d%s", srv.server_address[1], WRITE_PATH)
    return srv, thread


class _Inflight:
    """Context-managed handler counter the drain path polls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def __enter__(self):
        with self._lock:
            self._count += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._count -= 1
        return False

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


def stop_ingest_server(srv, drain_seconds: float = 5.0) -> bool:
    """Graceful receiver shutdown: stop accepting, drain in-flight
    handlers AND pooled decode jobs up to `drain_seconds`, then abandon
    stragglers (they are daemon threads with socket timeouts — they
    cannot wedge the process). Handlers alone are not enough to count:
    a handler can have handed its frame to a decode worker and be gone,
    so closing on the handler count could close with a batch mid-apply. The pool refuses new jobs the
    moment close starts (those pushes answer 503 with NOTHING applied)
    and started jobs run to completion — a push at shutdown is either
    fully applied or cleanly 503'd, never half-appended. Returns True
    when both drains completed clean."""
    srv.shutdown()  # stop serve_forever; no new connections accepted
    srv.server_close()  # release the listen socket (port reusable now)
    inflight = getattr(srv, "_foremast_inflight", None)
    deadline = time.monotonic() + drain_seconds
    clean = True
    while inflight is not None and inflight.count > 0:
        if time.monotonic() >= deadline:
            log.warning(
                "ingest receiver drain timed out with %d handler(s) "
                "in flight; abandoning them (daemon threads)",
                inflight.count,
            )
            clean = False
            break
        time.sleep(0.02)
    pool = getattr(srv, "_foremast_decode_pool", None)
    if pool is not None:
        clean = pool.close(deadline) and clean
    return clean
