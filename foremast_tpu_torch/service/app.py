"""REST job gateway — the foremast-service equivalent, on the standard
library's `ThreadingHTTPServer`.

The port's copy of the JAX package's `foremast_tpu/service/app.py`, which
runs on aiohttp. The routes, status codes and bodies are the same. Route
parity with `foremast-service/cmd/manager/main.go:262-276`:

    POST /v1/healthcheck/create      -> RegisterEntry
    GET  /v1/healthcheck/id/{id}     -> SearchByID
    GET  /api/v1/{queryproxy}        -> CORS Prometheus proxy (UI)

plus the observability surface on top of the reference:

    GET /healthz       liveness + store depth + version
    GET /metrics       Prometheus exposition (request counters + any
                       other family on the process registry); 501 on a
                       host without prometheus_client, where the
                       request counter counts nothing
    GET /debug/state   JSON varz: queue depth, config identity, tracer
                       state

The gateway validates + converts requests (`request_to_document`),
creates jobs idempotently in the store, and serves external-status
views; scoring happens in the BrainWorker against the same store. Every
create stores the request span's trace ID on the document (a fresh one
when tracing is off), so worker ticks and controller polls can be
correlated back to the originating request.

Each request runs on its own thread, which takes the place of the JAX
service's `asyncio.to_thread` around the blocking store calls.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from foremast_tpu_torch import __version__
from foremast_tpu_torch.jobs.convert import InvalidRequest, request_to_document
from foremast_tpu_torch.jobs.models import AnalyzeRequest, document_response, status_to_external
from foremast_tpu_torch.jobs.store import InMemoryStore, JobStore
from foremast_tpu_torch.observe.logs import ctx_log
from foremast_tpu_torch.observe.spans import counter, current_span, new_trace_id

log = logging.getLogger("foremast_tpu_torch.service")

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type",
}
JSON_TYPE = "application/json; charset=utf-8"
# the /healthz depth read's bound: well under kubelet's default probe
# timeoutSeconds=1, so a slow (not down) store degrades the body and
# never fails the probe
DEPTH_TIMEOUT_SECONDS = 0.5

# (method, route pattern, path regex, handler name); a {name} segment
# matches one path segment, as an aiohttp route's does
_ROUTES = [
    ("POST", "/v1/healthcheck/create", "create"),
    ("GET", "/v1/healthcheck/id/{id}", "by_id"),
    ("GET", "/api/v1/{queryproxy}", "query_proxy"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/debug/state", "debug_state"),
]


def _compile(pattern: str) -> re.Pattern:
    return re.compile("^" + re.sub(r"\\{(\w+)\\}", r"(?P<\1>[^/]+)", re.escape(pattern)) + "$")


_COMPILED = [(method, pattern, _compile(pattern), name) for method, pattern, name in _ROUTES]


class Response:
    """One answer: status, headers and body bytes."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, body: bytes = b"", content_type: str = JSON_TYPE, headers=None):
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(obj, status: int = 200, headers=None) -> Response:
    # aiohttp's json_response: json.dumps with its default separators
    return Response(status, json.dumps(obj).encode(), JSON_TYPE, headers)


class Gateway:
    """The routes over one store. `handle(method, target, body)` answers a
    request; `make_server` puts it behind a socket. `query_endpoint`: the
    upstream Prometheus base (QUERY_SERVICE_ENDPOINT env in the
    reference, `main.go:236-243`). `tracer` (observe.spans.Tracer) opens
    one span per request; `registry` scopes the request counter (default:
    the process registry; prometheus_client is imported when the gateway
    is built, never when this module is, and a host without it gets a
    counter that counts nothing: `observe.spans.counter`)."""

    def __init__(
        self,
        store: JobStore | None = None,
        query_endpoint: str | None = None,
        tracer=None,
        registry=None,
    ) -> None:
        self.store = store if store is not None else InMemoryStore()
        self.query_endpoint = query_endpoint or os.environ.get("QUERY_SERVICE_ENDPOINT", "")
        self.tracer = tracer
        self.registry = registry
        self.started = time.time()
        self.requests_total = counter(
            "foremast_service_requests_total",
            "gateway requests by route pattern and status code",
            ("route", "code"),
            registry,
        )
        # the bounded /healthz depth reads run here, so a hung store holds
        # at most these threads
        self._depth_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4, thread_name_prefix="gateway-depth")

    # -- dispatch ------------------------------------------------------------

    @staticmethod
    def match(method: str, path: str):
        """(route pattern, handler name, path params), or the pattern
        "unmatched" with a 404 or 405 handler."""
        allowed = False
        for m, pattern, rx, name in _COMPILED:
            hit = rx.match(path)
            if hit is None:
                continue
            if m == method:
                return pattern, name, hit.groupdict()
            allowed = True
        return "unmatched", ("not_allowed" if allowed else "not_found"), {}

    def handle(self, method: str, target: str, body: bytes = b"") -> Response:
        path, _, query = target.partition("?")
        route, name, params = self.match(method, path)
        cm = None
        if self.tracer is not None:
            cm = self.tracer.span(f"service.{method} {route}", method=method)
            cm.__enter__()
        code = 500
        try:
            resp = getattr(self, "_" + name)(params, query, body)
            code = resp.status
            return resp
        except Exception:  # noqa: BLE001 - a handler fault is a 500, as aiohttp answers it
            log.exception("gateway %s %s failed", method, path)
            return Response(500, b"500 Internal Server Error\n\nServer got itself in trouble", "text/plain; charset=utf-8")
        finally:
            self.requests_total.labels(route=route, code=str(code)).inc()
            if cm is not None:
                cm.__exit__(None, None, None)

    def close(self) -> None:
        self._depth_pool.shutdown(wait=False, cancel_futures=True)

    # -- routes --------------------------------------------------------------

    def _not_found(self, params, query, body) -> Response:
        return Response(404, b"404: Not Found", "text/plain; charset=utf-8")

    def _not_allowed(self, params, query, body) -> Response:
        return Response(405, b"405: Method Not Allowed", "text/plain; charset=utf-8")

    def _create(self, params, query, body) -> Response:
        try:
            payload = json.loads(body)
        except Exception:  # noqa: BLE001 - any undecodable body is the client's
            return json_response({"status": "error", "reason": "invalid JSON"}, status=400)
        try:
            req = AnalyzeRequest.from_json(payload)
            doc = request_to_document(req)
        except (InvalidRequest, ValueError) as e:
            # ValueError covers e.g. an unsupported dataSourceType from
            # build_url — client input, not a server fault
            return json_response({"status": "error", "reason": str(e)}, status=400)
        # correlation ID: the request span's trace ID (or a fresh one when
        # tracing is off) rides on the document through the store
        sp = current_span()
        doc.trace_id = sp.trace_id if sp is not None else new_trace_id()
        stored, created = self.store.create(doc)
        ctx_log(
            log,
            logging.INFO,
            "job created" if created else "job exists",
            job_id=stored.id,
            app=stored.app_name,
            job_trace_id=stored.trace_id,
        )
        # ApplicationHealthAnalyzeResponse shape (models.go:63-80)
        return json_response(
            {
                "jobId": stored.id,
                "statusCode": 201 if created else 208,
                "status": status_to_external(stored.status),
                "reason": "",
            }
        )

    def _by_id(self, params, query, body) -> Response:
        doc = self.store.get(urllib.parse.unquote(params["id"]))
        if doc is None:
            return json_response({"status": "error", "reason": "not found"}, status=404)
        return json_response(document_response(doc))

    def _query_proxy(self, params, query, body) -> Response:
        """GET /api/v1/{queryproxy}: forwards to the query service with
        CORS for the browser UI (`main.go:214-233`)."""
        if not self.query_endpoint:
            return json_response(
                {"status": "error", "reason": "no QUERY_SERVICE_ENDPOINT"}, status=502, headers=CORS_HEADERS
            )
        target = self.query_endpoint.rstrip("/") + "/api/v1/" + params["queryproxy"]
        if query:
            target += "?" + query
        try:
            with urllib.request.urlopen(target, timeout=30.0) as r:
                status, ctype, payload = r.status, r.headers.get_content_type(), r.read()
        except urllib.error.HTTPError as e:
            # the upstream answered: its status and body go back as they are
            status, ctype, payload = e.code, e.headers.get_content_type(), e.read()
            e.close()
        return Response(status, payload, ctype, CORS_HEADERS)

    def store_depth(self) -> int | None:
        """Open (non-terminal) job count; None when the store is
        unreachable or slower than `DEPTH_TIMEOUT_SECONDS`: health reports
        degradation in bounded time, never raises or hangs a probe."""
        try:
            fut = self._depth_pool.submit(self.store.count_open)
            return fut.result(timeout=DEPTH_TIMEOUT_SECONDS)
        except Exception:  # noqa: BLE001
            return None

    def _healthz(self, params, query, body) -> Response:
        depth = self.store_depth()
        return json_response({"ok": True, "version": __version__, "store_depth": depth, "store_ok": depth is not None})

    def _metrics(self, params, query, body) -> Response:
        try:
            from prometheus_client import CONTENT_TYPE_LATEST, REGISTRY, generate_latest
        except ImportError:
            return Response(501, b"501: prometheus_client is not installed", "text/plain; charset=utf-8")

        payload = generate_latest(self.registry if self.registry is not None else REGISTRY)
        return Response(200, payload, CONTENT_TYPE_LATEST.split(";")[0])

    def _debug_state(self, params, query, body) -> Response:
        state = {
            "component": "service",
            "version": __version__,
            "uptime_seconds": round(time.time() - self.started, 1),
            "queue_depth": self.store_depth(),
            "store": type(self.store).__name__,
            "query_endpoint": bool(self.query_endpoint),
        }
        if self.tracer is not None:
            state["trace"] = self.tracer.debug_state()
        return json_response(state)


def make_app(store: JobStore | None = None, query_endpoint: str | None = None, tracer=None, registry=None) -> Gateway:
    return Gateway(store=store, query_endpoint=query_endpoint, tracer=tracer, registry=registry)


def make_server(app: Gateway, host: str = "0.0.0.0", port: int = 8099) -> ThreadingHTTPServer:
    """`app` behind a `ThreadingHTTPServer` (one thread per request;
    port 0 picks a free one). Serve it with `serve_forever()`."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive, as aiohttp's server

        def log_message(self, *a):  # requests are counted, not logged
            pass

        def _dispatch(self, method: str) -> None:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            resp = app.handle(method, self.path, body)
            self.send_response(resp.status)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def do_PATCH(self):
            self._dispatch("PATCH")

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    return srv


def serve(host: str = "0.0.0.0", port: int = 8099, **kwargs) -> None:
    """Blocking server on :8099 (the reference service's port) until
    SIGTERM or SIGINT, after which it returns."""
    app = make_app(**kwargs)
    srv = make_server(app, host, port)

    def _stop(signum, frame):
        # shutdown() waits for serve_forever, which runs on this thread
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    except ValueError:
        pass  # not the main thread (embedded use); the caller stops it
    log.info("gateway serving on http://%s:%d", host, srv.server_address[1])
    try:
        srv.serve_forever(poll_interval=0.2)
    finally:
        srv.server_close()
        app.close()
