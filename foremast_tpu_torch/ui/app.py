"""Dashboard server — the foremast-browser equivalent (SURVEY.md §2.5), on
the standard library's `ThreadingHTTPServer`.

The port's copy of the JAX package's `foremast_tpu/ui/app.py`, which runs
on aiohttp. The routes, status codes, content types and JSON bodies are
the same:

    GET /                   index.html with the panel config injected
    GET /config             the panel config (JSON)
    GET /healthz            {"ok": true}
    GET /api/v1/panel       one panel's data blob (400 on a bad index or
                            a bad end/window/step)
    GET /static/*           app.js, style.css, index.html
    GET /api/v1/query_range synthetic series, in --demo mode only

The reference UI is a React SPA polling the service's Prometheus query
proxy every 15 s and charting base/upper/lower/anomaly per metric with
synchronized crosshairs (`foremast-browser/src/App.js:14-20,44-78`). This
build serves a dependency-free vanilla-JS/SVG dashboard (static/, byte
for byte the JAX package's files). Unlike the reference (which fetches
and joins in the browser), the data path is server-side: `/api/v1/panel`
fetches a panel's four series through the service's query proxy, scales
them, and joins anomaly events onto the base curve (`ui/join.py`) — so
the one piece of real dashboard logic is executed by the Python test
suite, and the client JS only renders.

Each request runs on its own thread, which takes the place of aiohttp's
event loop. A panel's four fetches run concurrently on the dashboard's
fetch pool; each pool thread keeps its keep-alive connection to the
service endpoint (`httpclient.Session`), as the JAX app's per-panel
client session reuses its connections.

The panel config (which series to chart, scale/unit, poll interval) is
injected server-side into index.html as `window.FOREMAST_CONFIG` —
generated by ui/metrics.py from the same gauge-naming code the engine
publishes with, so the dashboard cannot drift from the engine's series.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import math
import mimetypes
import os
import signal
import threading
import time
import urllib.parse

from foremast_tpu_torch.httpclient import Session
from foremast_tpu_torch.service.app import Response, json_response, make_server
from foremast_tpu_torch.ui.join import panel_payload
from foremast_tpu_torch.ui.metrics import dashboard_config

log = logging.getLogger("foremast_tpu_torch.ui")

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
FETCH_TIMEOUT_SECONDS = 10.0
_TEXT = "text/plain; charset=utf-8"


def render_index(config: dict) -> str:
    with open(os.path.join(STATIC_DIR, "index.html")) as f:
        template = f.read()
    # escape "</" so a hostile app/namespace value can't terminate the
    # <script> block and inject markup ("</script>" breakout)
    blob = json.dumps(config).replace("</", "<\\/")
    return template.replace("__CONFIG__", blob)


def _demo_series(query: str, start: float, end: float, step: float) -> list:
    """Deterministic synthetic series for --demo mode: a daily-ish wave
    with periodic spikes; bound/anomaly series derive from it so every
    panel shows the full base/band/anomaly anatomy."""
    base, amp = (0.25, 0.05) if "latency" in query else (2.0, 0.6)
    is_upper = "_upper" in query
    is_lower = "_lower" in query
    is_anom = "_anomaly" in query

    def spike_val(ts: float) -> float:
        # each spike's measured value differs slightly, like real traffic
        return base + 3 * amp + 0.3 * amp * math.sin(ts / 977.0)

    out = []
    t = math.ceil(start / step) * step
    while t <= end:
        wave = base + amp * math.sin(t / 600.0) + 0.2 * amp * math.sin(t / 97.0)
        spike = int(t) % 1800 < step
        if is_upper:
            v = base + 1.8 * amp
        elif is_lower:
            v = max(base - 1.8 * amp, 0.0)
        elif is_anom:
            # sticky gauge semantics (engine's "last anomalous value",
            # never cleared): present at every scrape since the previous
            # spike, changing value only when a new spike lands
            last_spike = math.floor(t / 1800.0) * 1800.0
            v = spike_val(last_spike)
        else:
            v = spike_val(math.floor(t / 1800.0) * 1800.0) if spike else wave
        out.append([int(t), str(v)])
        t += step
    return out


class Dashboard:
    """The routes over one panel config. `handle(method, target, body)`
    answers a request; `service.app.make_server` puts it behind a socket.
    `close()` stops the fetch pool."""

    def __init__(self, service_endpoint: str, config: dict, demo: bool) -> None:
        self.service_endpoint = service_endpoint
        self.config = config
        self.demo = demo
        self.index_html = render_index(config).encode()
        self.session = Session()
        # 4 threads: one panel's four series at once
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=4, thread_name_prefix="ui-fetch")
        self._routes = {"/": self._index, "/config": self._config, "/healthz": self._healthz,
                        "/api/v1/panel": self._panel}
        if demo:
            self._routes["/api/v1/query_range"] = self._demo_query_range

    def handle(self, method: str, target: str, body: bytes = b"") -> Response:
        path, _, query = target.partition("?")
        path = urllib.parse.unquote(path)
        q: dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True):
            q.setdefault(k, v)  # the first of repeated keys, as aiohttp's query.get
        static = path == "/static" or path.startswith("/static/")
        route = self._routes.get(path)
        if route is None and not static:
            return Response(404, b"404: Not Found", _TEXT)
        if method != "GET":
            return Response(405, b"405: Method Not Allowed", _TEXT)
        if static:
            return self._static(path[len("/static/"):])
        return route(q)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- routes --------------------------------------------------------------

    def _index(self, q) -> Response:
        return Response(200, self.index_html, "text/html; charset=utf-8")

    def _config(self, q) -> Response:
        return json_response(self.config)

    def _healthz(self, q) -> Response:
        return json_response({"ok": True})

    def _static(self, rel: str) -> Response:
        root = os.path.realpath(STATIC_DIR)
        full = os.path.realpath(os.path.join(root, rel))
        if full != root and not full.startswith(root + os.sep):
            return Response(404, b"404: Not Found", _TEXT)
        if os.path.isdir(full):
            return Response(403, b"403: Forbidden", _TEXT)
        if not os.path.isfile(full):
            # aiohttp's static route answers a missing file with an empty body
            return Response(404, b"", "application/octet-stream")
        with open(full, "rb") as f:
            payload = f.read()
        return Response(200, payload, mimetypes.guess_type(full)[0] or "application/octet-stream")

    def _demo_query_range(self, q) -> Response:
        try:
            start = float(q.get("start", 0))
            end = float(q.get("end", 0))
            step = float(q.get("step", 15) or 15)
        except ValueError:
            return json_response({"status": "error", "error": "bad start/end/step"}, status=400)
        if step <= 0 or end - start > 7 * 86400:
            return json_response({"status": "error", "error": "step must be > 0, range <= 7d"}, status=400)
        values = _demo_series(q.get("query", ""), start, end, step)
        return json_response(
            {
                "status": "success",
                "data": {
                    "resultType": "matrix",
                    "result": [{"metric": {}, "values": values}] if values else [],
                },
            }
        )

    def _panel(self, q) -> Response:
        """One panel's full data blob: fetch the four series, scale, join
        anomalies onto the base curve (ui/join.py) — the logic the
        reference UI runs in the browser (App.js:231-260), here on the
        server so it is testable and the JS only renders."""
        panels = self.config["panels"]
        try:
            idx = int(q["i"])
            if not 0 <= idx < len(panels):
                raise IndexError(idx)
            panel_cfg = panels[idx]
        except (KeyError, ValueError, IndexError):
            return json_response({"error": "bad panel index"}, status=400)
        try:
            end = float(q.get("end") or time.time())
            # the range presets pass window/step per request (app.js);
            # clamp to sane bounds so a crafted query can't fan out huge
            # upstream ranges
            window = float(q.get("window") or self.config["windowSeconds"])
            step = float(q.get("step") or self.config["stepSeconds"])
        except ValueError:
            return json_response({"error": "bad end/window/step"}, status=400)
        window = min(max(window, 60.0), 7 * 86400.0)
        step = min(max(step, 1.0), 3600.0)
        start = end - window
        futures = [self._pool.submit(self._fetch_series, s, start, end, step) for s in panel_cfg["series"]]
        pairs = [f.result() for f in futures]
        return json_response(panel_payload(dict(pairs), panel_cfg.get("scale") or 1.0, start, step))

    def _fetch_series(self, series_cfg: dict, start: float, end: float, step: float) -> tuple[str, list]:
        try:
            if self.demo:
                values = _demo_series(series_cfg["query"], start, end, step)
            else:
                params = urllib.parse.urlencode(
                    {"query": series_cfg["query"], "start": start, "end": end, "step": step})
                r = self.session.get(f"{self.service_endpoint}/api/v1/query_range?{params}",
                                     timeout=FETCH_TIMEOUT_SECONDS)
                body = r.json()
                result = (body.get("data") or {}).get("result") or []
                values = result[0]["values"] if result else []
            return series_cfg["type"], [(float(t), float(v)) for t, v in values]
        except Exception as e:  # noqa: BLE001 - render "no data", but leave a trail
            log.warning("series fetch failed (%s): %s", series_cfg["query"], e)
            return series_cfg["type"], []


def make_app(
    service_endpoint: str | None = None,
    namespace: str | None = None,
    app_name: str | None = None,
    demo: bool = False,
) -> Dashboard:
    """Env parity: FOREMAST_SERVICE_ENDPOINT points at the job gateway
    (the reference hardcodes it in App.js:14-20; here it is injected).

    `demo=True` serves a synthetic /api/v1/query_range from this process
    and points the dashboard at itself — a zero-dependency way to see the
    full chart anatomy without Prometheus or the service."""
    if demo:
        service_endpoint = ""  # same-origin: the browser hits this app
    else:
        service_endpoint = service_endpoint or os.environ.get("FOREMAST_SERVICE_ENDPOINT", "http://localhost:8099")
    namespace = namespace or os.environ.get("FOREMAST_UI_NAMESPACE", "foremast-examples")
    app_name = app_name or os.environ.get("FOREMAST_UI_APP", "demo")
    config = dashboard_config(service_endpoint, namespace=namespace, app=app_name)
    return Dashboard(service_endpoint, config, demo)


def serve(host: str = "0.0.0.0", port: int = 8080, **kwargs) -> None:
    """Blocking server on :8080 until SIGTERM or SIGINT, after which it
    returns."""
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
    log.info("dashboard serving on http://%s:%d", host, srv.server_address[1])
    try:
        srv.serve_forever(poll_interval=0.2)
    finally:
        srv.server_close()
        app.close()
