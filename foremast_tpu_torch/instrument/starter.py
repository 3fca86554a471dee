"""HTTP metrics starter: middleware + filter + exposition.

The port's copy of the JAX package's `foremast_tpu/instrument/starter.py`,
with the same classes, paths and exposition. Feature parity with the
reference starter (`foremast-spring-boot-k8s-metrics-starter/README.md:5-15`,
classes under `src/main/java/ai/foremast/metrics/k8s/starter/`):

1. common tags on every sample, including the ``app`` tag the recording
   rules aggregate by, from a ``name:value`` pair list with env fallback
   (K8sMetricsAutoConfiguration.java:66-103);
2. zero-initialized counters for configured HTTP statuses so Prometheus
   scrapes 0 instead of no-data (K8sMetricsAutoConfiguration.java:105-115);
3. the ``/metrics`` -> ``/actuator/prometheus`` URL alias — both paths
   serve the exposition here;
4. caller tag from a configurable request header
   (CallerWebMvcTagsProvider.java);
5. metric hiding with whitelist/blacklist/prefix plus the runtime
   ``/k8s-metrics/{enable|disable}/<metric>`` endpoint
   (CommonMetricsFilter.java:30-76, K8sMetricsEndpoint.java:14-35).

The emitted series is ``http_server_requests_seconds`` (count/sum/bucket)
with {app..., method, uri, status, caller} labels — the Micrometer name the
reference's recording rules consume (`metrics-rules-default.yaml:15-39`).

`prometheus_client` is imported where a registry is built or rendered
(`HttpMetrics`, `MetricsFilter.render`, the exposition responses), and
`aiohttp` only inside `instrument_aiohttp`, never when this module is
imported.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Mapping

METRICS_PATHS = ("/metrics", "/actuator/prometheus")
CONTROL_PREFIX = "/k8s-metrics/"


def _content_type() -> str:
    """The exposition's full content type (incl. version param)."""
    from prometheus_client.exposition import CONTENT_TYPE_LATEST

    return CONTENT_TYPE_LATEST


def _parse_pairs(spec: str) -> dict[str, str]:
    """``"app:demo,env:prod"`` -> {"app": "demo", "env": "prod"}."""
    out: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(":")
        if k and v:
            out[k.strip()] = v.strip()
    return out


class K8sMetricsConfig:
    """The ``k8s.metrics.*`` property surface (starter README:17-33).

    Tag resolution fallback chain (K8sMetricsAutoConfiguration.java:66-103):
    explicit pairs -> ``K8S_METRICS_COMMON_TAGS`` env -> ``{"app": $APP_NAME}``.
    """

    def __init__(
        self,
        common_tags: Mapping[str, str] | None = None,
        initialize_for_statuses: Iterable[int] = (),
        caller_header: str = "",
        whitelist: Iterable[str] = (),
        blacklist: Iterable[str] = (),
        hide_prefix: str = "",
    ) -> None:
        if common_tags is None:
            env = os.environ.get("K8S_METRICS_COMMON_TAGS", "")
            common_tags = _parse_pairs(env) if env else {}
            if "app" not in common_tags and os.environ.get("APP_NAME"):
                common_tags["app"] = os.environ["APP_NAME"]
        self.common_tags = dict(common_tags)
        self.initialize_for_statuses = tuple(initialize_for_statuses)
        self.caller_header = caller_header
        self.whitelist = frozenset(whitelist)
        self.blacklist = frozenset(blacklist)
        self.hide_prefix = hide_prefix


def _base_family(name: str) -> str:
    """Strip sample/companion-family suffixes (incl. the _created gauge
    prometheus_client emits alongside counters/histograms)."""
    return (
        name.removesuffix("_total")
        .removesuffix("_count")
        .removesuffix("_sum")
        .removesuffix("_bucket")
        .removesuffix("_created")
    )


class MetricsFilter:
    """Exposition-time hiding with runtime toggles
    (CommonMetricsFilter.java:30-76).

    Precedence: whitelist (if set, only those families show) > runtime
    enable > blacklist/prefix/runtime-disable.
    """

    def __init__(self, config: K8sMetricsConfig) -> None:
        self.config = config
        self._disabled: set[str] = set()
        self._enabled: set[str] = set()

    def enable(self, metric: str) -> None:
        self._disabled.discard(metric)
        self._enabled.add(metric)

    def disable(self, metric: str) -> None:
        self._enabled.discard(metric)
        self._disabled.add(metric)

    def visible(self, family: str) -> bool:
        cfg = self.config
        if cfg.whitelist:
            return family in cfg.whitelist or family in self._enabled
        if family in self._enabled:
            return True
        if family in self._disabled or family in cfg.blacklist:
            return False
        if cfg.hide_prefix and family.startswith(cfg.hide_prefix):
            return False
        return True

    def render(self, registry) -> bytes:
        """generate_latest with hidden families stripped (block-wise:
        a family's # HELP/# TYPE/samples travel together)."""
        from prometheus_client import generate_latest

        out: list[bytes] = []
        keep = True
        for line in generate_latest(registry).splitlines(keepends=True):
            if line.startswith(b"# HELP ") or line.startswith(b"# TYPE "):
                keep = self.visible(_base_family(line.split()[2].decode()))
            elif not line.startswith(b"#") and line.strip():
                name = line.split(b"{", 1)[0].split(b" ", 1)[0].decode()
                keep = self.visible(_base_family(name))
            if keep:
                out.append(line)
        return b"".join(out)


class HttpMetrics:
    """The ``http_server_requests_seconds`` family with common tags."""

    def __init__(self, config: K8sMetricsConfig | None = None, registry=None) -> None:
        from prometheus_client import CollectorRegistry, Histogram

        self.config = config or K8sMetricsConfig()
        self.registry = registry if registry is not None else CollectorRegistry()
        self.filter = MetricsFilter(self.config)
        tag_names = sorted(self.config.common_tags)
        self._tag_values = [self.config.common_tags[k] for k in tag_names]
        labels = tag_names + ["method", "uri", "status", "caller"]
        self.requests = Histogram(
            "http_server_requests_seconds",
            "HTTP server request duration",
            labels,
            registry=self.registry,
        )
        # zero-init: a sample exists for each configured status before any
        # real traffic, so rate() sees 0 rather than absent data
        for status in self.config.initialize_for_statuses:
            self.requests.labels(*self._tag_values, "GET", "/", str(status), "")

    def observe(self, method: str, uri: str, status: int, seconds: float, caller: str = "") -> None:
        self.requests.labels(*self._tag_values, method, uri, str(status), caller).observe(seconds)

    # -- shared endpoint logic (both middlewares route through this) -----

    def handle_control(self, path: str) -> tuple[int, bytes] | None:
        """``/k8s-metrics/{enable|disable}/<metric>`` -> (status, body),
        or None when path is not a control path."""
        if not path.startswith(CONTROL_PREFIX):
            return None
        rest = path[len(CONTROL_PREFIX):]
        action, _, metric = rest.partition("/")
        if action not in ("enable", "disable") or not metric:
            return 404, b"unknown k8s-metrics action"
        (self.filter.enable if action == "enable" else self.filter.disable)(metric)
        return 200, f"{action}d {metric}".encode()

    def exposition(self) -> bytes:
        return self.filter.render(self.registry)


def wsgi_middleware(app: Callable, metrics: HttpMetrics) -> Callable:
    """Wrap any WSGI app: serves the exposition + control endpoints and
    times every other request into ``http_server_requests_seconds``."""

    def wrapped(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        if path in METRICS_PATHS:
            body = metrics.exposition()
            start_response(
                "200 OK",
                [("Content-Type", _content_type()), ("Content-Length", str(len(body)))],
            )
            return [body]
        ctl = metrics.handle_control(path)
        if ctl is not None:
            status, body = ctl
            start_response(
                f"{status} {'OK' if status == 200 else 'Not Found'}",
                [("Content-Type", "text/plain"), ("Content-Length", str(len(body)))],
            )
            return [body]

        t0 = time.perf_counter()
        captured: dict[str, str] = {}

        def capturing_start_response(status_line, headers, exc_info=None):
            captured["status"] = status_line.split(" ", 1)[0]
            return start_response(status_line, headers, exc_info)

        caller = ""
        if metrics.config.caller_header:
            key = "HTTP_" + metrics.config.caller_header.upper().replace("-", "_")
            caller = environ.get(key, "")

        def record():
            metrics.observe(
                method=environ.get("REQUEST_METHOD", "GET"),
                uri=path,
                status=int(captured.get("status", 500) or 500),
                seconds=time.perf_counter() - t0,
                caller=caller,
            )

        try:
            result = app(environ, capturing_start_response)
        except BaseException:
            record()
            raise
        # PEP 3333 lets the app defer start_response until its result
        # iterable is consumed (streaming apps) — record after iteration,
        # not at call return, so status and duration cover the body
        return _RecordingIterable(result, record)

    return wrapped


class _RecordingIterable:
    """Wraps a WSGI result; fires the record callback exactly once, when
    the response body is exhausted or closed."""

    def __init__(self, result, record):
        self._result = result
        self._record = record
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._record()

    def __iter__(self):
        try:
            yield from self._result
        finally:
            self._finish()

    def close(self):
        try:
            close = getattr(self._result, "close", None)
            if close is not None:
                close()
        finally:
            self._finish()


def instrument_aiohttp(app, metrics: HttpMetrics) -> None:
    """Attach the same behavior to a caller's aiohttp Application:
    middleware timing + /metrics alias + control routes."""
    from aiohttp import web

    @web.middleware
    async def timing(request, handler):
        t0 = time.perf_counter()
        caller = request.headers.get(metrics.config.caller_header, "") if metrics.config.caller_header else ""
        status = 500
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            # raising HTTPNotFound etc. is the idiomatic aiohttp response
            # path, not a server error
            status = e.status
            raise
        finally:
            if request.path not in METRICS_PATHS and not request.path.startswith(CONTROL_PREFIX):
                metrics.observe(request.method, request.path, status, time.perf_counter() - t0, caller)

    async def expo(request):
        # full exposition content type (incl. version param), same as WSGI
        return web.Response(body=metrics.exposition(), headers={"Content-Type": _content_type()})

    async def control(request):
        status, body = metrics.handle_control(request.path)
        return web.Response(body=body, status=status, content_type="text/plain")

    app.middlewares.append(timing)
    for p in METRICS_PATHS:
        app.router.add_get(p, expo)
    app.router.add_get(CONTROL_PREFIX + "{action}/{metric}", control)
