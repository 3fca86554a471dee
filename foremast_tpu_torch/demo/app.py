"""Instrumented demo app + error generators.

The port's copy of the JAX package's `foremast_tpu/demo/app.py`. Parity
with `examples/spring-boot-demo/`:

* ``/error5xx`` throws -> 500 (`controller/QueueController.java:29-32`);
  ``/error4xx`` -> 404; ``/`` -> 200.
* ``ErrorGenerator`` issues error requests at a fixed rate (the
  ``-DerrorType=5xx -Dfrequency=6`` fault injector,
  `error/ErrorGenerator.java:19-28`).
* ``FileErrorGenerator`` replays a CSV trace of per-minute error rates
  (`error/FileErrorGenerator.java:27-37` with the data1/data2 traces) —
  the deterministic canary workload behind the golden-trace tests.

Generators drive the WSGI app in-process through ``DemoClient`` (no
sockets needed); `python -m foremast_tpu_torch.demo` serves it with the
standard library's `wsgiref` for a live cluster demo.
"""

from __future__ import annotations

import io
import threading
import time
from typing import Callable

from foremast_tpu_torch.instrument import HttpMetrics, K8sMetricsConfig, wsgi_middleware


def make_demo_app(metrics: HttpMetrics | None = None):
    """(wsgi_app, metrics): routes /, /error4xx, /error5xx, plus the
    starter's /metrics, /actuator/prometheus, /k8s-metrics/* endpoints."""
    metrics = metrics or HttpMetrics(
        K8sMetricsConfig(
            common_tags={"app": "spring-boot-demo"},
            initialize_for_statuses=(404, 500),
        )
    )

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        if path == "/error5xx":
            # the reference endpoint throws; WSGI surfaces it as a 500
            start_response("500 Internal Server Error", [("Content-Type", "text/plain")])
            return [b"boom"]
        if path == "/error4xx":
            start_response("404 Not Found", [("Content-Type", "text/plain")])
            return [b"nope"]
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"ok"]

    return wsgi_middleware(app, metrics), metrics


class DemoClient:
    """Minimal in-process WSGI client (request-driver for the generators)."""

    def __init__(self, wsgi_app: Callable) -> None:
        self.app = wsgi_app

    def get(self, path: str, headers: dict[str, str] | None = None) -> tuple[int, bytes]:
        environ = {
            "REQUEST_METHOD": "GET",
            "PATH_INFO": path,
            "SERVER_NAME": "demo",
            "SERVER_PORT": "80",
            "wsgi.input": io.BytesIO(),
            "wsgi.errors": io.StringIO(),
            "wsgi.url_scheme": "http",
        }
        for k, v in (headers or {}).items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        captured: dict[str, str] = {}

        def start_response(status, _headers, exc_info=None):
            captured["status"] = status

        body = b"".join(self.app(environ, start_response))
        return int(captured["status"].split(" ", 1)[0]), body


class ErrorGenerator:
    """Fixed-rate fault injector (`ErrorGenerator.java:19-28`):
    ``frequency`` error requests per second of ``error_type`` 4xx|5xx."""

    def __init__(
        self,
        client: DemoClient,
        error_type: str = "5xx",
        frequency: float = 6.0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.client = client
        self.path = "/error5xx" if error_type == "5xx" else "/error4xx"
        self.frequency = frequency
        self.sleep = sleep
        self._stop = threading.Event()

    def run_for(self, seconds: float) -> int:
        """Blocking run; returns the number of requests issued."""
        n = 0
        deadline = time.monotonic() + seconds
        period = 1.0 / self.frequency if self.frequency > 0 else seconds
        while time.monotonic() < deadline and not self._stop.is_set():
            self.client.get(self.path)
            n += 1
            self.sleep(period)
        return n

    def burst(self, count: int) -> None:
        """Issue `count` error requests immediately (test-friendly)."""
        for _ in range(count):
            self.client.get(self.path)

    def stop(self) -> None:
        self._stop.set()


class FileErrorGenerator:
    """CSV-trace replayer (`FileErrorGenerator.java:27-37`).

    Each trace line ``YYYY-MM-DD HH:MM:SS,rate`` maps to one replay step
    issuing ``round(rate)`` error requests — the per-minute error counts
    that produce the data1/data2 canary shapes in Prometheus.
    """

    def __init__(
        self, client: DemoClient, path: str, error_type: str = "5xx"
    ) -> None:
        self.gen = ErrorGenerator(client, error_type=error_type, frequency=0)
        self.path = path

    def rates(self) -> list[float]:
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(float(line.split(",")[1]))
        return out

    def replay(self, step_sleep: Callable[[float], None] | None = None) -> int:
        """Replay the whole trace; returns total requests issued."""
        total = 0
        for rate in self.rates():
            n = round(rate)
            self.gen.burst(n)
            total += n
            if step_sleep:
                step_sleep(60.0)
        return total


def main(argv: list[str] | None = None) -> None:  # pragma: no cover - manual entry
    """Serve the demo app, optionally with a fault injector.

    Flag parity with the reference demo's JVM flags
    (`examples/demo/*/demo_v2.yaml`): `-DerrorType=5xx -Dfrequency=6`
    becomes `--error-type 5xx --frequency 6`; `-Dfilename=data2.txt`
    becomes `--trace <csv>`.
    """
    import argparse
    from wsgiref.simple_server import make_server

    ap = argparse.ArgumentParser(description="instrumented demo workload")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument(
        "--error-type", choices=["none", "4xx", "5xx"], default="none",
        help="background error generator target",
    )
    ap.add_argument(
        "--frequency", type=float, default=6.0, help="error requests/sec"
    )
    ap.add_argument(
        "--trace", default=None,
        help="CSV trace to replay instead of the fixed-rate generator",
    )
    args = ap.parse_args(argv)

    app, _metrics = make_demo_app()
    if args.trace:
        gen = FileErrorGenerator(DemoClient(app), args.trace)
        threading.Thread(target=gen.replay, daemon=True).start()
    elif args.error_type != "none":
        gen = ErrorGenerator(
            DemoClient(app),
            error_type=args.error_type,
            frequency=args.frequency,
        )
        threading.Thread(
            target=gen.run_for, args=(float("inf"),), daemon=True
        ).start()
    print(f"demo app on :{args.port} (/, /error4xx, /error5xx, /metrics)")
    make_server("0.0.0.0", args.port, app).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
