"""The port's instrumentation starter and demo workload
(`foremast_tpu_torch/instrument/`, `foremast_tpu_torch/demo/`) against the
JAX package's.

Every case of `tests/test_instrument.py` has a counterpart here that runs
the same scenario through both packages and holds the port's answers to
JAX's: statuses, bodies, and the exposition (families, label sets, bucket
counts, request counts and sums) line for line. The request timer of both
starters is replaced by one counter that steps 1 ms a reading, so the
histogram's buckets and sums are the same on both sides; only the
`_created` samples, wall-clock stamps, are left out of the comparison.
A seeded random request sequence and `python -m foremast_tpu_torch.demo`
as a process complete the set."""

from __future__ import annotations

import asyncio
import importlib
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("foremast_tpu", "foremast_tpu_torch")


class SteppedTimer:
    """`time` stand-in for the starters: perf_counter steps 1 ms a call."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.001
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def pkgs(monkeypatch):
    """{package: namespace of its starter, instrument and demo modules},
    each starter on its own stepped timer."""
    out = {}
    for name in PACKAGES:
        starter = importlib.import_module(f"{name}.instrument.starter")
        monkeypatch.setattr(starter, "time", SteppedTimer())
        out[name] = types.SimpleNamespace(
            starter=starter,
            instrument=importlib.import_module(f"{name}.instrument"),
            demo=importlib.import_module(f"{name}.demo"),
        )
    return out


def exposition(text: str) -> list[str]:
    """The exposition's lines without the wall-clock `_created` samples."""
    return [ln for ln in text.splitlines() if "_created" not in ln]


def scrape(client) -> str:
    status, body = client.get("/metrics")
    assert status == 200
    return body.decode()


def both(pkgs, scenario):
    """scenario(namespace) on both packages; the port's result, after
    holding it equal to JAX's."""
    got = {name: scenario(ns) for name, ns in pkgs.items()}
    assert got["foremast_tpu_torch"] == got["foremast_tpu"]
    return got["foremast_tpu_torch"]


def count_line(text: str, uri: str, status: str | None = None) -> float:
    """The request count of `uri` (and `status`), summed over its label sets."""
    lines = [
        ln for ln in text.splitlines()
        if ln.startswith("http_server_requests_seconds_count") and f'uri="{uri}"' in ln
        and (status is None or f'status="{status}"' in ln)
    ]
    assert lines, f"no count sample for {uri} {status}"
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in lines)


def demo_client(ns, metrics=None):
    app, m = ns.demo.make_demo_app(metrics)
    return ns.demo.DemoClient(app), m


def test_routes_and_status_codes(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        return [client.get(p) for p in ("/", "/error4xx", "/error5xx")], exposition(scrape(client))

    answers, _ = both(pkgs, scenario)
    assert [s for s, _ in answers] == [200, 404, 500]


def test_metrics_alias_paths(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        client.get("/")
        (s1, b1), (s2, b2) = client.get("/metrics"), client.get("/actuator/prometheus")
        return s1, s2, exposition(b1.decode()), exposition(b2.decode())

    s1, s2, b1, b2 = both(pkgs, scenario)
    assert s1 == s2 == 200 and b1 == b2
    assert any("http_server_requests_seconds" in ln for ln in b1)


def test_common_tags_present(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        client.get("/")
        return exposition(scrape(client))

    assert any('app="spring-boot-demo"' in ln for ln in both(pkgs, scenario))


def test_zero_initialized_statuses(pkgs):
    def scenario(ns):
        return exposition(scrape(demo_client(ns)[0]))

    text = "\n".join(both(pkgs, scenario))
    assert 'status="500"' in text and 'status="404"' in text


def test_request_timing_recorded(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        client.get("/error5xx")
        client.get("/error5xx")
        return exposition(scrape(client))

    assert count_line("\n".join(both(pkgs, scenario)), "/error5xx", "500") == 2.0


def test_caller_tag_from_header(pkgs):
    def scenario(ns):
        metrics = ns.instrument.HttpMetrics(
            ns.instrument.K8sMetricsConfig(common_tags={"app": "x"}, caller_header="X-Caller"))
        client, _ = demo_client(ns, metrics)
        client.get("/", headers={"X-Caller": "checkout-svc"})
        return exposition(scrape(client))

    assert any('caller="checkout-svc"' in ln for ln in both(pkgs, scenario))


def test_runtime_disable_enable(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        client.get("/")
        out = [exposition(scrape(client))]
        out.append(client.get("/k8s-metrics/disable/http_server_requests_seconds"))
        out.append(exposition(scrape(client)))
        out.append(client.get("/k8s-metrics/enable/http_server_requests_seconds"))
        out.append(exposition(scrape(client)))
        out.append(client.get("/k8s-metrics/bogus/x"))
        out.append(client.get("/k8s-metrics/enable/"))
        return out

    on, disabled, off, enabled, on_again, bogus, empty = both(pkgs, scenario)
    assert disabled[0] == 200 and enabled[0] == 200 and bogus[0] == 404 and empty[0] == 404
    assert any("http_server_requests_seconds" in ln for ln in on)
    assert not any("http_server_requests_seconds" in ln for ln in off)
    assert any("http_server_requests_seconds" in ln for ln in on_again)


def test_filter_whitelist_blacklist_prefix(pkgs):
    names = ["anything", "secret_metric", "jvm_threads", "http_server_requests_seconds", "only_this", "other"]

    def scenario(ns):
        cfg = ns.instrument.K8sMetricsConfig
        out = []
        f = ns.instrument.MetricsFilter(cfg(common_tags={}, blacklist={"secret_metric"}))
        out.append([f.visible(n) for n in names])
        f.enable("secret_metric")
        out.append([f.visible(n) for n in names])
        f.disable("anything")
        out.append([f.visible(n) for n in names])
        for kw in ({"hide_prefix": "jvm_"}, {"whitelist": {"only_this"}}):
            g = ns.instrument.MetricsFilter(cfg(common_tags={}, **kw))
            out.append([g.visible(n) for n in names])
            g.enable("other")
            out.append([g.visible(n) for n in names])
        return out

    got = both(pkgs, scenario)
    assert got[0][:2] == [True, False] and got[1][1] is True
    assert got[3][2:4] == [False, True] and got[5][4:] == [True, False]


def test_tag_env_fallback(pkgs, monkeypatch):
    def scenario(ns):
        out = []
        monkeypatch.setenv("K8S_METRICS_COMMON_TAGS", "env:prod , team:sre")
        out.append(ns.instrument.K8sMetricsConfig().common_tags)
        monkeypatch.delenv("K8S_METRICS_COMMON_TAGS")
        monkeypatch.setenv("APP_NAME", "demo-app")
        out.append(ns.instrument.K8sMetricsConfig().common_tags)
        monkeypatch.delenv("APP_NAME")
        out.append(ns.instrument.K8sMetricsConfig().common_tags)
        out.append(ns.starter._parse_pairs("a:1,bad,b:2, :x,c:"))
        return out

    assert both(pkgs, scenario) == [{"env": "prod", "team": "sre"}, {"app": "demo-app"}, {}, {"a": "1", "b": "2"}]


def test_error_generator_burst(pkgs):
    def scenario(ns):
        client, _ = demo_client(ns)
        ns.demo.ErrorGenerator(client, error_type="5xx", frequency=6).burst(6)
        ns.demo.ErrorGenerator(client, error_type="4xx").burst(3)
        return exposition(scrape(client))

    text = "\n".join(both(pkgs, scenario))
    assert count_line(text, "/error5xx", "500") == 6.0
    assert count_line(text, "/error4xx", "404") == 3.0


def test_error_generator_run_for_and_stop(pkgs):
    """`run_for` issues requests at its period until the deadline or
    `stop`; both packages count the same requests with a sleep that
    stops the generator after five."""

    def scenario(ns):
        client, _ = demo_client(ns)
        gen = ns.demo.ErrorGenerator(client, error_type="5xx", frequency=1000.0)
        seen = []

        def sleep(period):
            seen.append(period)
            if len(seen) == 5:
                gen.stop()

        gen.sleep = sleep
        return gen.run_for(60.0), seen, exposition(scrape(client))

    n, seen, _ = both(pkgs, scenario)
    assert n == 5 and seen == [0.001] * 5


def test_file_error_generator_replays_trace(pkgs, tmp_path):
    trace = tmp_path / "trace.csv"
    trace.write_text("2014-02-15 03:00:00,0.2\n2014-02-15 03:01:00,40.134\n\n2014-02-15 03:02:00,1.0\n")

    def scenario(ns):
        client, _ = demo_client(ns)
        gen = ns.demo.FileErrorGenerator(client, str(trace))
        steps = []
        return gen.rates(), gen.replay(step_sleep=steps.append), steps, exposition(scrape(client))

    rates, total, steps, text = both(pkgs, scenario)
    assert rates == [0.2, 40.134, 1.0] and total == 41 and steps == [60.0] * 3
    assert count_line("\n".join(text), "/error5xx") == 41.0


@pytest.mark.parametrize("trace", ["demo_canary_normal.csv", "demo_canary_spike.csv"])
def test_file_error_generator_replays_the_demo_traces(pkgs, trace):
    """The golden canary traces replayed into both starters."""
    path = os.path.join(ROOT, "tests", "data", trace)

    def scenario(ns):
        client, _ = demo_client(ns)
        return ns.demo.FileErrorGenerator(client, path).replay(), exposition(scrape(client))

    total, text = both(pkgs, scenario)
    assert count_line("\n".join(text), "/error5xx") == total > 0


def test_wsgi_streaming_app_records_real_status(pkgs):
    def scenario(ns):
        def streaming_app(environ, start_response):
            def gen():
                start_response("200 OK", [("Content-Type", "text/plain")])
                yield b"chunk1"
                yield b"chunk2"

            return gen()

        metrics = ns.instrument.HttpMetrics(ns.instrument.K8sMetricsConfig(common_tags={"app": "x"}))
        client = ns.demo.DemoClient(ns.starter.wsgi_middleware(streaming_app, metrics))
        return client.get("/stream"), exposition(scrape(client))

    (status, body), text = both(pkgs, scenario)
    assert status == 200 and body == b"chunk1chunk2"
    assert count_line("\n".join(text), "/stream", "200") == 1.0


def test_wsgi_exception_recorded_as_500(pkgs):
    def scenario(ns):
        def crashing_app(environ, start_response):
            raise RuntimeError("boom")

        metrics = ns.instrument.HttpMetrics(ns.instrument.K8sMetricsConfig(common_tags={"app": "x"}))
        app = ns.starter.wsgi_middleware(crashing_app, metrics)
        with pytest.raises(RuntimeError):
            ns.demo.DemoClient(app).get("/crash")
        return exposition(scrape(ns.demo.DemoClient(app)))

    assert count_line("\n".join(both(pkgs, scenario)), "/crash", "500") == 1.0


def test_wsgi_close_records_once(pkgs):
    """A server that closes the body without iterating it records the
    request once, on close, with the status the app gave."""

    def scenario(ns):
        def app(environ, start_response):
            start_response("204 No Content", [])
            return [b""]

        metrics = ns.instrument.HttpMetrics(ns.instrument.K8sMetricsConfig(common_tags={"app": "x"}))
        wrapped = ns.starter.wsgi_middleware(app, metrics)
        result = wrapped({"PATH_INFO": "/closed", "REQUEST_METHOD": "POST"}, lambda *a: None)
        result.close()
        result.close()
        return exposition(metrics.exposition().decode())

    text = "\n".join(both(pkgs, scenario))
    assert count_line(text, "/closed", "204") == 1.0 and 'method="POST"' in text


def test_aiohttp_http_exception_status_not_500(pkgs):
    """Raising web.HTTPNotFound is aiohttp's idiomatic 404, not a 5xx:
    both packages' `instrument_aiohttp` on an app each."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    def scenario(ns):
        async def run():
            async def missing(request):
                raise web.HTTPNotFound()

            async def ok(request):
                return web.Response(text="ok")

            app = web.Application()
            app.router.add_get("/gone", missing)
            app.router.add_get("/ok", ok)
            metrics = ns.instrument.HttpMetrics(
                ns.instrument.K8sMetricsConfig(common_tags={"app": "x"}, caller_header="X-Caller"))
            ns.starter.instrument_aiohttp(app, metrics)
            async with TestClient(TestServer(app)) as client:
                statuses = [(await client.get("/gone")).status,
                            (await client.get("/ok", headers={"X-Caller": "web"})).status,
                            (await client.get("/k8s-metrics/disable/nothing")).status,
                            (await client.get("/k8s-metrics/what/nothing")).status]
                m = await client.get("/actuator/prometheus")
                ctype = m.headers["Content-Type"]
                text = await m.text()
            return statuses, ctype.startswith("text/plain; version="), exposition(text)

        return asyncio.run(run())

    statuses, versioned, text = both(pkgs, scenario)
    assert statuses == [404, 200, 200, 404] and versioned
    lines = [ln for ln in text if ln.startswith("http_server_requests_seconds_count") and 'uri="/gone"' in ln]
    assert lines and all('status="404"' in ln for ln in lines)
    assert not any("k8s-metrics" in ln for ln in text)


def test_seeded_request_sequence_gives_the_same_exposition(pkgs):
    """200 seeded requests (paths, callers, methods and statuses) through
    the demo app of each package, with common tags and zero-initialised
    statuses: the same exposition line for line."""
    rng = np.random.default_rng(18)
    paths = ["/", "/error4xx", "/error5xx", "/orders", "/orders/7"]
    seq = [(paths[int(rng.integers(len(paths)))], f"svc-{int(rng.integers(3))}") for _ in range(200)]

    def scenario(ns):
        cfg = ns.instrument.K8sMetricsConfig(common_tags={"app": "shop", "env": "prod"},
                                             initialize_for_statuses=(404, 500, 503), caller_header="X-Caller")
        client, _ = demo_client(ns, ns.instrument.HttpMetrics(cfg))
        answers = [client.get(p, headers={"X-Caller": c}) for p, c in seq]
        return answers, exposition(scrape(client))

    answers, text = both(pkgs, scenario)
    assert {s for s, _ in answers} == {200, 404, 500}
    assert count_line("\n".join(text), "/error5xx") == sum(p == "/error5xx" for p, _ in seq)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_demo_module_serves_the_app_over_wsgiref():
    """`python -m foremast_tpu_torch.demo --port P` serves /, the error
    endpoints and the exposition over the standard library's wsgiref."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "foremast_tpu_torch.demo", "--port", str(port)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
                    assert r.status == 200 and r.read() == b"ok"
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read().decode()
                time.sleep(0.2)
        codes = []
        for path in ("/error4xx", "/error5xx"):
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert codes == [404, 500]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/actuator/prometheus", timeout=5) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain; version=")
        assert count_line(text, "/error5xx", "500") == 1.0 and 'app="spring-boot-demo"' in text
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_demo_main_flags_match_jax():
    """`main`'s flags, defaults and choices are the JAX demo's."""
    outs = []
    for name in PACKAGES:
        out = subprocess.run([sys.executable, "-m", f"{name}.demo", "--help"], cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    assert outs[0] == outs[1] and "--error-type {none,4xx,5xx}" in outs[1] and "--trace" in outs[1]
