"""The port's dashboard (`foremast_tpu_torch/ui/`) against the JAX
package's.

Every case of `tests/test_ui.py` has a counterpart here that holds the
port to JAX: the panel config and index page, the anomaly join (on the
golden trace and on 200 seeded random sticky series with left-edge
values, repeats and missing base points), and the server's answers route
for route — status, content type and body of the port's
`ThreadingHTTPServer` against JAX's aiohttp app driven with
`aiohttp.test_utils`, in `--demo` mode and against a loopback upstream
reached through the port's gateway (the 400s, the window and step clamps,
a failed series). The static files are byte-equal to JAX's, so the pins
of `tests/test_ui_js.py` hold for the port's `app.js` too."""

from __future__ import annotations

import asyncio
import csv
import json
import logging
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client import CollectorRegistry

from foremast_tpu.ui import app as jax_app
from foremast_tpu.ui import join as jax_join
from foremast_tpu.ui import metrics as jax_metrics
from foremast_tpu_torch.service.app import make_server
from foremast_tpu_torch.ui import app as port_app
from foremast_tpu_torch.ui import join as port_join
from foremast_tpu_torch.ui import metrics as port_metrics
from tests import test_ui_js
from tests.torch_fake_services import FakePrometheus, serve_fake_prometheus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- drivers: the same GETs to both servers ------------------------------------


def jax_answers(app, targets: list[str]) -> list[tuple]:
    """(status, content type, body) of each GET on JAX's aiohttp app."""

    async def run():
        out = []
        async with TestClient(TestServer(app)) as c:
            for target in targets:
                r = await c.get(target)
                out.append((r.status, r.headers.get("Content-Type"), await r.read()))
        return out

    return asyncio.run(run())


class PortServer:
    """The port's dashboard behind a loopback socket."""

    def __init__(self, dashboard):
        self.dashboard = dashboard
        self.srv = make_server(dashboard, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def get(self, target: str) -> tuple:
        try:
            with urllib.request.urlopen(self.url + target, timeout=30) as r:
                return r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, e.headers.get("Content-Type"), e.read()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.dashboard.close()


def port_answers(dashboard, targets: list[str]) -> list[tuple]:
    srv = PortServer(dashboard)
    try:
        return [srv.get(t) for t in targets]
    finally:
        srv.close()


def same_answers(targets: list[str], **kw) -> list[tuple]:
    """Both servers built with `kw` answer `targets` alike; the answers."""
    want = jax_answers(jax_app.make_app(**kw), targets)
    got = port_answers(port_app.make_app(**kw), targets)
    for t, w, g in zip(targets, want, got):
        assert g == w, t
    return got


def q(path: str, **params) -> str:
    return path + "?" + urllib.parse.urlencode(params)


# -- counterparts of tests/test_ui.py --------------------------------------------


def test_panel_series_names_match_engine_gauges():
    for metric in ("namespace_app_per_pod:http_server_requests_latency", "odd:name-with.dots"):
        p, j = port_metrics.Panel(metric, "X"), jax_metrics.Panel(metric, "X")
        assert p.series("ns1", "app1") == j.series("ns1", "app1")
        assert p.to_json("ns1", "app1") == j.to_json("ns1", "app1")
    series = port_metrics.Panel("namespace_app_per_pod:http_server_requests_latency", "L").series("ns1", "app1")
    assert [s["type"] for s in series] == ["base", "upper", "lower", "anomaly"]
    assert series[1]["name"] == "foremastbrain_namespace_app_per_pod_http_server_requests_latency_upper"


def test_dashboard_config_shape():
    for args, kw in ((("http://svc:8099/",), {"namespace": "n", "app": "a"}), (("",), {}),
                     (("http://x",), {"poll_seconds": 5, "window_seconds": 60, "step_seconds": 1})):
        assert port_metrics.dashboard_config(*args, **kw) == jax_metrics.dashboard_config(*args, **kw)
    assert [(p.metric, p.common_name, p.scale, p.unit) for p in port_metrics.DEFAULT_PANELS] == [
        (p.metric, p.common_name, p.scale, p.unit) for p in jax_metrics.DEFAULT_PANELS]
    with pytest.raises(ValueError):
        port_metrics._validate_panels((port_metrics.Panel("namespace_pod:nope", "Nope"),))


def test_render_index_injects_config():
    for cfg in (port_metrics.dashboard_config("http://svc:8099"),
                port_metrics.dashboard_config("http://svc", namespace="</script><b>", app="a</x")):
        html = port_app.render_index(cfg)
        assert html == jax_app.render_index(cfg)
        assert "__CONFIG__" not in html and "</script><b>" not in html
        start = html.index("window.FOREMAST_CONFIG = ") + len("window.FOREMAST_CONFIG = ")
        assert json.loads(html[start:html.index(";</script>", start)]) == cfg


def test_ui_server_serves_index_config_and_static():
    targets = ["/", "/config", "/healthz", "/static/app.js", "/static/style.css", "/static/index.html",
               "/static/", "/static", "/nope", "/api/v1/query_range", "/static/%2e%2e/app.py"]
    got = same_answers(targets, service_endpoint="http://svc:8099", namespace="n", app_name="a")
    assert [s for s, _, _ in got[:6]] == [200] * 6
    assert b'"serviceEndpoint": "http://svc:8099"' in got[0][2] and json.loads(got[1][2])["app"] == "a"
    assert json.loads(got[2][2]) == {"ok": True}
    # a missing static file: the same status on both
    assert port_answers(port_app.make_app(), ["/static/nope.js"])[0][0] == 404


def test_ui_server_takes_the_env(monkeypatch):
    monkeypatch.setenv("FOREMAST_SERVICE_ENDPOINT", "http://gw:1/")
    monkeypatch.setenv("FOREMAST_UI_NAMESPACE", "shop")
    monkeypatch.setenv("FOREMAST_UI_APP", "cart")
    got = same_answers(["/config", "/"])
    assert json.loads(got[0][2])["serviceEndpoint"] == "http://gw:1"
    assert json.loads(got[0][2])["namespace"] == "shop" and json.loads(got[0][2])["app"] == "cart"


def test_demo_mode_serves_synthetic_query_range():
    targets = [
        q("/api/v1/query_range", query='namespace_app_per_pod:http_server_requests_latency{namespace="n",app="a"}',
          start="0", end="600", step="15"),
        q("/api/v1/query_range", query="foremastbrain_x_anomaly", start="0", end="3600", step="15"),
        q("/api/v1/query_range", query="foremastbrain_x_upper", start="0", end="3600", step="60"),
        q("/api/v1/query_range", query="foremastbrain_x_lower", start="100", end="90", step="60"),
        q("/api/v1/query_range", query="x", start="a", end="1", step="1"),
        q("/api/v1/query_range", query="x", start="0", end="1", step="0"),
        q("/api/v1/query_range", query="x", start="0", end=str(8 * 86400), step="60"),
        "/api/v1/query_range",
        "/config",
    ]
    got = same_answers(targets, demo=True)
    assert json.loads(got[-1][2])["serviceEndpoint"] == ""
    assert len(json.loads(got[0][2])["data"]["result"][0]["values"]) > 30
    assert len({v for _, v in json.loads(got[1][2])["data"]["result"][0]["values"]}) <= 4
    assert json.loads(got[3][2])["data"]["result"] == []
    assert [s for s, _, _ in got[4:7]] == [400, 400, 400]


def golden_join_inputs():
    rows = []
    with open(os.path.join(ROOT, "tests", "data", "demo_canary_spike.csv")) as f:
        for i, row in enumerate(csv.reader(f)):
            if row:
                rows.append((1_700_000_000 + 15.0 * i, float(row[1])))
    spikes = [(t, v) for t, v in rows if v > 10.0]
    anomaly, last = [], None
    for t, _ in rows:
        for st, sv in spikes:
            if st <= t:
                last = sv
        if last is not None:
            anomaly.append((t, last))
    return rows, anomaly, rows[0][0] - 15.0, spikes


def test_anomaly_join_golden_trace_dots_land_on_base_points():
    base, anomaly, start, spikes = golden_join_inputs()
    joined = port_join.join_anomalies(base, anomaly, start, 15.0)
    assert joined == jax_join.join_anomalies(base, anomaly, start, 15.0)
    assert joined == spikes
    assert port_join.anomaly_events(anomaly, start, 15.0) == jax_join.anomaly_events(anomaly, start, 15.0)
    for scale in (1.0, 1000.0, 1 / (1024 * 1024)):
        by_type = {"base": base, "upper": base[:5], "lower": [], "anomaly": anomaly}
        assert port_join.panel_payload(by_type, scale, start, 15.0) == jax_join.panel_payload(
            by_type, scale, start, 15.0)


def test_anomaly_join_left_edge_and_missing_base():
    cases = [
        ([(100.0, 5.0), (115.0, 5.0)], 100.0, 15.0),
        ([(100.0, 5.0), (115.0, 5.0), (130.0, 7.0)], 100.0, 15.0),
        ([(160.0, 5.0)], 100.0, 15.0),
        ([(115.0, 5.0), (130.0, 5.0)], 100.0, 15.0),  # at start + step: still the left edge
        ([], 0.0, 15.0),
    ]
    for anomaly, start, step in cases:
        assert port_join.anomaly_events(anomaly, start, step) == jax_join.anomaly_events(anomaly, start, step)
    assert port_join.anomaly_events(cases[0][0], 100.0, 15.0) == []
    assert port_join.anomaly_events(cases[1][0], 100.0, 15.0) == [(130.0, 7.0)]
    assert port_join.join_anomalies([(100.0, 1.0)], [(160.0, 5.0)], 100.0, 15.0) == []
    assert port_join.panel_payload({}, 2.0, 0.0, 15.0) == jax_join.panel_payload({}, 2.0, 0.0, 15.0)


def random_sticky(rng) -> tuple:
    """A base series with gaps and a sticky anomaly gauge over it: left-
    edge values, repeats of one value after a change, values that come
    back, and events at times the base series lacks."""
    step = float(rng.choice([1.0, 15.0, 60.0]))
    start = float(rng.integers(0, 10_000)) * step
    n = int(rng.integers(0, 60))
    ts = start + step * np.arange(n)
    base = [(float(t), float(v)) for t, v in zip(ts, np.round(rng.normal(5, 2, n), 3)) if rng.random() > 0.2]
    first = int(rng.integers(0, 3))  # 0: present at the left edge, 1: one step in, 2: later
    anomaly, value = [], None
    for k, t in enumerate(ts):
        if k < first * int(rng.integers(1, 5)):
            continue
        if value is None or rng.random() < 0.15:
            value = float(rng.choice([1.5, 2.5, 3.5, float(np.round(rng.normal(9, 3), 2))]))
        if rng.random() > 0.1:  # a missed scrape
            anomaly.append((float(t), value))
    return base, anomaly, start, step


def test_anomaly_join_on_seeded_random_sticky_series():
    rng = np.random.default_rng(2018)
    edges = joined_any = 0
    for _ in range(200):
        base, anomaly, start, step = random_sticky(rng)
        events = port_join.anomaly_events(anomaly, start, step)
        assert events == jax_join.anomaly_events(anomaly, start, step)
        joined = port_join.join_anomalies(base, anomaly, start, step)
        assert joined == jax_join.join_anomalies(base, anomaly, start, step)
        scale = float(rng.choice([1.0, 1000.0, 0.5]))
        by_type = {"base": base, "upper": base[::3], "lower": base[1::3], "anomaly": anomaly}
        assert port_join.panel_payload(by_type, scale, start, step) == jax_join.panel_payload(
            by_type, scale, start, step)
        edges += bool(anomaly) and anomaly[0][0] <= start + step
        joined_any += bool(joined)
    assert edges > 20 and joined_any > 20  # the cases the series were made for occur


def test_panel_endpoint_demo_mode_joins_anomalies_onto_base():
    targets = [q("/api/v1/panel", i=str(i), end="7200") for i in range(len(port_metrics.DEFAULT_PANELS))]
    targets += ["/api/v1/panel?i=999", "/api/v1/panel", "/api/v1/panel?i=x", "/api/v1/panel?i=0&end=abc"]
    got = same_answers(targets, demo=True)
    data = json.loads(got[0][2])
    assert {"base", "upper", "lower", "anomaly", "anomalyJoined"} <= set(data)
    assert data["base"] and data["anomalyJoined"]
    base_by_t = {d["t"]: d["v"] for d in data["base"]}
    assert all(base_by_t[d["t"]] == d["v"] for d in data["anomalyJoined"])
    assert [s for s, _, _ in got[-4:]] == [400, 400, 400, 400]


def test_panel_endpoint_honors_window_and_rejects_negative_index():
    targets = [
        q("/api/v1/panel", i="0", end="7200", window="900", step="15"),
        q("/api/v1/panel", i="2", end="7200", window="10", step="0.1"),  # both clamp up
        q("/api/v1/panel", i="1", end="900000", window=str(30 * 86400), step="99999"),  # both clamp down
        q("/api/v1/panel", i="-1"),
        q("/api/v1/panel", i="0", end="7200", window="x"),
        q("/api/v1/panel", i="0", end="7200", step="nan?"),
    ]
    got = same_answers(targets, demo=True)
    ts = [d["t"] for d in json.loads(got[0][2])["base"]]
    assert min(ts) >= 7200 - 900 - 15
    ts = [d["t"] for d in json.loads(got[2][2])["base"]]
    assert ts[1] - ts[0] == 3600 and min(ts) >= 900000 - 7 * 86400 - 3600
    assert [s for s, _, _ in got[3:]] == [400, 400, 400]


# -- the panel through the gateway to an upstream Prometheus -----------------------


@pytest.fixture
def upstream():
    """A fake Prometheus holding scraped samples for app `a` of `n`, one
    series of them broken (a text answer), behind the port's gateway."""
    from foremast_tpu_torch.service.app import make_app as make_gateway

    class BrokenCount(FakePrometheus):
        def handle(self, target):
            if "requests_count" in urllib.parse.unquote(target):
                return 500, b"upstream down"  # not JSON: the series fails
            return super().handle(target)

    fake = BrokenCount()
    rng = np.random.default_rng(7)
    t = 1_700_000_000 + 15 * np.arange(240)
    for metric in ("namespace_app_per_pod:http_server_requests_error_5xx",
                   "namespace_app_per_pod:http_server_requests_latency"):
        g = "foremastbrain_" + metric.replace(":", "_")
        fake.put_samples(metric, {"namespace": "n", "app": "a"}, t, np.round(rng.normal(2, 0.5, 240), 3))
        fake.put_samples(g + "_upper", {"exported_namespace": "n", "app": "a"}, t[::4], np.full(60, 3.25))
        fake.put_samples(g + "_lower", {"exported_namespace": "n", "app": "a"}, t[::4], np.full(60, 0.75))
        sticky = np.repeat([4.5, 4.5, 6.25], 20)
        fake.put_samples(g + "_anomaly", {"exported_namespace": "n", "app": "a"}, t[120::2], sticky)
    prom_srv, prom_url = serve_fake_prometheus(fake)
    # a registry of its own: the JAX gateway's tests register the same family names in this process
    gateway = make_gateway(query_endpoint=prom_url, registry=CollectorRegistry())
    gw_srv = make_server(gateway, "127.0.0.1", 0)
    threading.Thread(target=gw_srv.serve_forever, daemon=True).start()
    try:
        yield fake, f"http://127.0.0.1:{gw_srv.server_address[1]}"
    finally:
        for srv in (gw_srv, prom_srv):
            srv.shutdown()
            srv.server_close()
        gateway.close()


def test_panel_through_the_gateway_equals_jax(upstream, caplog):
    """Every panel, the clamps and the 400s, through the port's gateway to
    the fake upstream: the port's bodies equal JAX's."""
    fake, gw = upstream
    end = str(1_700_000_000 + 15 * 239)
    targets = [q("/api/v1/panel", i=str(i), end=end, window="3600", step="15") for i in range(6)]
    targets += [q("/api/v1/panel", i="0", end=end, window="5", step="0.5"),
                q("/api/v1/panel", i="2", end=end, window=str(10 * 86400), step="7200"),
                q("/api/v1/panel", i="0", end=end), "/api/v1/panel?i=6", "/api/v1/panel?i=0&window=w"]
    with caplog.at_level(logging.WARNING, logger="foremast_tpu_torch.ui"):
        got = same_answers(targets, service_endpoint=gw, namespace="n", app_name="a")
    p0 = json.loads(got[0][2])
    assert len(p0["base"]) == 240 and len(p0["upper"]) == 240
    # the gauge appears at sample 120 and changes value at sample 200
    assert p0["anomalyJoined"] == [{"t": 1_700_000_000.0 + 15 * k, "v": p0["base"][k]["v"]} for k in (120, 200)]
    lat = json.loads(got[2][2])  # scale 1000
    assert lat["upper"][0]["v"] == 3250.0 and len(lat["anomalyJoined"]) == 2
    assert json.loads(got[3][2]) == {"base": [], "upper": [], "lower": [], "anomaly": [], "anomalyJoined": []}
    assert [s for s, _, _ in got[-2:]] == [400, 400]
    failed = [r.getMessage() for r in caplog.records if r.name == "foremast_tpu_torch.ui"]
    assert len(failed) == 4 and all("series fetch failed" in m and "requests_count" in m for m in failed)


def test_panel_with_no_upstream_answers_empty_series(caplog):
    """An endpoint nobody listens on: every series charted empty, a
    warning a series, 200 on both."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    with caplog.at_level(logging.WARNING, logger="foremast_tpu_torch.ui"):
        got = same_answers([q("/api/v1/panel", i="0", end="7200")], service_endpoint=dead)
    assert got[0][0] == 200
    assert json.loads(got[0][2]) == {"base": [], "upper": [], "lower": [], "anomaly": [], "anomalyJoined": []}
    failed = [r.getMessage() for r in caplog.records if r.name == "foremast_tpu_torch.ui"]
    assert len(failed) == 4 and all("series fetch failed" in m for m in failed)


# -- static files ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["index.html", "app.js", "style.css"])
def test_static_files_are_byte_equal(name):
    with open(os.path.join(jax_app.STATIC_DIR, name), "rb") as a, open(
            os.path.join(port_app.STATIC_DIR, name), "rb") as b:
        assert a.read() == b.read()


def test_ui_js_pins_hold_for_the_port_copy():
    src = open(os.path.join(port_app.STATIC_DIR, "app.js")).read()
    assert test_ui_js.lint_js(src) == []
    assert test_ui_js.extract_function(src, "extent") == test_ui_js.PINNED_EXTENT
    assert test_ui_js.extract_function(src, "niceTicks") == test_ui_js.PINNED_NICE_TICKS
    assert sorted(os.listdir(port_app.STATIC_DIR)) == ["app.js", "index.html", "style.css"]


# -- the CLI's `ui` ------------------------------------------------------------------


def _subparser_actions(build_parser, name: str) -> list:
    parser = build_parser()
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type.__name__ if a.type else None, a.help)
                  for a in sub.choices[name]._actions)


@pytest.mark.parametrize("command", ["ui", "rules"])
def test_cli_flags_and_defaults_match_jax(command):
    from foremast_tpu.cli import build_parser as jax_parser
    from foremast_tpu_torch.cli import build_parser as port_parser

    assert _subparser_actions(port_parser, command) == _subparser_actions(jax_parser, command)


def test_cli_ui_serves_and_stops_on_sigterm(tmp_path):
    """`python -m foremast_tpu_torch ui --demo` as a process: its index,
    config and a panel, then exit 0 on SIGTERM."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "foremast_tpu_torch", "ui", "--host", "127.0.0.1", "--port",
                             str(port), "--demo"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    assert json.loads(r.read()) == {"ok": True}
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read().decode()
                time.sleep(0.1)
        with urllib.request.urlopen(url + "/config", timeout=5) as r:
            assert json.loads(r.read())["serviceEndpoint"] == ""
        with urllib.request.urlopen(url + "/api/v1/panel?i=2&end=7200", timeout=5) as r:
            assert json.loads(r.read())["anomalyJoined"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
