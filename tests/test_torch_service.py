"""The job gateway on both packages: the JAX package's aiohttp app
(`foremast_tpu.service.make_app`, driven through aiohttp's `TestClient`)
and the port's standard-library server (`foremast_tpu_torch.service`,
driven over a loopback socket with urllib), given the same sequence of
requests.

Each exchange compares the status code and the JSON body exactly, and the
CORS headers where the route sets them. The create -> worker tick -> poll
lifecycle judges the job with the JAX worker on the JAX side and the
port's worker (`device="cpu"`, every kernel's plain version) on the port
side; the statuses and the anomaly's flat [t, v, ...] pairs must be equal.
`request_to_document` and the idempotent job id are compared field for
field on a seeded set of requests."""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client import CollectorRegistry

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.jobs import InMemoryStore as JaxStore
from foremast_tpu.jobs.convert import InvalidRequest as JaxInvalid
from foremast_tpu.jobs.convert import request_to_document as jax_convert
from foremast_tpu.jobs.models import AnalyzeRequest as JaxRequest
from foremast_tpu.metrics import ReplaySource as JaxReplay
from foremast_tpu.observe.spans import Tracer as JaxTracer
from foremast_tpu.service import make_app as jax_make_app
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.jobs import BrainWorker, InMemoryStore
from foremast_tpu_torch.jobs.convert import InvalidRequest, request_to_document
from foremast_tpu_torch.jobs.models import AnalyzeRequest
from foremast_tpu_torch.metrics.source import ReplaySource
from foremast_tpu_torch.observe.spans import Tracer
from foremast_tpu_torch.service import make_app, make_server
from tests.torch_fake_services import FakePrometheus, serve_fake_prometheus

CREATE_BODY = {
    "appName": "demo",
    "startTime": "2026-07-29T00:00:00Z",
    "endTime": "2026-07-29T00:10:00Z",
    "strategy": "rollingUpdate",
    "metrics": {
        "current": {
            "error4xx": {
                "dataSourceType": "prometheus",
                "parameters": {
                    "endpoint": "http://replay/cur/",
                    "query": "spiketrace",
                    "start": 1,
                    "end": 600,
                    "step": 60,
                },
            }
        },
        "historical": {
            "error4xx": {
                "dataSourceType": "prometheus",
                "parameters": {
                    "endpoint": "http://replay/hist/",
                    "query": "histtrace",
                    "start": 1,
                    "end": 600,
                    "step": 60,
                },
            }
        },
    },
}
CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers")


def _answer(status: int, headers, raw: bytes) -> dict:
    try:
        body = json.loads(raw)
    except ValueError:
        body = None
    return {"status": status, "body": body, "cors": {k: headers.get(k) for k in CORS}}


class JaxGateway:
    """The JAX app behind aiohttp's test server, on its own event loop."""

    def __init__(self, **kw):
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(jax_make_app(**kw)), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def call(self, method: str, path: str, body: bytes | None = None, params=None) -> dict:
        async def go():
            kw = {"params": params} if params else {}
            if body is not None:
                kw.update(data=body, headers={"Content-Type": "application/json"})
            r = await self.client.request(method, path, **kw)
            return _answer(r.status, r.headers, await r.read())

        return self.loop.run_until_complete(go())

    def text(self, path: str) -> str:
        async def go():
            r = await self.client.get(path)
            return await r.text()

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


class PortGateway:
    """The port's gateway behind its own server on a loopback port."""

    def __init__(self, **kw):
        self.app = make_app(**kw)
        self.srv = make_server(self.app, "127.0.0.1", 0)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def call(self, method: str, path: str, body: bytes | None = None, params=None) -> dict:
        url = self.url + path + ("?" + urllib.parse.urlencode(params) if params else "")
        req = urllib.request.Request(url, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return _answer(r.status, r.headers, r.read())
        except urllib.error.HTTPError as e:
            out = _answer(e.code, e.headers, e.read())
            e.close()
            return out

    def text(self, path: str) -> str:
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return r.read().decode()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.app.close()


@pytest.fixture
def gateways():
    made = []

    def make(jax_kw=None, port_kw=None):
        # each gateway counts on its own registry: the two packages'
        # families share a name, and one process holds both here
        jax_kw = {"registry": CollectorRegistry(), **(jax_kw or {})}
        port_kw = {"registry": CollectorRegistry(), **(port_kw or {})}
        pair = (JaxGateway(**jax_kw), PortGateway(**port_kw))
        made.extend(pair)
        return pair

    yield make
    for g in made:
        g.close()


def same(pair, method: str, path: str, body=None, params=None) -> dict:
    """One exchange on both gateways; the port's answer must equal JAX's."""
    raw = json.dumps(body).encode() if isinstance(body, dict) else body
    jax, port = (g.call(method, path, raw, params) for g in pair)
    assert port == jax, (method, path)
    return port


def test_create_and_poll_lifecycle(gateways, demo_traces):
    jax_store, port_store = JaxStore(), InMemoryStore()
    pair = gateways({"store": jax_store}, {"store": port_store})
    r = same(pair, "POST", "/v1/healthcheck/create", CREATE_BODY)
    assert r["status"] == 200 and r["body"]["status"] == "new" and r["body"]["statusCode"] == 201
    job_id = r["body"]["jobId"]
    r = same(pair, "POST", "/v1/healthcheck/create", CREATE_BODY)
    assert r["body"]["jobId"] == job_id and r["body"]["statusCode"] == 208
    assert same(pair, "GET", f"/v1/healthcheck/id/{job_id}")["body"]["status"] == "new"

    # score out of band: each package's worker on its own store
    st, sv = demo_traces["spike"]
    hist = np.tile(demo_traces["normal"][1], 6).astype(np.float32)
    ht = 1700000000 + 60 * np.arange(len(hist), dtype=np.int64)
    for store, source, worker in ((jax_store, JaxReplay(), JaxWorker), (port_store, ReplaySource(), BrainWorker)):
        source.register("histtrace", (ht, hist))
        source.register("spiketrace", (st, sv))
        kw = {"device": "cpu"} if worker is BrainWorker else {}
        w = worker(store, source, config=(BrainConfig() if worker is BrainWorker else JaxConfig()), **kw)
        w.tick(now=1e12)
        w.close()
    out = same(pair, "GET", f"/v1/healthcheck/id/{job_id}")["body"]
    assert out["status"] == "anomaly"
    assert any(v > 30 for v in out["anomalyInfo"]["values"]["error4xx"][1::2])


def test_create_validation_errors(gateways):
    pair = gateways({"store": JaxStore()}, {"store": InMemoryStore()})
    assert same(pair, "POST", "/v1/healthcheck/create", {"appName": ""})["status"] == 400
    assert same(pair, "POST", "/v1/healthcheck/create", b"not json")["status"] == 400
    assert same(pair, "POST", "/v1/healthcheck/create", b"")["status"] == 400
    no_current = dict(CREATE_BODY, metrics={"historical": CREATE_BODY["metrics"]["historical"]})
    assert same(pair, "POST", "/v1/healthcheck/create", no_current)["body"]["reason"] == \
        "metrics.current must not be empty"
    # an unsupported dataSourceType is a ValueError from `build_url`
    bad = json.loads(json.dumps(CREATE_BODY))
    bad["metrics"]["current"]["error4xx"]["dataSourceType"] = "graphite"
    assert same(pair, "POST", "/v1/healthcheck/create", bad)["status"] == 400
    assert same(pair, "GET", "/v1/healthcheck/id/nope")["status"] == 404
    r = same(pair, "GET", "/healthz")
    assert r["status"] == 200 and r["body"]["store_depth"] == 0 and r["body"]["store_ok"] is True


def test_unrouted_paths_and_methods(gateways):
    pair = gateways()
    assert same(pair, "GET", "/v1/healthcheck/nothing-here")["status"] == 404
    assert same(pair, "GET", "/api/v1/a/b")["status"] == 404  # {queryproxy} is one segment
    assert same(pair, "GET", "/v1/healthcheck/create")["status"] == 405
    assert same(pair, "POST", "/healthz", b"{}")["status"] == 405


def test_query_proxy_cors_and_gating(gateways):
    pair = gateways({"store": JaxStore(), "query_endpoint": ""}, {"store": InMemoryStore(), "query_endpoint": ""})
    r = same(pair, "GET", "/api/v1/query_range", params={"query": "up"})
    assert r["status"] == 502 and r["cors"]["Access-Control-Allow-Origin"] == "*"


def test_query_proxy_forwards_with_cors(gateways):
    """With an upstream the proxy answers its status and body, with CORS."""
    t = 1_700_000_000 + 60 * np.arange(3)
    fake = FakePrometheus({"/api/v1/query_range?query=up&start=1&end=2&step=60": (t, np.array([1.0, 2.0, 3.0]))})
    srv, url = serve_fake_prometheus(fake)
    try:
        pair = gateways({"query_endpoint": url}, {"query_endpoint": url})
        params = {"query": "up", "start": "1", "end": "2", "step": "60"}
        r = same(pair, "GET", "/api/v1/query_range", params=params)
        assert r["status"] == 200 and r["cors"]["Access-Control-Allow-Origin"] == "*"
        assert [v for _, v in r["body"]["data"]["result"][0]["values"]] == ["1.0", "2.0", "3.0"]
        fake.faults["/api/v1/query_range?query=up&start=1&end=2&step=60"] = [503, 503]  # one each
        assert same(pair, "GET", "/api/v1/query_range", params=params)["status"] == 503
    finally:
        srv.shutdown()
        srv.server_close()


def test_observability_surface(gateways):
    """/metrics, the enriched /healthz and /debug/state, the request
    counter labelled by route pattern, and the trace id minted at create
    and stored on the document."""
    jax_store, port_store = JaxStore(), InMemoryStore()
    jax_reg, port_reg = CollectorRegistry(), CollectorRegistry()
    pair = gateways(
        {"store": jax_store, "tracer": JaxTracer(service="svc", registry=jax_reg), "registry": jax_reg},
        {"store": port_store, "tracer": Tracer(service="svc", registry=port_reg), "registry": port_reg},
    )
    jid = same(pair, "POST", "/v1/healthcheck/create", CREATE_BODY)["body"]["jobId"]
    for store in (jax_store, port_store):
        doc = store.get(jid)
        assert doc.trace_id and doc.to_json()["traceId"] == doc.trace_id
    health = same(pair, "GET", "/healthz")["body"]
    assert health == {"ok": True, "version": "0.1.0", "store_depth": 1, "store_ok": True}
    states = [g.call("GET", "/debug/state")["body"] for g in pair]
    for state in states:
        assert state["component"] == "service" and state["queue_depth"] == 1
        assert state["store"] == "InMemoryStore" and state["trace"]["service"] == "svc"
    assert set(states[1]) == set(states[0])
    shared = set(states[0]) - {"uptime_seconds", "trace"}
    assert {k: states[1][k] for k in shared} == {k: states[0][k] for k in shared}
    for g in pair:
        text = g.text("/metrics")
        assert 'foremast_service_requests_total{code="200",route="/v1/healthcheck/create"} 1.0' in text
        assert 'route="/healthz"' in text
        # the raw path of a lookup never becomes a label
        g.call("GET", f"/v1/healthcheck/id/{jid}")
        text = g.text("/metrics")
        assert 'route="/v1/healthcheck/id/{id}"' in text and jid not in text


class SlowStore(InMemoryStore):
    def count_open(self):
        time.sleep(2.0)
        return 0


def test_healthz_degrades_within_its_bound_on_a_slow_store():
    """A slow store degrades /healthz's body (store_ok False) inside the
    0.5 s bound instead of failing the probe."""
    g = PortGateway(store=SlowStore(), registry=CollectorRegistry())
    try:
        t0 = time.monotonic()
        r = g.call("GET", "/healthz")
        assert time.monotonic() - t0 < 1.5
        assert r["status"] == 200 and r["body"]["store_ok"] is False and r["body"]["store_depth"] is None
    finally:
        g.close()


def _random_request(rng) -> dict:
    def mq(window: str, alias: str) -> dict:
        kind = "wavefront" if rng.random() < 0.2 else "prometheus"
        return {
            "dataSourceType": kind,
            "parameters": {
                "endpoint": f"http://prom-{rng.integers(3)}:9090/api/v1/",
                "query": f'namespace_pod:{alias}{{namespace="ns{rng.integers(4)}",pod=~"p{rng.integers(99)}"}}',
                "start": int(rng.integers(1_600_000_000, 1_700_000_000)),
                "end": int(rng.integers(1_700_000_000, 1_800_000_000)),
                "step": int(rng.choice([1, 60, 3600, 86400])),
            },
        }

    aliases = [f"m{i}" for i in range(int(rng.integers(1, 4)))]
    metrics = {"current": {a: mq("cur", a) for a in aliases}}
    if rng.random() < 0.5:
        metrics["baseline"] = {a: mq("base", a) for a in aliases}
    metrics["historical"] = {a: mq("hist", a) for a in aliases}
    return {
        "appName": f"app-{rng.integers(10)}" if rng.random() < 0.9 else "",
        "startTime": f"2026-07-{rng.integers(10, 28)}T00:00:00Z",
        "endTime": f"2026-07-{rng.integers(10, 28)}T00:10:00Z",
        "strategy": str(rng.choice(["rollingUpdate", "canary", "continuous"])),
        "namespace": f"ns{rng.integers(4)}",
        "metrics": metrics if rng.random() < 0.95 else {"historical": metrics["historical"]},
    }


def test_request_to_document_matches_jax():
    rng = np.random.default_rng(17)
    converted = refused = 0
    for _ in range(64):
        body = _random_request(rng)
        try:
            want = jax_convert(JaxRequest.from_json(body)).to_json()
        except JaxInvalid as e:
            with pytest.raises(InvalidRequest) as ei:
                request_to_document(AnalyzeRequest.from_json(body))
            assert str(ei.value) == str(e)
            refused += 1
            continue
        got = request_to_document(AnalyzeRequest.from_json(body)).to_json()
        assert got == want
        assert len(got["id"]) == 64
        converted += 1
    assert converted >= 40 and refused >= 3
