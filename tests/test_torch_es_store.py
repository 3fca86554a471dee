"""The port's `ElasticsearchStore` (over its standard-library HTTP
session) against the JAX package's (over `requests`).

Both stores run the same operations against `tests/test_es_store.py`'s
in-process `FakeES` and must leave the same documents and send the same
requests (method, URL, body bytes, content type); then once over real
sockets: through `tests/test_multihost_worker.py`'s `_serve_fake_es`,
and through a recording server that compares the bytes on the wire with
what `requests` sends."""

from __future__ import annotations

import json
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_es_store import FakeES  # noqa: E402
from test_multihost_worker import _serve_fake_es  # noqa: E402

from foremast_tpu.jobs import models as jm  # noqa: E402
from foremast_tpu.jobs import store as js  # noqa: E402
from foremast_tpu_torch import httpclient  # noqa: E402
from foremast_tpu_torch.chaos import CircuitBreaker  # noqa: E402
from foremast_tpu_torch.jobs import models as tm  # noqa: E402
from foremast_tpu_torch.jobs import store as ts  # noqa: E402

NOW = 1_760_000_000.0
STAMP = "2025-10-09T08:53:20Z"


class Recorder:
    """A session that logs each call (verb, URL, JSON body bytes, data,
    content type) and hands it to `inner`."""

    def __init__(self, inner):
        self.inner = inner
        self.log = []

    def _call(self, verb, url, **kw):
        body = kw.get("json")
        ctype = (kw.get("headers") or {}).get("Content-Type")
        self.log.append((verb, url, None if body is None else json.dumps(body, allow_nan=False), kw.get("data"), ctype))
        return getattr(self.inner, verb)(url, **kw)

    def get(self, url, **kw):
        return self._call("get", url, **kw)

    def put(self, url, **kw):
        return self._call("put", url, **kw)

    def post(self, url, **kw):
        return self._call("post", url, **kw)


@pytest.fixture
def frozen(monkeypatch):
    """Fixed clocks for both stores: claim cutoffs and stamps."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(js, "now_rfc3339", lambda: STAMP)
    monkeypatch.setattr(ts, "now_rfc3339", lambda: STAMP)


def _scenario(store_mod, models, fake):
    """One run of every store operation; returns what each returned."""
    Document = models.Document
    s = store_mod.ElasticsearchStore("http://fake:9200", session=fake)
    t = store_mod.ElasticsearchStore("http://fake:9200", session=fake)  # a second worker
    out = [s.wait_ready(max_wait=0), t.wait_ready(max_wait=0)]
    for i in range(9):
        doc, created = s.create(Document(id=f"j{i}", app_name=f"app{i % 3}", strategy="canary" if i % 2 else "rollover"))
        out.append((doc.id, created))
    out.append(s.create(Document(id="j1", app_name="other"))[1])  # idempotent
    out.append(s.get("j4").to_json())
    out.append(s.get("missing"))
    random.seed(5)  # the claim shuffles an oversampled page
    got_a = s.claim("worker-a", max_stuck_seconds=90, limit=3)
    got_b = t.claim("worker-b", max_stuck_seconds=90, limit=64)
    out.append(([d.id for d in got_a], [d.id for d in got_b]))
    out.append(t.claim("worker-b", max_stuck_seconds=90, limit=64))  # nothing left
    # a doc left in progress long ago is taken over first
    fake.inner.docs["j2"]["_source"]["modifiedAt"] = "2000-01-01T00:00:00Z"
    random.seed(6)
    out.append([d.id for d in s.claim("worker-c", max_stuck_seconds=90, limit=2)])
    for d in got_a:
        d.status = models.STATUS_COMPLETED_HEALTH
        d.reason = ""
    s.update(got_a[0])
    s.update_many(got_a[1:] + got_b[:2])
    out.append(sorted(d.id for d in s.list_open()))
    out.append(sorted(d.id for d in s.list_app("app1")))
    return out


def test_same_documents_and_requests_as_jax(frozen):
    jfake, tfake = Recorder(FakeES()), Recorder(FakeES())
    want = _scenario(js, jm, jfake)
    got = _scenario(ts, tm, tfake)
    assert got == want
    assert tfake.log == jfake.log
    assert {k: r["_source"] for k, r in tfake.inner.docs.items()} == {
        k: r["_source"] for k, r in jfake.inner.docs.items()
    }
    # the claim is two round trips and the bulk write NDJSON
    bulk = [e for e in tfake.log if e[1].endswith("/_bulk")]
    assert bulk and all(e[4] == "application/x-ndjson" and e[3].endswith("\n") for e in bulk)


class RacingES(FakeES):
    """Bumps j1's version between a claimer's search and its bulk CAS: a
    second worker winning the race in that window."""

    def post(self, url, json=None, data=None, headers=None, **kw):
        resp = super().post(url, json=json, data=data, headers=headers, **kw)
        if url.endswith("/_search") and "j1" in self.docs:
            self._seq += 1
            self.docs["j1"]["_seq_no"] = self._seq
        return resp


@pytest.mark.parametrize("mod,models", [(js, jm), (ts, tm)], ids=["jax", "port"])
def test_claim_cas_has_one_winner(mod, models):
    fake = RacingES()
    store = mod.ElasticsearchStore("http://fake:9200", session=fake)
    assert store.wait_ready(max_wait=0)
    store.create(models.Document(id="j1", app_name="x"))
    assert store.claim("worker-a", max_stuck_seconds=90) == []
    assert fake.docs["j1"]["_source"]["status"] == models.STATUS_INITIAL
    # two plain workers: exactly one takes the doc
    fake2 = FakeES()
    a = mod.ElasticsearchStore("http://fake:9200", session=fake2)
    b = mod.ElasticsearchStore("http://fake:9200", session=fake2)
    assert a.wait_ready(max_wait=0) and b.wait_ready(max_wait=0)
    a.create(models.Document(id="j1", app_name="x"))
    assert [d.id for d in a.claim("worker-a", 90)] == ["j1"] and b.claim("worker-b", 90) == []
    assert fake2.docs["j1"]["_source"]["processingContent"] == "worker-a"


class _Down:
    def __init__(self):
        self.calls = 0

    def get(self, url, **kw):
        self.calls += 1
        raise ConnectionError("connection refused")


@pytest.mark.parametrize("mod", [js, ts], ids=["jax", "port"])
def test_wait_ready_deadline_and_stop(mod):
    down = _Down()
    store = mod.ElasticsearchStore("http://fake:9200", session=down)
    t0 = time.monotonic()
    assert store.wait_ready(retry_seconds=0.05, max_wait=0.3) is False
    assert time.monotonic() - t0 < 2.0
    state = store.connect_state
    assert not state["connected"] and state["attempts"] == down.calls >= 2
    assert "ConnectionError" in state["last_error"]
    stop = threading.Event()
    stop.set()
    t0 = time.monotonic()
    assert store.wait_ready(retry_seconds=30, stop=stop.is_set) is False
    assert time.monotonic() - t0 < 1.0


def test_mapping_divergence_raises_in_both():
    for mod in (js, ts):
        fake = FakeES()
        fake.mappings = {"properties": {"status": {"type": "text"}}}
        with pytest.raises(mod.MappingDivergence):
            mod.ElasticsearchStore("http://fake:9200", session=fake).wait_ready(max_wait=0)


def test_breaker_wraps_the_session_and_opens_on_transient_failures():
    breaker = CircuitBreaker("store", failure_threshold=2, open_seconds=60)
    store = ts.ElasticsearchStore("http://fake:9200", session=_Down(), breaker=breaker)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            store.get("j1")
    assert breaker.state == "open"
    # the connect loop probes through the raw session, not the breaker
    assert store.wait_ready(retry_seconds=0.01, max_wait=0.05) is False
    assert "BreakerOpen" not in store.connect_state["last_error"]


def test_over_a_real_socket_through_the_repo_fake():
    srv, fake = _serve_fake_es()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        store = ts.ElasticsearchStore(url)
        assert store.wait_ready(max_wait=5)
        for i in range(5):
            store.create(tm.Document(id=f"j{i}", app_name="a"))
        assert not store.create(tm.Document(id="j0", app_name="b"))[1]
        got = store.claim("w", max_stuck_seconds=90, limit=3)
        assert len(got) == 3
        for d in got:
            d.status = tm.STATUS_COMPLETED_UNHEALTH
            d.anomaly_info = {"tags": "", "values": {"latency": [1.0, 2.5]}}
        store.update_many(got)
        assert store.get(got[0].id).anomaly_info == {"tags": "", "values": {"latency": [1.0, 2.5]}}
        assert len(store.list_open()) == 2
        assert fake.docs[got[1].id]["_source"]["status"] == tm.STATUS_COMPLETED_UNHEALTH
    finally:
        srv.shutdown()
        srv.server_close()


def test_one_store_shared_by_threads():
    """One store used from several threads at once, as a sliced sweep
    uses it (the writer thread's bulk writes beside the tick thread's
    nested micro-tick claims): every request gets its own answer, as
    through `requests`' connection pool."""
    srv, _ = _serve_fake_es()
    try:
        store = ts.ElasticsearchStore(f"http://127.0.0.1:{srv.server_address[1]}")
        assert store.wait_ready(max_wait=5)
        n_threads = 8
        for i in range(n_threads):
            store.create(tm.Document(id=f"j{i}", app_name=f"a{i}"))
        start = threading.Barrier(n_threads)
        errors: list = []

        def hammer(i: int) -> None:
            try:
                start.wait(timeout=30)
                for k in range(40):
                    doc = store.get(f"j{i}")
                    assert doc is not None and doc.app_name == f"a{i}", doc
                    doc.reason = f"pass {k}"
                    store.update_many([doc])
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert [store.get(f"j{i}").reason for i in range(n_threads)] == ["pass 39"] * n_threads
    finally:
        srv.shutdown()
        srv.server_close()


def _recording_server():
    """A loopback server that records (method, path, content type, body
    bytes) and answers what `FakeES` answers."""
    fake = FakeES()
    wire = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _dispatch(self, method):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            ctype = self.headers.get("Content-Type")
            wire.append((method, self.path, ctype, raw))
            if method == "GET":
                resp = fake.get(self.path)
            elif method == "PUT":
                resp = fake.put(self.path, json=json.loads(raw))
            elif "x-ndjson" in (ctype or ""):
                resp = fake.post(self.path, data=raw.decode(), headers={"Content-Type": ctype})
            else:
                resp = fake.post(self.path, json=json.loads(raw))
            payload = json.dumps(resp.json()).encode()
            self.send_response(resp.status_code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_POST(self):
            self._dispatch("POST")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, wire


def test_wire_bytes_equal_what_requests_sends(frozen):
    """Method, path and query, content type and body bytes of every
    request, the port's session against `requests` on the JAX store."""
    runs = []
    for mod, models in ((js, jm), (ts, tm)):
        srv, wire = _recording_server()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            store = mod.ElasticsearchStore(url)
            assert store.wait_ready(max_wait=5)
            store.create(models.Document(id="j 1é%", app_name="a"))  # quoted id, non-ASCII
            store.create(models.Document(id="j2", app_name="b"))
            random.seed(1)
            got = store.claim("w", max_stuck_seconds=90, limit=1)
            store.update(got[0])
            store.update_many(got)
            store.get("j2")
        finally:
            srv.shutdown()
            srv.server_close()
        runs.append(wire)
    assert runs[1] == runs[0]


def test_session_response_surface():
    resp = httpclient.Response(503, b'{"a": 1}', "http://x/y")
    assert not resp.ok and resp.json() == {"a": 1}
    with pytest.raises(httpclient.HTTPError) as e:
        resp.raise_for_status()
    assert e.value.response.status_code == 503
    with pytest.raises(ConnectionError):
        httpclient.Session().get("http://127.0.0.1:9/", timeout=2)
