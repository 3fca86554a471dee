"""`python -m foremast_tpu_torch worker` as a deployed worker runs it: a
subprocess on the CPU (`--device cpu`) against a fake Elasticsearch and a
fake Prometheus on loopback sockets (`tests/torch_fake_services.py`).

It judges a small fleet to the JAX worker's statuses, exits 0 on
SIGTERM, and after a restart on the same `FOREMAST_SNAPSHOT_DIR` judges
the reset fleet again with no history fetch. With `FOREMAST_INGEST=1` it
takes the fleet's samples as a push on its receiver and judges from them
with no GET to Prometheus at all, before and after a restart that
restores the ring; with FOREMAST_MICROTICK_SECONDS as well, its
receiver marks each push dirty and micro-ticks judge the pushed fleet
between sweeps. Under `FOREMAST_CHAOS_PLAN` and `FOREMAST_TENANTS` it
injects the plan's faults, degrades through them and still judges the
fleet, with the chaos and tenant sections on `/debug/state` and their
families on `/metrics`. With `FOREMAST_MESH=1` it seats itself in the
worker mesh and shows it on `/debug/state`. Modes the port does not have are refused with
`NotImplementedError`. Every subprocess has its own timeout of at most
60 s."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.jobs.models import TERMINAL_STATUSES
from tests.torch_fake_services import (
    FakeElasticsearch,
    FakePrometheus,
    rebase,
    serve_fake_es,
    serve_fake_prometheus,
)

ROOT = Path(__file__).resolve().parent.parent
SERVICES = 8
FIELDS = ("status", "statusCode", "reason", "anomalyInfo")


def _fleet():
    """Docs and series of a small canary-mixed fleet whose endTime is
    past (every judgment is terminal), one latency window spiked; and the
    JAX worker's statuses on it."""
    store, source, _ = build_mixed_fleet(SERVICES, 512, 30, 1_760_000_000.0, baseline_frac=0.5)
    url = next(u for u in source.data if u.startswith("http://prom/cur") and "latency:app3" in u)
    t, v = source.data[url]
    v = v.copy()
    v[-3:] = 40.0
    source.data[url] = (t, v)
    docs = [d.to_json() for d in store._docs.values()]
    jax_worker = JaxWorker(store, source, config=JaxConfig(), device_mesh=None, worker_id="jax")
    assert jax_worker.tick() == SERVICES
    want = {d.id: {f: d.to_json().get(f) for f in FIELDS} for d in store._docs.values()}
    assert all(w["status"] in TERMINAL_STATUSES for w in want.values())
    return docs, dict(source.data), want


@pytest.fixture(scope="module")
def services():
    docs, data, want = _fleet()
    es_srv, es, es_url = serve_fake_es()
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    docs, prom.data = rebase(docs, data, "http://prom", prom_url)
    yield es, es_url, prom, docs, want
    for srv in (es_srv, prom_srv):
        srv.shutdown()
        srv.server_close()


def _start(args, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "foremast_tpu_torch", "worker", *args],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _wait_for(proc, text: str, timeout: float = 60) -> None:
    """Read the worker's stderr until a line holds `text`."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if text in line:
            return
        if not line and proc.poll() is not None:
            break
    proc.kill()
    pytest.fail(f"the worker never logged {text!r}")


def _stop(proc, timeout=30):
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _judged(es, deadline, proc) -> dict:
    while time.monotonic() < deadline:
        got = es.sources()
        if got and all(d.get("status") in TERMINAL_STATUSES for d in got.values()):
            return {k: {f: d.get(f) for f in FIELDS} for k, d in got.items()}
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    rc, out, err = _stop(proc)
    pytest.fail(f"the worker did not judge the fleet (rc={rc}):\n{err[-4000:]}")


def test_worker_judges_restarts_warm_and_stops_cleanly(services, tmp_path):
    es, es_url, prom, docs, want = services
    es.load(docs)
    snap = str(tmp_path / "snap")
    args = ["--device", "cpu", "--elastic-url", es_url, "--gauge-port", "0", "--poll", "0.2"]
    env = {"FOREMAST_SNAPSHOT_DIR": snap}

    proc = _start(args, env)
    got = _judged(es, time.monotonic() + 60, proc)
    rc, _, err = _stop(proc)
    assert rc == 0, err[-4000:]
    assert got == want
    assert prom.requests["/hist"] == 4 * SERVICES
    assert {f.name for f in Path(snap).iterdir()} >= {"worker.id", "fit-fits.log"}

    # restart on the same directory, the fleet reset to a re-check
    es.set_status("preprocess_completed")
    prom.requests.clear()
    proc = _start(args, env)
    got = _judged(es, time.monotonic() + 60, proc)
    rc, _, err = _stop(proc)
    assert rc == 0, err[-4000:]
    assert got == want
    assert prom.requests["/hist"] == 0  # every fit came back from the journals
    assert prom.requests["/cur"] >= 4 * SERVICES
    assert f"restored fit state {{'fits': {4 * SERVICES}," in err


def test_sigterm_during_the_connect_loop_exits_0(tmp_path):
    es_srv, _, es_url = serve_fake_es()
    es_srv.shutdown()
    es_srv.server_close()  # nothing listens there any more
    proc = _start(["--device", "cpu", "--elastic-url", es_url, "--gauge-port", "0"])
    _wait_for(proc, "connecting to Elasticsearch")
    time.sleep(0.5)
    rc, _, err = _stop(proc)
    assert rc == 0, err[-4000:]
    assert "shutdown requested during Elasticsearch connect" in err


def test_connect_deadline_exits_loudly(tmp_path):
    es_srv, _, es_url = serve_fake_es()
    es_srv.shutdown()
    es_srv.server_close()
    proc = _start(["--device", "cpu", "--elastic-url", es_url, "--gauge-port", "0"],
                  {"FOREMAST_ES_CONNECT_DEADLINE_SECONDS": "0.5"})
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "could not reach Elasticsearch" in err


@pytest.mark.parametrize(
    "flag,env,item",
    [
        (["--sharded"], {"JAX_NUM_PROCESSES": "2"}, "item 7, pod mode"),
        ([], {"FOREMAST_LOCK_WITNESS": "1"}, "item 8"),
        ([], {"FOREMAST_RECOMPILE_WITNESS": "1"}, "item 8"),
    ],
    ids=["sharded", "lock_witness", "recompile_witness"],
)
def test_unported_modes_are_refused(flag, env, item):
    """Modes the port does not have exit with NotImplementedError naming
    their ROADMAP item: --sharded where the env asks for pod mode (a mesh
    over several processes), and the JAX package's witnesses."""
    proc = _start(["--device", "cpu", "--gauge-port", "0", *flag], env)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "NotImplementedError" in err and f"Queue 1 {item}" in err


def test_sharded_worker_judges_the_fleet(services, tmp_path):
    """--sharded --device cpu: the judge spans the all-local mesh (the one
    CPU device), judges the fleet to the JAX worker's statuses (sharding
    is placement), and shows the device mesh on /debug/state."""
    import json
    import urllib.request

    es, es_url, prom, docs, want = services
    es.load(docs)
    gauge = _free_port()
    log_path = tmp_path / "worker.err"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "foremast_tpu_torch", "worker", "--device", "cpu", "--sharded",
             "--elastic-url", es_url, "--gauge-port", str(gauge), "--poll", "0.2"],
            cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL, stderr=log, text=True,
        )
    try:
        deadline = time.monotonic() + 60
        got = None
        while time.monotonic() < deadline and proc.poll() is None:
            fleet = es.sources()
            if fleet and all(d.get("status") in TERMINAL_STATUSES for d in fleet.values()):
                got = {k: {f: d.get(f) for f in FIELDS} for k, d in fleet.items()}
                break
            time.sleep(0.1)
        state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{gauge}/debug/state", timeout=10).read())
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    err = log_path.read_text()
    assert rc == 0, err[-4000:]
    assert got == want, err[-4000:]
    dm = state["device_mesh"]
    assert dm["shape"] == {"data": 1, "model": 1} and dm["devices"] == 1
    assert dm["place_calls"] > 0 and dm["arena_layout"] == "replicated"
    assert "device mesh: judge partitioned over" in err


def test_mesh_worker_joins_claims_and_shows_the_mesh(services, tmp_path):
    """FOREMAST_MESH=1 is no longer refused: the worker takes a seat in the
    store (a `mesh::<id>` member record), claims its partition (the whole
    fleet, alone) to the JAX worker's statuses, shows the mesh section on
    /debug/state, and leaves its seat on SIGTERM."""
    import json
    import urllib.request

    es, es_url, prom, docs, want = services
    es.load(docs)
    gauge = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), FOREMAST_MESH="1", FOREMAST_MESH_LEASE_SECONDS="30",
               FOREMAST_MESH_ROUTE_LABEL="app")
    log_path = tmp_path / "worker.err"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "foremast_tpu_torch", "worker", "--device", "cpu", "--elastic-url", es_url,
             "--gauge-port", str(gauge), "--poll", "0.2"],
            cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL, stderr=log, text=True,
        )
    try:
        deadline = time.monotonic() + 60
        got = None
        while time.monotonic() < deadline and proc.poll() is None:
            fleet = {k: d for k, d in es.sources().items() if d.get("appName") != "__foremast_mesh__"}
            if fleet and all(d.get("status") in TERMINAL_STATUSES for d in fleet.values()):
                got = {k: {f: d.get(f) for f in FIELDS} for k, d in fleet.items()}
                break
            time.sleep(0.1)
        while True:
            # the router re-lists members every 2 s: the record the worker
            # renewed with its observe port shows on the next refresh
            state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{gauge}/debug/state", timeout=10).read())
            if state["mesh"]["members"][0]["observe_port"] == gauge or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        text = _scrape(gauge)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    err = log_path.read_text()
    seats = {k: d for k, d in es.sources().items() if d.get("appName") == "__foremast_mesh__"}
    with es.lock:  # the module's other tests share this fake index
        for k in seats:
            es.docs.pop(k)
    assert rc == 0, err[-4000:]
    assert got == want, err[-4000:]
    mesh = state["mesh"]
    assert mesh["state"] == "active" and mesh["live_members"] == 1 and mesh["route_label"] == "app"
    assert mesh["members"][0]["worker_id"] == mesh["worker_id"] == state["worker_id"]
    assert mesh["members"][0]["observe_port"] == gauge
    assert mesh["claim_docs"]["owned"] >= SERVICES and mesh["claim_docs"]["skipped"] == 0
    assert mesh["handoff"] is None  # no receiver, no transfer endpoint: no handoff plane
    assert 'foremast_mesh_members{state="active"} 1.0' in text
    assert [d["status"] for d in seats.values()] == ["mesh_left"]  # a clean leave on SIGTERM
    assert json.loads(next(iter(seats.values()))["currentConfig"])["workerId"] == mesh["worker_id"]


def test_chaos_plan_and_tenants_run(services, tmp_path):
    """FOREMAST_CHAOS_PLAN is no longer refused: a seeded error rate on the
    `prometheus` edge over its first 8 s (no fetch retries) releases
    documents un-judged, later ticks judge the whole fleet to the JAX
    worker's statuses, and the plan's injections, the breakers and the
    tenant ledger (FOREMAST_TENANTS) show on /debug/state and /metrics.
    Every release logs a line, so the worker's stderr goes to a file (a
    pipe nobody reads would fill and block its logging)."""
    import json
    import urllib.request

    es, es_url, prom, docs, want = services
    es.load(docs)
    gauge = _free_port()
    plan = {"seed": 5, "rules": [{"edge": "prometheus", "duration": 8.0, "error_rate": 0.3},
                                 {"edge": "transfer", "error_rate": 1.0}]}
    tenants = {"default": {"weight": 1}, "acme": {"weight": 2, "arena_rows": 64}}
    env = dict(os.environ, PYTHONPATH=str(ROOT), FOREMAST_CHAOS_PLAN=json.dumps(plan),
               FOREMAST_TENANTS=json.dumps(tenants), FOREMAST_FETCH_RETRIES="0")
    log_path = tmp_path / "worker.err"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "foremast_tpu_torch", "worker", "--device", "cpu", "--elastic-url", es_url,
             "--gauge-port", str(gauge), "--poll", "0.2"],
            cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL, stderr=log, text=True,
        )
    try:
        deadline = time.monotonic() + 60
        while "worker started" not in log_path.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, log_path.read_text()[-4000:]
            time.sleep(0.1)
        got = None
        while time.monotonic() < deadline:
            srcs = es.sources()
            if srcs and all(d.get("status") in TERMINAL_STATUSES for d in srcs.values()):
                got = {k: {f: d.get(f) for f in FIELDS} for k, d in srcs.items()}
                break
            time.sleep(0.1)
        state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{gauge}/debug/state", timeout=10).read())
        text = _scrape(gauge)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    err = log_path.read_text()
    assert rc == 0, err[-4000:]
    assert "CHAOS PLAN ACTIVE" in err
    assert got == want
    chaos = state["degradation"]["chaos"]
    assert chaos["seed"] == 5 and chaos["rules"] == 2
    assert chaos["injections"].get("prometheus/connection", 0) > 0
    assert "transfer/connection" not in chaos["injections"]  # no mesh here: nothing asks for that edge
    assert state["degradation"]["docs"].get("fetch_released", 0) > 0
    assert set(state["tenants"]["registry"]["configured"]) == {"default", "acme"}
    assert state["tenants"]["accounting"]["default"]["claims"] >= SERVICES
    assert 'foremast_chaos_injections_total{edge="prometheus",kind="connection"}' in text
    assert 'foremast_breaker_state{edge="prometheus"}' in text
    assert 'foremast_tenant_claims_total{tenant="default"}' in text


def test_microticks_are_ignored_without_ingest():
    """FOREMAST_MICROTICK_SECONDS > 0 without FOREMAST_INGEST=1 (no
    receiver marks arrivals): logged as ignored, the worker stays
    tick-paced and stops cleanly."""
    proc = _start(["--device", "cpu", "--gauge-port", "0", "--poll", "0.2"], {"FOREMAST_MICROTICK_SECONDS": "0.5"})
    _wait_for(proc, "FOREMAST_MICROTICK_SECONDS needs FOREMAST_INGEST=1")
    rc, _, err = _stop(proc)
    assert rc == 0, err[-4000:]
    assert "reactive plane ON" not in err


def test_cuda_without_a_card_raises():
    proc = _start(["--gauge-port", "0"])
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "no CUDA device" in err


def _pushed_fleet(prom_url: str):
    """Docs and pushes of a small fleet whose current and historical
    windows are one series each at two ranges, with query_range URLs that
    carry start and end (the shape the ring resolves), endTime past so
    every judgment is terminal, one service spiked; the FakePrometheus
    data for the same URLs; and the JAX worker's statuses on a pull of
    the same samples."""
    import urllib.parse

    from foremast_tpu.jobs.models import Document as JaxDocument
    from foremast_tpu.jobs.store import InMemoryStore as JaxStore
    from foremast_tpu.metrics.promql import prometheus_url
    from foremast_tpu.metrics.source import MetricSource
    from foremast_tpu_torch.ingest import canonical_series, resolve_query_range

    rng = np.random.default_rng(11)
    t_now = 1_760_000_000
    ht = t_now - 86_400 * 7 + 60 * np.arange(512, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(30, dtype=np.int64)
    series, docs, keyed = {}, [], {}
    for s in range(SERVICES):
        for alias in ("latency", "tps"):
            expr = f'namespace_app_per_pod:{alias}{{namespace="ns",app="app{s}"}}'
            hv = rng.normal(1.0, 0.1, len(ht)).astype(np.float32)
            cv = (1.0 + 0.05 * np.sin(np.arange(len(ct)) / 3.0)).astype(np.float32)
            if s == 3 and alias == "latency":
                cv[-3:] = 40.0
            series[canonical_series(expr)] = (np.concatenate([ht, ct]), np.concatenate([hv, cv]))
        urls = {
            kind: " ||".join(
                f"{alias}== " + prometheus_url({"endpoint": f"{prom_url}/api/v1/",
                                                "query": f'namespace_app_per_pod:{alias}{{namespace="ns",app="app{s}"}}',
                                                "start": int(t[0]), "end": int(t[-1]), "step": 60})
                for alias in ("latency", "tps")
            )
            for kind, t in (("current", ct), ("historical", ht))
        }
        docs.append(JaxDocument(id=f"job-{s}", app_name=f"app{s}", end_time="2025-01-01T00:00:00Z",
                                current_config=urls["current"], historical_config=urls["historical"],
                                strategy="continuous").to_json())

    def window(url):
        key, t0, t1, _ = resolve_query_range(url)
        t, v = series[key]
        keep = (t >= t0) & (t <= t1)
        return t[keep], v[keep]

    class Pull(MetricSource):
        concurrent_fetch = False

        def fetch(self, url):
            return window(url)

    store = JaxStore()
    for d in docs:
        store.create(JaxDocument.from_json(d))
        for part in (d["currentConfig"], d["historicalConfig"]):
            for item in part.split(" ||"):
                url = item.split("== ", 1)[1]
                u = urllib.parse.urlsplit(url)
                keyed[f"{u.path}?{u.query}"] = window(url)
    assert JaxWorker(store, Pull(), config=JaxConfig(), device_mesh=None, worker_id="jax").tick() == SERVICES
    want = {d.id: {f: d.to_json().get(f) for f in FIELDS} for d in store._docs.values()}
    assert all(w["status"] in TERMINAL_STATUSES for w in want.values())
    assert sum(w["status"] == "completed_unhealth" for w in want.values()) == 1
    return docs, [(k, t, v, float(ht[0])) for k, (t, v) in series.items()], keyed, want


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _push_frame(port: int, entries, deadline: float) -> dict:
    """POST the entries as one FMW1 frame once the receiver answers."""
    import json
    import urllib.error
    import urllib.request

    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, encode_frame

    body = encode_frame(entries)
    while True:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=body, method="POST",
                                     headers={"Content-Type": BINARY_CONTENT_TYPE})
        try:
            return json.loads(urllib.request.urlopen(req, timeout=10).read())
        except (urllib.error.URLError, ConnectionError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def test_ingest_worker_judges_pushed_samples_with_no_prometheus_get(tmp_path):
    """FOREMAST_INGEST=1: the CLI mounts its receiver, takes the fleet's
    samples as one FMW1 push, judges every document to the JAX worker's
    statuses with 0 requests to Prometheus, exits 0 on SIGTERM; restarted
    on the same FOREMAST_SNAPSHOT_DIR it restores the ring and judges the
    reset fleet again with 0 requests."""
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    try:
        docs, entries, keyed, want = _pushed_fleet(prom_url)
        prom.data = keyed  # the fallback would answer, were it asked
        port = _free_port()
        args = ["--device", "cpu", "--elastic-url", es_url, "--gauge-port", "0", "--poll", "0.2"]
        # the fleet's samples are a year old by the real clock: the ring
        # restore's age cutoff (a day by default) would discard them
        env = {"FOREMAST_SNAPSHOT_DIR": str(tmp_path / "snap"), "FOREMAST_INGEST": "1",
               "FOREMAST_INGEST_PORT": str(port), "FOREMAST_SNAPSHOT_MAX_AGE_SECONDS": str(10 * 365 * 86_400)}
        proc = _start(args, env)
        answer = _push_frame(port, entries, time.monotonic() + 60)
        assert answer == {"accepted_samples": sum(len(t) for _, t, _, _ in entries), "series": len(entries)}
        es.load(docs)  # the fleet appears after its samples are resident
        got = _judged(es, time.monotonic() + 60, proc)
        rc, _, err = _stop(proc)
        assert rc == 0, err[-4000:]
        assert got == want
        assert sum(prom.requests.values()) == 0, dict(prom.requests)
        assert "ingest plane ON" in err
        assert "[inert: fallback configured]" in err  # the admit floor, with Prometheus behind the ring

        es.set_status("preprocess_completed")
        proc = _start(args, env)
        got = _judged(es, time.monotonic() + 60, proc)
        rc, _, err = _stop(proc)
        assert rc == 0, err[-4000:]
        assert got == want
        assert sum(prom.requests.values()) == 0, dict(prom.requests)
        assert f"restored ring state {len(entries)} series" in err
    finally:
        for srv in (es_srv, prom_srv):
            srv.shutdown()
            srv.server_close()


def _scrape(port: int) -> str:
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()


def test_ingest_worker_with_microticks_judges_pushes_between_sweeps():
    """FOREMAST_INGEST=1 and FOREMAST_MICROTICK_SECONDS: the CLI builds the
    dirty set, hands it to its receiver and its worker and exports it on
    /metrics. With the poll far longer than the test, the fleet loaded
    after the first sweep is judged by micro-ticks alone (every doc on
    `foremast_microtick_docs_total`, its push->verdict latency on
    path="micro"), to the JAX worker's statuses."""
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    try:
        docs, entries, keyed, want = _pushed_fleet(prom_url)
        prom.data = keyed
        port, gauge = _free_port(), _free_port()
        args = ["--device", "cpu", "--elastic-url", es_url, "--gauge-port", str(gauge), "--poll", "300"]
        env = {"FOREMAST_INGEST": "1", "FOREMAST_INGEST_PORT": str(port), "FOREMAST_MICROTICK_SECONDS": "0.05"}
        proc = _start(args, env)
        _wait_for(proc, "reactive plane ON")
        _wait_for(proc, "worker started")
        deadline = time.monotonic() + 60
        while "foremast_worker_tick_seconds_count 1.0" not in _scrape(gauge):
            assert time.monotonic() < deadline, "the first sweep never ran"
            time.sleep(0.05)  # the first sweep claims an empty store
        es.load(docs)
        _push_frame(port, entries, time.monotonic() + 60)
        got = _judged(es, time.monotonic() + 60, proc)
        text = _scrape(gauge)
        rc, _, err = _stop(proc)
        assert rc == 0, err[-4000:]
        assert got == want
        assert f"foremast_microtick_docs_total {float(SERVICES)}" in text
        assert f'foremast_verdict_latency_seconds_count{{path="micro",tenant="default"}} {float(SERVICES)}' in text
        assert 'foremast_microtick_dirty_events_total{event="marked"}' in text
    finally:
        for srv in (es_srv, prom_srv):
            srv.shutdown()
            srv.server_close()
