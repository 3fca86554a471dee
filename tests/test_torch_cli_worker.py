"""`python -m foremast_tpu_torch worker` as a deployed worker runs it: a
subprocess on the CPU (`--device cpu`) against a fake Elasticsearch and a
fake Prometheus on loopback sockets (`tests/torch_fake_services.py`).

It judges a small fleet to the JAX worker's statuses, exits 0 on
SIGTERM, and after a restart on the same `FOREMAST_SNAPSHOT_DIR` judges
the reset fleet again with no history fetch. Modes the port does not
have are refused with `NotImplementedError`. Every subprocess has its own
timeout of at most 60 s."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.jobs.models import TERMINAL_STATUSES
from tests.torch_fake_services import (
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
        (["--sharded"], {}, "item 7"),
        ([], {"FOREMAST_MESH": "1"}, "item 7"),
        ([], {"FOREMAST_INGEST": "1"}, "item 5"),
        ([], {"FOREMAST_MICROTICK_SECONDS": "0.5"}, "item 4"),
        ([], {"FOREMAST_LOCK_WITNESS": "1"}, "item 8"),
        ([], {"FOREMAST_RECOMPILE_WITNESS": "1"}, "item 8"),
    ],
    ids=["sharded", "mesh", "ingest", "microtick", "lock_witness", "recompile_witness"],
)
def test_unported_modes_are_refused(flag, env, item):
    proc = _start(["--device", "cpu", "--gauge-port", "0", *flag], env)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "NotImplementedError" in err and f"Queue 1 {item}" in err


def test_cuda_without_a_card_raises():
    proc = _start(["--gauge-port", "0"])
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "no CUDA device" in err
