"""The port's Prometheus exposition (`observe/gauges.py`, the worker's
`metrics=` call sites, `start_observe_server`) against the JAX package's:
each family the port exposes has the JAX family's name, type and label
names, and one worker tick pair feeds the same counters in both. The
port exposes only the families its worker feeds; the device-mesh families
are registered by both and fed only by a mesh worker."""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
from prometheus_client import CollectorRegistry

from foremast_tpu.observe import gauges as jg
from foremast_tpu_torch.observe import gauges as tg
from foremast_tpu_torch.observe.spans import start_observe_server
from tests.torch_workers import NOW, spike, worker_pair


# the families the port's worker feeds, BrainGauges' own and the
# foremastbrain verdict gauges aside
PORT_WORKER_FAMILIES = {
    "foremast_worker_jobs", "foremast_worker_windows", "foremast_worker_tick_seconds",
    "foremast_worker_arena_events", "foremast_worker_fast_docs", "foremast_worker_pipeline_idle_seconds",
    "foremast_worker_pipeline_overlap_ratio", "foremast_worker_pipeline_write_queue_peak",
    "foremast_cold_hist_reads", "foremast_sweep_slices", "foremast_sweep_preempt_events",
    "foremast_refine_docs", "foremast_provisional_fits", "foremast_verdict_latency_seconds",
    "foremast_microtick_docs",
    "foremast_device_mesh_devices", "foremast_device_mesh_rows", "foremast_device_mesh_arena_bytes",
    "foremast_device_mesh_transfer_seconds", "foremast_device_mesh_transfer_bytes",
}


def _families(registry, only=None) -> dict:
    """family name -> (type, sorted label names over its samples), of the
    families named in `only` (default: all)."""
    out = {}
    for fam in registry.collect():
        if only is None or fam.name in only:
            labels = sorted({k for s in fam.samples for k in s.labels if k != "le"})
            out[fam.name] = (fam.type, labels)
    return out


def _samples(registry, only=None) -> dict:
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for fam in registry.collect()
        if only is None or fam.name in only
        for s in fam.samples
        if not s.name.endswith(("_created", "_sum", "_bucket")) and "tick_seconds" not in s.name
    }


def _same_families(jax_reg, port_reg) -> None:
    """The port's families are JAX's, with JAX's types and labels."""
    got = _families(port_reg)
    assert {n for n in got if n.startswith("foremast_")} == PORT_WORKER_FAMILIES
    assert got == _families(jax_reg, only=got)


def test_worker_metric_families_equal_jax():
    regs = CollectorRegistry(), CollectorRegistry()
    for mod, reg in zip((jg, tg), regs):
        mod.WorkerMetrics(registry=reg)
        g = mod.BrainGauges(registry=reg, max_families=1)
        g.publish("namespace_app_per_pod:latency", "ns", "app", 2.0, 1.0, 3.0)
        g.publish("second_family", "ns", "app", 2.0, 1.0)  # over the cap: dropped
    _same_families(*regs)
    assert _samples(regs[1]) == _samples(regs[0], only=_families(regs[1]))


def test_device_mesh_families_follow_the_mesh_state_as_jax():
    """observe_device_mesh on the same cumulative device_mesh sections:
    the same gauges and counter deltas as the JAX package's (a smaller
    section, a new judge, adds nothing)."""
    regs = CollectorRegistry(), CollectorRegistry()
    mets = jg.WorkerMetrics(registry=regs[0]), tg.WorkerMetrics(registry=regs[1])
    states = [
        dict(devices=8, arena_total_device_bytes=4096, batch_rows_total=64, pad_rows_total=3,
             place_seconds=0.25, place_bytes=1000, fetch_seconds=0.5, fetch_bytes=200),
        dict(devices=8, arena_total_device_bytes=8192, batch_rows_total=96, pad_rows_total=3,
             place_seconds=0.5, place_bytes=1500, fetch_seconds=0.75, fetch_bytes=300),
        dict(devices=8, arena_total_device_bytes=8192, batch_rows_total=16, pad_rows_total=0,
             place_seconds=0.0, place_bytes=0, fetch_seconds=0.0, fetch_bytes=0),
    ]
    for state in states:
        for m in mets:
            m.observe_device_mesh(state)
    only = {"foremast_device_mesh_devices", "foremast_device_mesh_rows", "foremast_device_mesh_arena_bytes",
            "foremast_device_mesh_transfer_seconds", "foremast_device_mesh_transfer_bytes"}
    got, want = _samples(regs[1], only=only), _samples(regs[0], only=only)
    assert got == want
    assert got[("foremast_device_mesh_rows_total", (("kind", "real"),))] == 93
    assert got[("foremast_device_mesh_transfer_bytes_total", (("leg", "h2d"),))] == 1500


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def test_worker_ticks_feed_the_same_counters():
    """Cold tick, warm tick and a spiked warm tick on both workers, each
    with WorkerMetrics and the verdict-gauge hook on its own registry."""
    regs = CollectorRegistry(), CollectorRegistry()
    mets = jg.WorkerMetrics(registry=regs[0]), tg.WorkerMetrics(registry=regs[1])
    hooks = (jg.make_verdict_hook(jg.BrainGauges(registry=regs[0])),
             tg.make_verdict_hook(tg.BrainGauges(registry=regs[1])))
    (jw, _, jsrc), (pw, _, psrc) = worker_pair(4, hooks=hooks, baseline_frac=0.5)
    jw.metrics, pw.metrics = mets
    for now in (NOW + 150, NOW + 200):
        jw.tick(now=now)
        pw.tick(now=now)
    spike((jsrc, psrc), "http://prom/cur", "latency:app1")
    jw.tick(now=NOW + 250)
    pw.tick(now=NOW + 250)
    want, got = _samples(regs[0], only=_families(regs[1])), _samples(regs[1])
    gauges = {k for k in want if k[0].startswith("foremastbrain_") and "dropped" not in k[0]}
    assert gauges and gauges == {k for k in got if k[0].startswith("foremastbrain_") and "dropped" not in k[0]}
    for k in gauges:  # model bands: the band tolerance of the worker parity tests
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert {k: v for k, v in got.items() if k not in gauges} == {k: v for k, v in want.items() if k not in gauges}
    assert got[("foremast_worker_jobs_total", (("status", "completed_unhealth"),))] == 1
    _same_families(*regs)


def test_observe_server_serves_metrics_health_and_state():
    reg = CollectorRegistry()
    tg.WorkerMetrics(registry=reg).observe_doc("preprocess_completed", 4)
    srv, _ = start_observe_server(0, registry=reg, state_fn=lambda: {"queue_depth": 3}, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        metrics = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert 'foremast_worker_jobs_total{status="preprocess_completed"} 1.0' in metrics
        assert json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read())["ok"] is True
        assert json.loads(urllib.request.urlopen(base + "/debug/state", timeout=10).read()) == {"queue_depth": 3}
    finally:
        srv.shutdown()
        srv.server_close()


INGEST_FAMILIES = {
    "foremast_ingest_fetches", "foremast_ingest_samples", "foremast_ingest_evictions",
    "foremast_ingest_series_resident", "foremast_ingest_bytes_resident", "foremast_ingest_receiver_lag_seconds",
    "foremast_ingest_requests", "foremast_ingest_stage_seconds",
}


def test_ingest_families_equal_jax():
    """`IngestCollector`'s families over the same pushes (JSON and FMW1
    through each package's receiver) and the same reads: JAX's names,
    types and labels, and JAX's values but for the wall-clock ones."""
    from foremast_tpu import ingest as J
    from foremast_tpu_torch import ingest as T

    entries = [(f'm{{app="a{i}"}}', 60 * np.arange(1, 41, dtype=np.int64), np.ones(40, np.float32), 60.0)
               for i in range(3)]
    body = json.dumps({"timeseries": [{"alias": "j", "times": [60, 120], "values": [1.0, 2.0]}]}).encode()
    regs = {}
    for name, m in (("jax", J), ("port", T)):
        store = m.RingStore(shards=2, budget_bytes=2 * 3072)  # one shard holds one ring: evictions
        srv, _ = m.start_ingest_server(0, store, host="127.0.0.1")
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write"
            for data, ctype in ((m.encode_frame(entries), m.BINARY_CONTENT_TYPE), (body, "application/json")):
                urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST",
                                                              headers={"Content-Type": ctype}), timeout=10).read()
            for key, t0, t1, now in (("j", 60, 120, 130.0), ("j", 60, 9_000, 9_000.0), ("nope", 0, 60, 70.0),
                                     ('m{app="a1"}', 0, 2_400, 2_410.0)):
                store.query(key, t0, t1, now)
            reg = CollectorRegistry()
            reg.register(m.IngestCollector(store, wire=srv._foremast_wire_stats))
            regs[name] = reg
        finally:
            m.stop_ingest_server(srv)
    got = _families(regs["port"])
    assert set(got) == INGEST_FAMILIES and got == _families(regs["jax"])
    clocked = ("foremast_ingest_stage_seconds", "foremast_ingest_receiver_lag_seconds")
    values = [{k: v for k, v in _samples(r).items() if not k[0].startswith(clocked)} for r in (regs["port"],
                                                                                              regs["jax"])]
    assert values[0] == values[1]
    assert values[0][("foremast_ingest_evictions_total", ())] > 0
    assert values[0][("foremast_ingest_fetches_total", (("result", "stale"),))] == 1


def test_cold_hist_ring_sources_equal_jax():
    """One tick of a fleet whose histories are resident in the ring feeds
    `foremast_cold_hist_reads_total{source="ring_full"}` alike."""
    from foremast_tpu import ingest as J
    from foremast_tpu.config import BrainConfig as JaxConfig
    from foremast_tpu.jobs import BrainWorker as JaxWorker
    from foremast_tpu.jobs.models import Document as JaxDocument
    from foremast_tpu.jobs.store import InMemoryStore as JaxStore
    from foremast_tpu_torch import ingest as T
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from tests.torch_workers import ring_fleet

    docs, data, (ht, _) = ring_fleet(3)
    entries = [(k, t, v, float(ht[0])) for k, (t, v) in data.items()]
    regs = CollectorRegistry(), CollectorRegistry()
    workers = []
    for (m, store, doc, worker, cfg, g, kw), reg in zip(
        ((J, JaxStore(), JaxDocument, JaxWorker, JaxConfig, jg, {"device_mesh": None}),
         (T, InMemoryStore(), Document, BrainWorker, BrainConfig, tg, {"device": "cpu"})), regs):
        ring = m.RingStore(shards=2)
        ring.push_batch(entries, now=NOW)
        for d in docs:
            store.create(doc.from_json(d))
        workers.append(worker(store, m.RingSource(ring, fallback=None, admit_floor=0.0),
                              config=cfg(algorithm="moving_average_all", max_cache_size=32), claim_limit=4,
                              metrics=g.WorkerMetrics(registry=reg), **kw))
    for w in workers:
        assert w.tick(now=NOW + 150) == 3
    fam = {"foremast_cold_hist_reads"}
    assert _samples(regs[1], only=fam) == _samples(regs[0], only=fam)
    assert _samples(regs[1], only=fam)[("foremast_cold_hist_reads_total", (("source", "ring_full"),))] == 3
