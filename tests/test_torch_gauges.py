"""The port's Prometheus exposition (`observe/gauges.py`, the worker's
`metrics=` call sites, `start_observe_server`) against the JAX package's:
each family the port exposes has the JAX family's name, type and label
names, and one worker tick pair feeds the same counters in both. The
port exposes only the families its worker feeds: the JAX worker's
sliced-sweep, refinement, micro-tick, verdict-latency and device-mesh
families are left out with those modes."""

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
    "foremast_cold_hist_reads",
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
