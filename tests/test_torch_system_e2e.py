"""The deployed topology end to end on the port, against the JAX package.

The counterpart of `tests/test_system_e2e.py`: the demo runbook (deploy
v1 -> roll v2 with errors -> Unhealthy -> auto-rollback) driven through
each package's own WatchPlane over its kube fake, LocalAnalyst over its
job store and BrainWorker (the port's on the CPU, running every kernel's
plain version), with the same golden traces; then `chip_smoke.py` phase
14's runbook (`db_arm`) over a small fleet of demo apps, each with its
own history and its own scale and offset on the demo traces, once with
each package's modules, on both routes of the cold fit; and the
dashboard over the gauges each package's worker published, scraped into
`tests/torch_fake_services.py`'s FakePrometheus: the port's panel
through its gateway, JAX's UI and the port's UI on the same samples.

Held equal: monitor phases, remediation, anomaly points, Deployment
images, job statuses, events, every verdict and its flagged points at
every tick, the panels' base curves and anomaly dots; bands within 1e-4
on the f32 route and 1e-5 on the bf16-delta route (the tolerances of
tests/test_kernels.py)."""

from __future__ import annotations

import asyncio
import importlib
import json
import threading
import types

import numpy as np
import pytest

import chip_smoke
from tests.test_watch import FakeClock, make_deployment, seed_pods
from tests.torch_fake_services import FakePrometheus, serve_fake_prometheus

PACKAGES = ("foremast_tpu", "foremast_tpu_torch")
TOL = {"bf16": 1e-5, "f32": 1e-4}


def modules(pkg: str):
    """The modules the runbook drives, of one package."""
    imp = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        config=imp("config"), store=imp("jobs.store"), promql=imp("metrics.promql"), source=imp("metrics.source"),
        gauges=imp("observe.gauges"), analyst=imp("watch.analyst"), crds=imp("watch.crds"),
        kubeapi=imp("watch.kubeapi"), plane=imp("watch.plane"), logger=pkg, jobs_models=imp("jobs.models"),
    )


def make_worker(pkg: str):
    """(store, source, on_verdict) -> the package's BrainWorker on the CPU."""
    worker_mod = importlib.import_module(f"{pkg}.jobs.worker")
    config = importlib.import_module(f"{pkg}.config").BrainConfig

    def make(store, source, hook):
        kw = dict(device="cpu") if pkg == "foremast_tpu_torch" else dict(device_mesh=None)
        return worker_mod.BrainWorker(store, source, config(), claim_limit=64, on_verdict=hook, **kw)

    return make


@pytest.fixture(params=["bf16", "f32"])
def route(request):
    """Both packages' cold fit on one route: the default bf16-delta fit,
    or FOREMAST_BF16_DELTA=0's f32 fit (the port's masked_stats)."""
    from foremast_tpu.engine import scoring as jax_scoring
    from foremast_tpu_torch.engine import scoring as port_scoring

    flag = None if request.param == "bf16" else False
    for mod in (jax_scoring, port_scoring):
        mod.set_bf16_delta(flag)
    yield request.param
    for mod in (jax_scoring, port_scoring):
        mod.set_bf16_delta(None)


# -- the counterpart of tests/test_system_e2e.py ----------------------------------


def golden_runbook(pkg: str, demo_traces) -> dict:
    """tests/test_system_e2e.py's runbook through one package; what it
    ends with, and every verdict's bands."""
    from prometheus_client import CollectorRegistry

    m = modules(pkg)
    crds = m.crds
    kube = m.kubeapi.InMemoryKube()
    kube.add_namespace("demo")
    kube.add_metadata(crds.DeploymentMetadata(
        name="demo", namespace="demo", analyst_endpoint="local://", metrics_endpoint="http://prom:9090/",
        monitoring=[crds.MonitoredMetric("error5xx", metric_type="error5xx", metric_alias="error5xx")]))
    seed_pods(kube)
    store = m.store.InMemoryStore()
    clock = FakeClock()
    plane = m.plane.WatchPlane(kube, clock=clock, sleep=lambda s: None, registry=CollectorRegistry(),
                               analyst_factory=lambda ep: m.analyst.LocalAnalyst(store))
    v1 = make_deployment(image="demo:v1", revision=1)
    v1["metadata"]["resourceVersion"] = "1"
    kube.deployments[("demo", "demo")] = v1
    last = plane.step(last_resync=0.0)
    mon = kube.get_monitor("demo", "demo")
    mon.remediation = crds.Remediation(option=crds.RemediationOption.AUTO_ROLLBACK)
    kube.upsert_monitor(mon)
    v2 = make_deployment(image="demo:v2", revision=2)
    v2["metadata"]["resourceVersion"] = "2"
    kube.deployments[("demo", "demo")] = v2
    clock.t += 30
    last = plane.step(last_resync=last)
    mon = kube.get_monitor("demo", "demo")
    running, job_id = mon.status.phase, mon.status.job_id
    ht, hv = demo_traces["normal"]
    st, sv = demo_traces["spike"]
    source = m.source.ReplaySource()
    source.register("demo-new-1", (st, sv))
    source.register("demo-old-1", (ht, hv))
    source.register("namespace_app_per_pod:error5xx", (ht, hv))
    bands = []
    worker = make_worker(pkg)(store, source, lambda doc, vs: bands.extend(
        (v.alias, int(v.verdict), [float(x) for x in v.anomaly_pairs], np.asarray(v.upper, np.float64),
         np.asarray(v.lower, np.float64)) for v in vs))
    judged = worker.tick(now=clock.t)
    status = store.get(job_id).status
    clock.t += 10
    plane.step(last_resync=last)
    mon = kube.get_monitor("demo", "demo")
    return dict(
        running=(running, bool(job_id)), judged=judged, status=status,
        phase=mon.status.phase, taken=mon.status.remediation_taken, anomaly=mon.status.anomaly,
        image=kube.get_deployment("demo", "demo")["spec"]["template"]["spec"]["containers"][0]["image"],
        reasons=sorted(e["reason"] for e in kube.events), bands=bands,
        unhealthy=m.jobs_models.STATUS_COMPLETED_UNHEALTH,
    )


def test_plane_driven_demo_runbook(demo_traces, route):
    jax, port = (golden_runbook(pkg, demo_traces) for pkg in PACKAGES)
    assert port["running"] == jax["running"] == ("Running", True)
    assert port["judged"] == jax["judged"] >= 1
    assert port["status"] == jax["status"] == port["unhealthy"]
    assert port["phase"] == jax["phase"] == "Unhealthy"
    assert port["taken"] and jax["taken"]
    assert port["anomaly"] == jax["anomaly"]
    assert any(p["value"] > 10 for p in port["anomaly"]["error5xx"]["values"])
    assert port["image"] == jax["image"] == "demo:v1"
    assert port["reasons"] == jax["reasons"]
    assert {"MonitoringStarted", "Unhealthy", "AutoRollback"} <= set(port["reasons"])
    assert len(port["bands"]) == len(jax["bands"])
    for p, j in zip(port["bands"], jax["bands"]):
        assert p[:3] == j[:3]
        np.testing.assert_allclose(p[3], j[3], rtol=0, atol=TOL[route])
        np.testing.assert_allclose(p[4], j[4], rtol=0, atol=TOL[route])


# -- phase 14's runbook over a fleet of demo apps ---------------------------------------

T1 = 1_700_000_040  # a whole minute
APPS = 8


@pytest.fixture(scope="module")
def fleet():
    return chip_smoke.dashboard_fleet(T1, n=APPS, th=1440)


def fleet_runbook(pkg: str, fleet: dict, route: str):
    prom = FakePrometheus()
    run = chip_smoke.db_arm(f"{pkg} {route}", fleet, make_worker(pkg), mods=modules(pkg), scrape_into=prom)
    return run, prom


def test_fleet_runbook_matches_jax_and_the_placement(fleet, route):
    """Every spiked app Unhealthy and rolled back, the others Healthy;
    the first verdict and its flagged points as placed (a point a tenth
    of a sigma across or short of the band on a quarter of the apps);
    the port's runbook equal to JAX's at every tick."""
    (jax, _), (port, _) = (fleet_runbook(pkg, fleet, route) for pkg in PACKAGES)
    for run, pkg in ((jax, "jax"), (port, "port")):
        chip_smoke.db_expected(fleet, run["snap"], pkg, 1e-4)
    chip_smoke.db_same(port["snap"], jax["snap"], f"the port's runbook against JAX's ({route})", TOL[route])
    assert sum(a["spike"] for a in fleet["apps"]) == APPS // 2
    assert [t for t, _, _ in port["ticks"]] == [t for t, _, _ in jax["ticks"]]


def port_panel(prom, fleet, a) -> dict:
    """The port's UI for app `a` through the port's gateway to `prom`."""
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.service.app import make_app as make_gateway
    from foremast_tpu_torch.service.app import make_server
    from foremast_tpu_torch.ui.app import make_app

    prom_srv, prom_url = serve_fake_prometheus(prom)
    # a registry of its own: the JAX gateway's tests register the same family names in this process
    gateway = make_gateway(query_endpoint=prom_url, registry=CollectorRegistry())
    gw_srv = make_server(gateway, "127.0.0.1", 0)
    threading.Thread(target=gw_srv.serve_forever, daemon=True).start()
    ui = make_app(service_endpoint=f"http://127.0.0.1:{gw_srv.server_address[1]}", namespace=a["ns"],
                  app_name=a["app"])
    try:
        resp = ui.handle("GET", chip_smoke.db_panel_query(fleet))
        assert resp.status == 200
        return json.loads(resp.body)
    finally:
        ui.close()
        for srv in (gw_srv, prom_srv):
            srv.shutdown()
            srv.server_close()
        gateway.close()


def jax_panel(prom, fleet, a) -> dict:
    """JAX's UI for app `a`, straight to `prom` (its own fetch path)."""
    from aiohttp.test_utils import TestClient, TestServer

    from foremast_tpu.ui.app import make_app

    prom_srv, prom_url = serve_fake_prometheus(prom)

    async def run():
        app = make_app(service_endpoint=prom_url, namespace=a["ns"], app_name=a["app"])
        async with TestClient(TestServer(app)) as c:
            r = await c.get(chip_smoke.db_panel_query(fleet))
            assert r.status == 200
            return await r.json()

    try:
        return asyncio.run(run())
    finally:
        prom_srv.shutdown()
        prom_srv.server_close()


def test_dashboard_charts_what_each_worker_published(fleet):
    """The runbook's gauges, scraped after each tick, charted: the port's
    panel (through its gateway) on the port worker's gauges puts the
    dots on the worker's flagged points at their measured values and
    the bands it published; JAX's UI on the same samples gives the same
    body; and the port worker's panel equals the JAX worker's (bands
    within 1e-5)."""
    (jax_run, jax_prom), (port_run, port_prom) = (fleet_runbook(pkg, fleet, "bf16") for pkg in PACKAGES)
    for prom in (jax_prom, port_prom):
        chip_smoke.db_base_samples(prom, fleet)
    for a in fleet["apps"][:4]:
        body = port_panel(port_prom, fleet, a)
        chip_smoke.db_panel_check(body, a, port_run["snap"], "port")
        assert jax_panel(port_prom, fleet, a) == body
        other = port_panel(jax_prom, fleet, a)
        chip_smoke.db_panel_check(other, a, jax_run["snap"], "jax")
        for key in ("base", "anomaly", "anomalyJoined"):
            assert other[key] == body[key], key
        for key in ("upper", "lower"):
            assert [d["t"] for d in other[key]] == [d["t"] for d in body[key]]
            np.testing.assert_allclose([d["v"] for d in other[key]], [d["v"] for d in body[key]], rtol=0,
                                       atol=TOL["bf16"])
        assert bool(body["anomalyJoined"]) == a["spike"]
