"""The watch plane on both packages: the 19 scenarios of
`tests/test_watch.py` (watcher, poller, remediation, and the deploy ->
score -> rollback loop over the in-memory kube fake), each run once on the
JAX package's `foremast_tpu.watch` and once on the port's
`foremast_tpu_torch.watch`, from the same fixtures and the same fake clock.

After each scenario the two worlds are compared whole: every monitor's
`to_json()`, every Deployment object, the kube fake's action log
(creates, updates, patches with their bodies, deletes), the events (their
reason, type, message and involved object) and every job document. The
comparison is exact. Two fields are left out because they are stamped
with the host's wall clock by both packages alike: each monitor's
`status.timestamp` and each event's unique `metadata.name`; documents are
compared without `createdAt` / `modifiedAt` for the same reason. In the
end-to-end scenario the JAX worker and the port's worker (`device="cpu"`,
every kernel's plain version) judge the same job; its status, reason and
anomaly payload must be equal as JSON."""

from __future__ import annotations

import copy
import importlib
import types

import pytest

PACKAGES = ("foremast_tpu", "foremast_tpu_torch")


def load(pkg: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        pkg=pkg,
        config=mod("config"),
        models=mod("jobs.models"),
        store=mod("jobs.store"),
        worker=mod("jobs.worker"),
        source=mod("metrics.source"),
        analyst=mod("watch.analyst"),
        barrelman=mod("watch.barrelman"),
        controller=mod("watch.controller"),
        crds=mod("watch.crds"),
        kubeapi=mod("watch.kubeapi"),
    )


# ---------------------------------------------------------------------------
# fixtures (those of tests/test_watch.py, built from either package)
# ---------------------------------------------------------------------------


def make_deployment(name="demo", namespace="demo", image="demo:v1", revision=1, env=None, uid="dep-1"):
    return {
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": uid,
            "labels": {"app": name},
            "annotations": {"deployment.kubernetes.io/revision": str(revision)},
        },
        "spec": {
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {"containers": [{"name": "main", "image": image, "env": env or []}]},
            }
        },
    }


def make_rs(name, namespace, dep_uid, revision, replicas=1, uid=None, image="demo:v1"):
    return {
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": uid or f"rs-{name}",
            "annotations": {"deployment.kubernetes.io/revision": str(revision)},
            "ownerReferences": [{"uid": dep_uid}],
        },
        "spec": {
            "replicas": replicas,
            "template": {
                "metadata": {"labels": {"app": "demo", "pod-template-hash": name}},
                "spec": {"containers": [{"name": "main", "image": image}]},
            },
        },
        "status": {"replicas": replicas},
    }


def make_pod(name, namespace, rs_uid):
    return {"metadata": {"name": name, "namespace": namespace, "uid": f"pod-{name}", "ownerReferences": [{"uid": rs_uid}]}}


class FakeClock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def make_world(pkg: str) -> types.SimpleNamespace:
    """kube fake + job store + barrelman wired through LocalAnalyst."""
    m = load(pkg)
    kube = m.kubeapi.InMemoryKube()
    kube.add_namespace("demo")
    kube.add_metadata(
        m.crds.DeploymentMetadata(
            name="demo",
            namespace="demo",
            analyst_endpoint="local://",
            metrics_endpoint="http://prom:9090/",
            monitoring=[m.crds.MonitoredMetric("error5xx", metric_type="error5xx", metric_alias="error5xx")],
        )
    )
    store = m.store.InMemoryStore()
    clock = FakeClock()
    bman = m.barrelman.Barrelman(
        kube, analyst_factory=lambda ep: m.analyst.LocalAnalyst(store), clock=clock, sleep=lambda s: None
    )
    kube.on_deployment(bman.handle_deployment)
    # each world's controllers count transitions on their own registry: the
    # two packages' families share a name, and one process holds both here
    from prometheus_client import CollectorRegistry

    registry = CollectorRegistry()

    def controller(*a, **kw):
        return m.controller.MonitorController(*a, registry=registry, **kw)

    return types.SimpleNamespace(m=m, kube=kube, store=store, bman=bman, clock=clock, controller=controller)


def seed_pods(kube, dep_uid="dep-1", old_rev=1, new_rev=2):
    kube.add_replicaset(make_rs("demo-old", "demo", dep_uid, old_rev, image="demo:v1"))
    kube.add_replicaset(make_rs("demo-new", "demo", dep_uid, new_rev, image="demo:v2"))
    kube.add_pod(make_pod("demo-old-1", "demo", "rs-demo-old"))
    kube.add_pod(make_pod("demo-new-1", "demo", "rs-demo-new"))


def snapshot(w) -> dict:
    """The world's observable state, with the wall-clock stamps left out."""
    monitors = {}
    for key, mon in sorted(w.kube.monitors.items()):
        js = copy.deepcopy(mon.to_json())
        js["status"].pop("timestamp")
        monitors[key] = js
    events = []
    for e in w.kube.events:
        e = copy.deepcopy(e)
        e["metadata"].pop("name")
        events.append(e)
    docs = {}
    for doc_id, doc in sorted(w.store._docs.items()):
        js = doc.to_json()
        js.pop("createdAt")
        js.pop("modifiedAt")
        docs[doc_id] = js
    return dict(
        monitors=monitors,
        deployments=copy.deepcopy(dict(sorted(w.kube.deployments.items()))),
        actions=copy.deepcopy(w.kube.actions),
        events=events,
        docs=docs,
    )


# ---------------------------------------------------------------------------
# the scenarios; each returns what it observed besides the world's state
# ---------------------------------------------------------------------------


def s_env_equals_order_insensitive(w):
    a = [{"name": "A", "value": "1"}, {"name": "B", "value": "2"}]
    b = [{"name": "B", "value": "2"}, {"name": "A", "value": "1"}]
    out = [w.m.barrelman.env_equals(a, b),
           w.m.barrelman.env_equals(a, [{"name": "A", "value": "9"}, {"name": "B", "value": "2"}])]
    assert out == [True, False]
    return out


def s_containers_changed_on_image_and_env(w):
    changed = w.m.barrelman.containers_changed
    old = make_deployment(image="demo:v1")
    out = [
        changed(old, make_deployment(image="demo:v1")),
        changed(old, make_deployment(image="demo:v2")),
        changed(old, make_deployment(image="demo:v1", env=[{"name": "X", "value": "1"}])),
    ]
    assert out == [False, True, True]
    return out


def s_crd_roundtrip(w):
    c = w.m.crds
    m = c.DeploymentMonitor(
        name="demo",
        namespace="demo",
        selector={"app": "demo"},
        continuous=True,
        remediation=c.Remediation(option=c.RemediationOption.AUTO_ROLLBACK),
        rollback_revision=3,
    )
    m.status.phase = c.MonitorPhase.RUNNING
    m2 = c.DeploymentMonitor.from_json(m.to_json())
    assert m2 == m
    md = c.DeploymentMetadata(
        name="x", namespace="y", analyst_endpoint="http://a/", monitoring=[c.MonitoredMetric("m1", "latency", "lat")]
    )
    assert c.DeploymentMetadata.from_json(md.to_json()) == md
    assert md.metric_names() == {"lat": "m1"}
    return [m2.to_json(), md.to_json(), md.metric_names()]


def s_convert_to_anomaly_flat_pairs(w):
    out = w.m.controller.convert_to_anomaly({"tags": "", "values": {"error5xx": [100.0, 40.1, 160.0, 41.0]}})
    assert out["error5xx"]["values"] == [{"time": 100.0, "value": 40.1}, {"time": 160.0, "value": 41.0}]
    return out


def s_status_to_phase_map(w):
    statuses = ("new", "inprogress", "success", "anomaly", "abort", "garbage")
    out = [w.m.analyst.status_to_phase(s) for s in statuses]
    assert out == ["Running", "Running", "Healthy", "Unhealthy", "Abort", "Failed"]
    return out


def s_namespace_blacklist_and_annotation(w):
    kube, bman, clock = w.kube, w.bman, w.clock
    out = [bman.namespace_monitored("kube-system"), bman.namespace_monitored("monitoring"),
           bman.namespace_monitored("demo")]
    kube.add_namespace("optout", {"foremast.ai/monitoring": "false"})
    out.append(bman.namespace_monitored("optout"))
    # cached for 5 min: flipping the annotation is invisible until TTL
    kube.add_namespace("optout", {"foremast.ai/monitoring": "true"})
    out.append(bman.namespace_monitored("optout"))
    clock.t += 301
    out.append(bman.namespace_monitored("optout"))
    assert out == [False, False, True, False, False, True]
    return out


def s_metadata_fallback_chain(w):
    kube, bman, clock = w.kube, w.bman, w.clock
    dep = make_deployment(name="other", namespace="demo")
    dep["metadata"]["labels"]["appType"] = "java-service"
    out = [bman.get_metadata(dep)]
    kube.add_metadata(w.m.crds.DeploymentMetadata(name="java-service", namespace="foremast"))
    out.append(bman.get_metadata(dep))
    clock.t += 61
    md = bman.get_metadata(dep)
    assert out == [None, None] and md is not None and md.name == "java-service"
    return md.to_json()


def s_add_creates_monitor(w):
    w.kube.apply_deployment(make_deployment())
    assert ("demo", "demo") in w.kube.monitors


def s_image_update_starts_job(w):
    kube, store = w.kube, w.store
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    kube.apply_deployment(make_deployment(image="demo:v2", revision=2))
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Running" and mon.status.job_id
    doc = store.get(mon.status.job_id)
    assert doc is not None and "demo-new-1" in doc.current_config
    assert mon.rollback_revision == 1


def s_no_metadata_no_job(w):
    kube = w.kube
    kube.add_namespace("bare")
    kube.apply_deployment(make_deployment(name="nomd", namespace="bare", uid="dep-9"))
    kube.apply_deployment(make_deployment(name="nomd", namespace="bare", image="demo:v2", uid="dep-9"))
    assert kube.get_monitor("bare", "nomd").status.job_id == ""


def s_rollback_loop_suppression(w):
    kube, store = w.kube, w.store
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    mon = kube.get_monitor("demo", "demo")
    mon.rollback_revision = 3
    kube.upsert_monitor(mon)
    n_jobs = len(store._docs)
    kube.apply_deployment(make_deployment(image="demo:v1-rb", revision=3))
    assert len(store._docs) == n_jobs
    dep = make_deployment(image="demo:v3", revision=4)
    dep["metadata"]["annotations"]["deprecated.deployment.rollback.to"] = "1"
    kube.apply_deployment(dep)
    assert len(store._docs) == n_jobs


def s_canary_suffix_maps_to_primary_monitor(w):
    kube, store, c = w.kube, w.store, w.m.crds
    kube.add_metadata(
        c.DeploymentMetadata(
            name="demo-foremast-canary",
            namespace="demo",
            analyst_endpoint="local://",
            metrics_endpoint="http://prom:9090/",
            monitoring=[c.MonitoredMetric("error5xx")],
        )
    )
    canary_uid = "dep-canary"
    kube.add_replicaset(make_rs("canary-rs", "demo", canary_uid, 1, image="demo:v2"))
    kube.add_pod(make_pod("canary-1", "demo", "rs-canary-rs"))
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    seed_pods(kube, old_rev=1, new_rev=1)
    kube.apply_deployment(make_deployment(name="demo-foremast-canary", uid=canary_uid, image="demo:v2"))
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Running"
    doc = store.get(mon.status.job_id)
    assert "canary-1" in doc.current_config
    assert "demo-new-1" in doc.baseline_config or "demo-old-1" in doc.baseline_config


def unhealthy_store_with_job(w):
    kube, store = w.kube, w.store
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    kube.apply_deployment(make_deployment(image="demo:v2", revision=2))
    mon = kube.get_monitor("demo", "demo")
    doc = store.get(mon.status.job_id)
    doc.status = w.m.models.STATUS_COMPLETED_UNHEALTH
    doc.reason = "anomaly detected"
    doc.anomaly_info = {"tags": "", "values": {"error5xx": [100.0, 40.1]}}
    store.update(doc)
    return mon


def s_poll_unhealthy_triggers_rollback(w):
    kube, c = w.kube, w.m.crds
    mon = unhealthy_store_with_job(w)
    mon.remediation = c.Remediation(option=c.RemediationOption.AUTO_ROLLBACK)
    kube.upsert_monitor(mon)
    ctl = w.controller(kube, w.bman, clock=w.clock)
    ctl.tick()
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Unhealthy" and mon.status.remediation_taken
    assert mon.status.anomaly["error5xx"]["values"] == [{"time": 100.0, "value": 40.1}]
    dep = kube.get_deployment("demo", "demo")
    assert dep["spec"]["template"]["spec"]["containers"][0]["image"] == "demo:v1"
    patches = [a for a in kube.actions if a[0] == "patch"]
    ctl.tick()
    assert [a for a in kube.actions if a[0] == "patch"] == patches


def s_poll_unhealthy_pause(w):
    kube, c = w.kube, w.m.crds
    mon = unhealthy_store_with_job(w)
    mon.remediation = c.Remediation(option=c.RemediationOption.AUTO_PAUSE)
    kube.upsert_monitor(mon)
    w.controller(kube, w.bman, clock=w.clock).tick()
    assert kube.get_deployment("demo", "demo")["spec"]["paused"] is True


def s_wait_until_expiry_defaults_healthy(w):
    kube, clock = w.kube, w.clock
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    kube.apply_deployment(make_deployment(image="demo:v2", revision=2))
    ctl = w.controller(kube, w.bman, clock=clock)
    ctl.tick()
    assert kube.get_monitor("demo", "demo").status.phase == "Running"
    clock.t += 1801
    ctl.tick()
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Healthy" and mon.status.expired


def s_continuous_rearm_with_backoff(w):
    kube, store, clock = w.kube, w.store, w.clock
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    mon = kube.get_monitor("demo", "demo")
    mon.continuous = True
    mon.status.phase = "Unhealthy"
    kube.upsert_monitor(mon)
    ctl = w.controller(kube, w.bman, clock=clock)
    ctl._unhealthy_since[("demo", "demo")] = clock.t
    ctl.tick()
    assert kube.get_monitor("demo", "demo").status.phase == "Unhealthy"
    clock.t += 61
    ctl.tick()
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Running" and mon.continuous
    assert "namespace_app_per_pod" in store.get(mon.status.job_id).current_config


def s_delete_deployment_deletes_monitor(w):
    kube = w.kube
    kube.apply_deployment(make_deployment())
    assert ("demo", "demo") in kube.monitors
    kube.remove_deployment("demo", "demo")
    assert ("demo", "demo") not in kube.monitors


def s_e2e_deploy_score_rollback(w, traces):
    kube, store, clock, c = w.kube, w.store, w.clock, w.m.crds
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    mon = kube.get_monitor("demo", "demo")
    mon.remediation = c.Remediation(option=c.RemediationOption.AUTO_ROLLBACK)
    kube.upsert_monitor(mon)
    kube.apply_deployment(make_deployment(image="demo:v2", revision=2))

    ht, hv = traces["normal"]
    st, sv = traces["spike"]
    source = w.m.source.ReplaySource()
    source.register("demo-new-1", (st, sv))
    source.register("demo-old-1", (ht, hv))
    source.register("namespace_app_per_pod:error5xx", (ht, hv))
    kw = {"device": "cpu"} if w.m.pkg == "foremast_tpu_torch" else {}
    worker = w.m.worker.BrainWorker(store, source, config=w.m.config.BrainConfig(), worker_id="brain-e2e", **kw)
    try:
        assert worker.tick(now=clock.t) >= 1
    finally:
        worker.close()
    mon = kube.get_monitor("demo", "demo")
    assert store.get(mon.status.job_id).status == w.m.models.STATUS_COMPLETED_UNHEALTH

    w.controller(kube, w.bman, clock=clock).tick()
    mon = kube.get_monitor("demo", "demo")
    assert mon.status.phase == "Unhealthy" and mon.status.remediation_taken
    assert mon.status.anomaly.get("error5xx", {}).get("values")
    assert kube.get_deployment("demo", "demo")["spec"]["template"]["spec"]["containers"][0]["image"] == "demo:v1"


def s_events_emitted_on_monitoring_and_remediation(w):
    kube = w.kube
    seed_pods(kube)
    kube.apply_deployment(make_deployment(image="demo:v1", revision=1))
    kube.apply_deployment(make_deployment(image="demo:v2", revision=2))
    assert "MonitoringStarted" in [e["reason"] for e in kube.events]
    mon = kube.get_monitor("demo", "demo")
    mon.remediation.option = "AutoRollback"
    mon.status.phase = "Unhealthy"
    w.controller(kube, w.bman, clock=w.clock).handle_transition(mon)
    types_ = {e["reason"]: e["type"] for e in kube.events}
    assert types_.get("Unhealthy") == "Warning" and types_["MonitoringStarted"] == "Normal"


SCENARIOS = {name[2:]: fn for name, fn in dict(globals()).items() if name.startswith("s_")}


def test_every_scenario_of_the_jax_watch_tests_is_here():
    import ast
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).parent / "test_watch.py").read_text())
    jax_tests = {n.name[5:] for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(jax_tests) == 19
    assert jax_tests == set(SCENARIOS)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watch_scenario_matches_jax(name, demo_traces):
    fn = SCENARIOS[name]
    results, states = [], []
    for pkg in PACKAGES:
        w = make_world(pkg)
        out = fn(w, demo_traces) if name == "e2e_deploy_score_rollback" else fn(w)
        results.append(out)
        states.append(snapshot(w))
    jax_state, port_state = states
    assert results[1] == results[0]
    for part in ("monitors", "deployments", "actions", "events", "docs"):
        assert port_state[part] == jax_state[part], part
