"""`HttpKube` on both packages against a real HTTP fake API server
(`tests/fake_kube_server.py`): the 18 cases of `tests/test_httpkube.py`,
each run once with the JAX package's client and once with the port's,
each on a fresh server seeded alike.

Both runs must pass the case's own checks, return the same values, and
leave the same trace on the server: the requests it saw, in order, by
method, path, bearer token and content type. The comparison is exact.
The cases cover the builtin workload reads, 404 -> NotFound, strategic-
and merge-patch content types, events, CRD CRUD with its 409, the
transient-retry policy under the server's fault hooks, the explicit
timeout and its knobs, the `kube` breaker on a refused connection, the
CLI's `watch` / `unwatch`, and one `WatchPlane.step` over the wire."""

from __future__ import annotations

import importlib
import types
import urllib.error

import pytest

from tests.fake_kube_server import FakeKubeServer

PACKAGES = ("foremast_tpu", "foremast_tpu_torch")


def load(pkg: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(pkg=pkg, crds=mod("watch.crds"), kubeapi=mod("watch.kubeapi"),
                                 plane=mod("watch.plane"), chaos=mod("chaos"), cli=mod("cli"))


def _deployment(ns, name, image="app:v1"):
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": ns, "labels": {"app": name}},
        "spec": {"template": {"spec": {"containers": [{"name": "c", "image": image}]}}},
    }


def _monitor(m, ns, name, continuous=False):
    return m.crds.DeploymentMonitor(
        namespace=ns, name=name, continuous=continuous, status=m.crds.MonitorStatus(job_id="job-1", phase="Running")
    )


def _metadata_obj(m):
    return {
        "apiVersion": m.crds.API_VERSION,
        "kind": "DeploymentMetadata",
        "metadata": {"name": "shop", "namespace": "prod"},
        "spec": {
            "analyst": {"endpoint": "http://svc:8099/v1/healthcheck/"},
            "metrics": {
                "dataSourceType": "prometheus",
                "endpoint": "http://prom:9090/",
                "monitoring": [
                    {
                        "metricName": "namespace_pod:http_server_requests_error_5xx",
                        "metricType": "error5xx",
                        "metricAlias": "error5xx",
                    }
                ],
            },
        },
    }


def _trace(srv) -> list:
    return [(m, p, h.get("Authorization"), h.get("Content-Type")) for m, p, h in srv.state.requests]


def _requests_to(srv, part: str) -> int:
    return len([r for r in srv.state.requests if part in r[1]])


# ---------------------------------------------------------------------------
# the cases; each takes (package, server) and returns what it observed
# ---------------------------------------------------------------------------


def c_builtin_workload_reads(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    st = srv.state
    st.put("namespaces", "", {"metadata": {"name": "prod"}})
    st.put("namespaces", "", {"metadata": {"name": "dev"}})
    st.put("deployments", "prod", _deployment("prod", "shop"))
    st.put("deployments", "dev", _deployment("dev", "cart"))
    st.put("replicasets", "prod", {"metadata": {"name": "shop-abc"}})
    st.put("pods", "prod", {"metadata": {"name": "shop-abc-1"}})
    out = [
        sorted(n["metadata"]["name"] for n in kube.list_namespaces()),
        kube.get_namespace("prod"),
        len(kube.list_deployments()),
        [d["metadata"]["name"] for d in kube.list_deployments("prod")],
        kube.get_deployment("prod", "shop")["metadata"]["labels"],
        kube.list_replicasets("prod")[0]["metadata"]["name"],
        kube.list_pods("prod")[0]["metadata"]["name"],
    ]
    assert out[0] == ["dev", "prod"] and out[2] == 2 and out[3] == ["shop"] and out[4] == {"app": "shop"}
    assert out[5] == "shop-abc" and out[6] == "shop-abc-1"
    return out


def c_get_missing_raises_notfound(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    for call in (lambda: kube.get_deployment("prod", "ghost"), lambda: kube.get_namespace("ghost"),
                 lambda: kube.get_monitor("prod", "ghost"), lambda: kube.get_metadata("prod", "ghost")):
        with pytest.raises(m.kubeapi.NotFound):
            call()


def c_patch_deployment_strategic_merge(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    srv.state.put("deployments", "prod", _deployment("prod", "shop"))
    out = kube.patch_deployment("prod", "shop", {"spec": {"paused": True, "template": None}})
    assert out["spec"]["paused"] is True and "template" not in out["spec"]
    patches = [h for mm, p, h in srv.state.requests if mm == "PATCH" and "shop" in p]
    assert patches[0]["Content-Type"] == "application/strategic-merge-patch+json"
    return out


def c_patch_missing_deployment_raises_notfound(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    with pytest.raises(m.kubeapi.NotFound):
        kube.patch_deployment("prod", "ghost", {"spec": {"paused": True}})


def c_create_event(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    kube.create_event("prod", {"metadata": {"name": "ev1"}, "reason": "Unhealthy"})
    assert ("prod", "ev1") in srv.state.objects["events"]
    return srv.state.objects["events"][("prod", "ev1")]


def c_bearer_token_sent(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    srv.state.put("namespaces", "", {"metadata": {"name": "prod"}})
    kube.get_namespace("prod")
    assert all(h.get("Authorization") == "Bearer test-token" for _, _, h in srv.state.requests)


def c_monitor_crud_roundtrip(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    created = kube.upsert_monitor(_monitor(m, "prod", "shop"))
    assert created.name == "shop"
    assert kube.get_monitor("prod", "shop").status.job_id == "job-1"
    assert [x.name for x in kube.list_monitors("prod")] == ["shop"]
    assert [x.name for x in kube.list_monitors()] == ["shop"]
    updated = kube.upsert_monitor(_monitor(m, "prod", "shop", continuous=True))
    assert updated.continuous is True
    patched = kube.patch_monitor("prod", "shop", {"spec": {"continuous": False}})
    assert patched.continuous is False and patched.status.job_id == "job-1"
    kube.delete_monitor("prod", "shop")
    with pytest.raises(m.kubeapi.NotFound):
        kube.get_monitor("prod", "shop")
    kube.delete_monitor("prod", "shop")  # idempotent: swallowed 404
    return [created.to_json(), updated.to_json(), patched.to_json()]


def c_upsert_conflict_surfaces_409(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    kube.upsert_monitor(_monitor(m, "prod", "shop"))
    orig = srv.state.objects["deploymentmonitors"][("prod", "shop")]
    done = {}

    class RacingKube(m.kubeapi.HttpKube):
        def _req(self, method, path, body=None, content_type="application/json"):
            out = super()._req(method, path, body, content_type)
            if method == "GET" and not done:
                done["raced"] = True
                with srv.state.lock:
                    orig["metadata"]["resourceVersion"] = srv.state.next_rv()
            return out

    with pytest.raises(urllib.error.HTTPError) as ei:
        RacingKube(base_url=srv.url).upsert_monitor(_monitor(m, "prod", "shop", continuous=True))
    assert ei.value.code == 409


def c_metadata_read(m, srv):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="test-token")
    srv.state.put("deploymentmetadatas", "prod", _metadata_obj(m))
    md = kube.get_metadata("prod", "shop")
    assert md.analyst_endpoint == "http://svc:8099/v1/healthcheck/"
    assert md.monitoring[0].metric_type == "error5xx"
    return md.to_json()


def c_cli_watch_unwatch_against_real_server(m, srv, capsys):
    main = m.cli.main
    m.kubeapi.HttpKube(base_url=srv.url).upsert_monitor(_monitor(m, "prod", "shop"))
    rcs = [main(["watch", "shop", "--namespace", "prod", "--api-server", srv.url])]
    out = capsys.readouterr().out
    assert "watching application shop" in out
    assert m.kubeapi.HttpKube(base_url=srv.url).get_monitor("prod", "shop").continuous is True
    rcs.append(main(["unwatch", "shop", "--namespace", "prod", "--api-server", srv.url]))
    out += capsys.readouterr().out
    assert not m.kubeapi.HttpKube(base_url=srv.url).get_monitor("prod", "shop").continuous
    rcs.append(main(["watch", "ghost", "--namespace", "prod", "--api-server", srv.url]))
    err = capsys.readouterr().err
    assert rcs == [0, 0, 1]
    return rcs, out, err


def c_watch_plane_step_against_real_server(m, srv):
    from prometheus_client import CollectorRegistry

    st = srv.state
    st.put("namespaces", "", {"metadata": {"name": "prod"}})
    st.put("deploymentmetadatas", "prod", _metadata_obj(m))
    st.put("deployments", "prod", _deployment("prod", "shop"))
    kube = m.kubeapi.HttpKube(base_url=srv.url)
    plane = m.plane.WatchPlane(kube, own_namespace="foremast", registry=CollectorRegistry())
    plane.step(now=1_700_000_000.0)
    monitors = kube.list_monitors("prod")
    assert [x.name for x in monitors] == ["shop"]
    return [x.to_json() for x in monitors]


def c_httpkube_retries_transient_5xx_then_succeeds(m, srv):
    srv.state.put("namespaces", "", {"metadata": {"name": "prod"}})
    srv.state.add_fault(path="/api/v1/namespaces", status=503, times=2)
    kube = m.kubeapi.HttpKube(base_url=srv.url, retries=2, backoff_seconds=0.001)
    names = [n["metadata"]["name"] for n in kube.list_namespaces()]
    assert names == ["prod"] and _requests_to(srv, "namespaces") == 3
    return names


def c_httpkube_retries_429_and_exhausts_budget(m, srv):
    srv.state.add_fault(path="/api/v1/namespaces", status=429)  # forever
    kube = m.kubeapi.HttpKube(base_url=srv.url, retries=1, backoff_seconds=0.001)
    with pytest.raises(urllib.error.HTTPError) as ei:
        kube.list_namespaces()
    assert ei.value.code == 429 and _requests_to(srv, "namespaces") == 2


def c_httpkube_hard_4xx_fails_fast_no_retry(m, srv):
    srv.state.add_fault(path="/api/v1/namespaces", status=403)
    kube = m.kubeapi.HttpKube(base_url=srv.url, retries=3, backoff_seconds=0.001)
    with pytest.raises(urllib.error.HTTPError) as ei:
        kube.list_namespaces()
    assert ei.value.code == 403 and _requests_to(srv, "namespaces") == 1


def c_httpkube_404_stays_notfound_after_faulted_retry(m, srv):
    srv.state.add_fault(path="/deployments/", status=502, times=1)
    kube = m.kubeapi.HttpKube(base_url=srv.url, retries=2, backoff_seconds=0.001)
    with pytest.raises(m.kubeapi.NotFound):
        kube.get_deployment("prod", "ghost")


def c_httpkube_explicit_timeout_and_knobs(m, srv, monkeypatch):
    monkeypatch.setenv("FOREMAST_KUBE_TIMEOUT_SECONDS", "7.5")
    monkeypatch.setenv("FOREMAST_FETCH_RETRIES", "4")
    kube = m.kubeapi.HttpKube(base_url="http://unused:1")
    out = [kube.timeout, kube.retries]
    monkeypatch.delenv("FOREMAST_KUBE_TIMEOUT_SECONDS")
    monkeypatch.delenv("FOREMAST_FETCH_RETRIES")
    kube = m.kubeapi.HttpKube(base_url="http://unused:1", timeout=3.0, retries=0)
    out += [kube.timeout, kube.retries]
    assert out == [7.5, 4, 3.0, 0]
    return out


def c_httpkube_breaker_opens_on_connection_refused(m, srv):
    br = m.chaos.CircuitBreaker("kube", failure_threshold=2, open_seconds=60.0)
    kube = m.kubeapi.HttpKube(base_url="http://127.0.0.1:1", retries=0, backoff_seconds=0.001, timeout=0.2,
                              breaker=br)
    for _ in range(2):
        with pytest.raises(OSError):
            kube.list_namespaces()
    with pytest.raises(m.chaos.BreakerOpen):
        kube.list_namespaces()
    return br.state


def c_httpkube_latency_fault_hook_respects_timeout(m, srv):
    srv.state.add_fault(path="/api/v1/namespaces", latency=1.5)
    kube = m.kubeapi.HttpKube(base_url=srv.url, timeout=0.2, retries=0)
    with pytest.raises(OSError):
        kube.list_namespaces()


CASES = {name[2:]: fn for name, fn in dict(globals()).items() if name.startswith("c_")}


def test_every_case_of_the_jax_httpkube_tests_is_here():
    import ast
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).parent / "test_httpkube.py").read_text())
    jax_tests = {n.name[5:] for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(jax_tests) == 18 and jax_tests == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_httpkube_case_matches_jax(name, capsys, monkeypatch):
    fn = CASES[name]
    extra = {"capsys": capsys} if "capsys" in fn.__code__.co_varnames else {}
    if "monkeypatch" in fn.__code__.co_varnames:
        extra["monkeypatch"] = monkeypatch
    results, traces = [], []
    for pkg in PACKAGES:
        with FakeKubeServer() as srv:
            results.append(fn(load(pkg), srv, **extra))
            traces.append(_trace(srv))
    assert results[1] == results[0]
    assert traces[1] == traces[0]


def test_kube_chaos_edge_injects_on_the_watch_plane_client():
    """A FOREMAST_CHAOS_PLAN rule on the `kube` edge perturbs `HttpKube`'s
    requests in both packages alike: same seed, same call order, same
    faults, same injection counts and the same requests reaching the
    server (retries absorb the faults of GETs)."""
    outcomes = []
    for pkg in PACKAGES:
        m = load(pkg)
        plan = m.chaos.FaultPlan.from_json(
            {"seed": 7, "rules": [{"edge": "kube", "error_rate": 0.5, "kind": "connection"}]}
        ).activate()
        with FakeKubeServer() as srv:
            srv.state.put("namespaces", "", {"metadata": {"name": "prod"}})
            kube = m.kubeapi.HttpKube(base_url=srv.url, retries=3, backoff_seconds=0.0,
                                      chaos=plan.edge("kube"))
            got = []
            for _ in range(12):
                try:
                    got.append(len(kube.list_namespaces()))
                except OSError as e:
                    got.append(type(e).__name__)
            outcomes.append((got, plan.injections_snapshot(), len(srv.state.requests)))
    assert outcomes[1] == outcomes[0]
    assert sum(outcomes[1][1].values()) > 0
