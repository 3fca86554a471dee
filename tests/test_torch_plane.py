"""The watch-plane loop and the streaming informer on both packages.

The 5 cases of `tests/test_plane.py` (list+diff informer semantics, the
scheduler step, monitor creation on the first resync, `debug_state`) over
the in-memory kube fake, and the watch-stream cases of
`tests/test_reactive.py` (dispatch on arrival, resume after a torn
stream, 410 re-list, compaction, a failed re-list, mid-stream ERROR
events, stalls, the breaker on answered 4xx, the plane's informer choice
and one `run_stream` pass) against `tests/fake_kube_server.py`'s real
chunked watch endpoint. Each case runs once on the JAX package's
`foremast_tpu.watch` / `reactive.watchstream` and once on the port's, on
fresh fakes seeded alike; the handler events (type and object name, in
order), the informer's restart counts and each case's observations must
be equal. The comparison is exact."""

from __future__ import annotations

import importlib
import threading
import time
import types

import pytest
from prometheus_client import CollectorRegistry

from tests.fake_kube_server import FakeKubeServer

PACKAGES = ("foremast_tpu", "foremast_tpu_torch")


def load(pkg: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(pkg=pkg, kubeapi=mod("watch.kubeapi"), plane=mod("watch.plane"),
                                 stream=mod("reactive.watchstream"), spans=mod("observe.spans"),
                                 breaker=mod("chaos.breaker"))


def both(case) -> list:
    """`case(package)` on the JAX package, then on the port; the two
    results must be equal."""
    out = [case(load(pkg)) for pkg in PACKAGES]
    assert out[1] == out[0]
    return out[1]


# ---------------------------------------------------------------------------
# tests/test_plane.py
# ---------------------------------------------------------------------------


def _pdep(ns, name, image="app:v1", rv="1", labels=None):
    return {
        "metadata": {
            "namespace": ns,
            "name": name,
            "resourceVersion": rv,
            "labels": labels if labels is not None else {"app": name},
            "uid": f"uid-{ns}-{name}",
        },
        "spec": {"template": {"spec": {"containers": [{"name": "c", "image": image}]}}},
    }


def test_informer_emits_add_update_delete():
    def case(m):
        kube = m.kubeapi.InMemoryKube()
        events = []
        inf = m.plane.DeploymentInformer(kube, lambda e, d, old: events.append((e, d, old)))
        kube.deployments[("ns", "a")] = _pdep("ns", "a")
        inf.resync()
        assert [e for e, *_ in events] == ["add"]
        inf.resync()  # unchanged resourceVersion -> no event
        assert len(events) == 1
        kube.deployments[("ns", "a")] = _pdep("ns", "a", image="app:v2", rv="2")
        inf.resync()
        assert events[-1][0] == "update" and events[-1][2]["metadata"]["resourceVersion"] == "1"
        del kube.deployments[("ns", "a")]
        inf.resync()
        assert events[-1][0] == "delete"
        return events

    both(case)


def test_informer_handler_errors_do_not_stop_resync():
    def case(m):
        kube = m.kubeapi.InMemoryKube()
        kube.deployments[("ns", "a")] = _pdep("ns", "a")
        kube.deployments[("ns", "b")] = _pdep("ns", "b")
        seen = []

        def handler(e, d, old):
            seen.append(d["metadata"]["name"])
            raise RuntimeError("boom")

        m.plane.DeploymentInformer(kube, handler).resync()
        assert sorted(seen) == ["a", "b"]
        return seen

    both(case)


def test_watchplane_step_resync_schedule():
    def case(m):
        kube = m.kubeapi.InMemoryKube()
        now = [1000.0]
        plane = m.plane.WatchPlane(kube, clock=lambda: now[0], sleep=lambda s: None, registry=CollectorRegistry())
        resyncs = []
        plane.informer.resync = lambda: resyncs.append(now[0])
        lasts = [plane.step(last_resync=0.0)]
        now[0] += 10
        lasts.append(plane.step(last_resync=lasts[-1]))
        now[0] += m.plane.DEPLOY_RESYNC_SECONDS
        lasts.append(plane.step(last_resync=lasts[-1]))
        assert resyncs == [1000.0, 1040.0] and lasts == [1000.0, 1000.0, 1040.0]
        return resyncs, lasts

    both(case)


def test_watchplane_creates_monitor_for_existing_deployment():
    def case(m):
        kube = m.kubeapi.InMemoryKube()
        kube.deployments[("prod", "shop")] = _pdep("prod", "shop")
        plane = m.plane.WatchPlane(kube, clock=lambda: 0.0, sleep=lambda s: None, registry=CollectorRegistry())
        plane.step(last_resync=0.0)
        assert ("prod", "shop") in kube.monitors
        return {k: v.to_json() for k, v in kube.monitors.items()}, kube.actions

    both(case)


def test_watchplane_debug_state():
    def case(m):
        kube = m.kubeapi.InMemoryKube()
        kube.deployments[("prod", "shop")] = _pdep("prod", "shop")
        now = [100.0]
        reg = CollectorRegistry()
        plane = m.plane.WatchPlane(kube, clock=lambda: now[0], sleep=lambda s: None,
                                   tracer=m.spans.Tracer(service="controller", registry=reg), registry=reg)
        now[0] += 7
        plane.step(last_resync=0.0)
        state = plane.debug_state()
        assert state["component"] == "controller" and state["version"]
        assert state["uptime_seconds"] == 7.0 and state["deployments_cached"] == 1 and "trace" in state
        # the port's tracer also counts the collector's pauses (`gc`), a
        # section the JAX tracer lacks
        return {k: v for k, v in state.items() if k != "trace"}, sorted(set(state["trace"]) - {"gc"})

    both(case)


# ---------------------------------------------------------------------------
# the streaming watch (tests/test_reactive.py) against the fake kube server
# ---------------------------------------------------------------------------


def _dep(name, ns="ns", labels=None):
    return {"metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}", **({"labels": labels} if labels else {})}}


def _informer(m, srv, events):
    kube = m.kubeapi.HttpKube(base_url=srv.url, token="t")
    return m.stream.StreamingInformer(kube, lambda e, d, old: events.append((e, d["metadata"]["name"])))


def test_watch_stream_dispatches_on_arrival():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            srv.state.put("deployments", "ns", _dep("d1"))
            inf = _informer(m, srv, events)
            inf.resync()
            assert events == [("add", "d1")]

            def later():
                time.sleep(0.15)
                srv.state.put("deployments", "ns", _dep("d2"))

            t = threading.Thread(target=later)
            t.start()
            t0 = time.monotonic()
            n = inf.consume(1.0, stall_margin=1.0)
            t.join()
            assert n >= 1 and ("add", "d2") in events
            srv.state.put("deployments", "ns", _dep("d2", labels={"v": "2"}))
            assert inf.consume(1.0, stall_margin=1.0) >= 1
            assert events[-1] == ("update", "d2") and inf.counts["events"] >= 2
            assert time.monotonic() - t0 < 5.0
        return events

    both(case)


def test_watch_stream_resume_after_torn_disconnect_no_loss():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d1"))
            srv.state.put("deployments", "ns", _dep("d2"))
            srv.state.add_watch_fault(disconnect=True, after_events=1)
            inf.consume(1.0, stall_margin=0.5)
            assert events == [("add", "d1")]
            inf.consume(1.0, stall_margin=0.5)
            assert events == [("add", "d1"), ("add", "d2")]
            return events, inf.counts

    both(case)


def test_watch_stream_410_gone_relists_and_recovers():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            srv.state.put("deployments", "ns", _dep("d1"))
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d2"))
            srv.state.add_watch_fault(gone=True)
            inf.consume(0.5, stall_margin=0.5)
            assert inf.counts["restart_gone"] == 1
            assert events == [("add", "d1"), ("add", "d2")]
            srv.state.put("deployments", "ns", _dep("d3"))
            inf.consume(0.5, stall_margin=0.5)
            assert ("add", "d3") in events
            return events, inf.counts["restart_gone"]

    both(case)


def test_watch_stream_natural_compaction_answers_410():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            srv.state.watch_cap = 4
            inf = _informer(m, srv, events)
            inf.resync()
            for i in range(12):
                srv.state.put("deployments", "ns", _dep(f"d{i}"))
            inf.consume(0.5, stall_margin=0.5)
            assert inf.counts["restart_gone"] == 1
            adds = sorted(n for e, n in events if e == "add")
            assert adds == sorted(f"d{i}" for i in range(12))
            return adds

    both(case)


def test_watch_stream_gone_with_failed_relist_recovers_next_window():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d1"))
            srv.state.add_watch_fault(gone=True)
            real_list = inf.kube.list_deployments_rv
            failed = []

            def flaky_list(ns=None):
                if not failed:
                    failed.append(1)
                    raise ConnectionError("injected list outage")
                return real_list(ns)

            inf.kube.list_deployments_rv = flaky_list
            inf.consume(0.5, stall_margin=0.5)
            assert inf.counts["restart_gone"] == 1 and events == []
            inf.consume(0.5, stall_margin=0.5)
            assert events == [("add", "d1")]
            return events, inf.counts

    both(case)


def test_watch_stream_midstream_error_event_counts_error_restart():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d1"))
            srv.state.add_watch_fault(error_code=500)
            inf.consume(0.5, stall_margin=0.5)
            assert inf.counts["restart_error"] == 1 and inf.counts["restart_end"] == 0
            inf.consume(0.5, stall_margin=0.5)
            assert events == [("add", "d1")]
            return events, inf.counts

    both(case)


def test_watch_stream_midstream_410_event_relists():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            srv.state.put("deployments", "ns", _dep("d1"))
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d2"))
            srv.state.add_watch_fault(error_code=410)
            inf.consume(0.5, stall_margin=0.5)
            assert inf.counts["restart_gone"] == 1
            assert events == [("add", "d1"), ("add", "d2")]
            return events, inf.counts

    both(case)


def test_watch_stream_stall_detected_and_recovered():
    def case(m):
        events = []
        with FakeKubeServer() as srv:
            inf = _informer(m, srv, events)
            inf.resync()
            srv.state.put("deployments", "ns", _dep("d1"))
            srv.state.add_watch_fault(stall_seconds=5.0, after_events=0)
            t0 = time.monotonic()
            inf.consume(1.0, stall_margin=0.5)
            assert time.monotonic() - t0 < 4.0
            assert inf.counts["restart_stall"] == 1 and events == []
            inf.consume(1.0, stall_margin=0.5)
            assert events == [("add", "d1")]
            return events, inf.counts["restart_stall"]

    both(case)


def test_watch_answered_4xx_never_opens_the_kube_breaker():
    import urllib.error

    def case(m):
        with FakeKubeServer() as srv:
            breaker = m.breaker.CircuitBreaker("kube", failure_threshold=2)
            kube = m.kubeapi.HttpKube(base_url=srv.url, token="t", breaker=breaker)
            for _ in range(4):
                srv.state.add_fault(path="deployments", method="GET", status=403)
                with pytest.raises(urllib.error.HTTPError):
                    list(kube.watch_deployments(resource_version="1", timeout_seconds=1, stall_margin=0.5))
            states = [breaker.state]
        for _ in range(2):
            with pytest.raises(OSError):
                list(kube.watch_deployments(resource_version="1", timeout_seconds=1, stall_margin=0.5))
        states.append(breaker.state)
        assert states == ["closed", "open"]
        return states

    both(case)


def test_watch_plane_selects_streaming_informer():
    def case(m):
        with FakeKubeServer() as srv:
            plane = m.plane.WatchPlane(m.kubeapi.HttpKube(base_url=srv.url, token="t"), stream=True,
                                       registry=CollectorRegistry())
            assert plane.stream and isinstance(plane.informer, m.stream.StreamingInformer)
            state = plane.debug_state()
            assert state["watch_stream"] is True and "stream" in state
        plane = m.plane.WatchPlane(m.kubeapi.InMemoryKube(), stream=True, registry=CollectorRegistry())
        assert not plane.stream
        return state["stream"]

    both(case)


def test_watch_plane_run_stream_dispatches_and_stops(monkeypatch):
    def case(m):
        # a 1 s poll period keeps each stream window at 1 s (10 s deployed)
        monkeypatch.setattr(m.plane, "MONITOR_POLL_SECONDS", 1.0)
        events = []
        with FakeKubeServer() as srv:
            plane = m.plane.WatchPlane(m.kubeapi.HttpKube(base_url=srv.url, token="t"), stream=True,
                                       registry=CollectorRegistry())
            plane.informer.handler = lambda e, d, old: events.append((e, d["metadata"]["name"]))
            rounds = []

            def stop():
                rounds.append(1)
                if len(rounds) == 2:
                    srv.state.put("deployments", "ns", _dep("live"))
                return len(rounds) > 3

            plane.run_stream(stop)
            assert ("add", "live") in events
            return events

    both(case)
