"""The port's chaos plane (`foremast_tpu_torch/chaos/`: `plan.py`,
`collector.py`, the `chaos` section of `Degradation`) and its three wired
edges against the JAX package's, after `tests/test_chaos.py`.

The same plan JSON, seed and call order give both packages the same fault
decisions, call by call; schedule windows, op scoping, latency,
blackhole, status and clock skew answer alike; `chaos_from_env` reads the
same inline and `@file` plans and refuses the same malformed ones. On the
edges the port wires (``store`` through `GuardedSession`, ``prometheus``
through `PrometheusSource`, ``receiver`` through the ingest handler), the
same plan gives both workers the same statuses: a store outage over a
warm tick's writes goes to write-behind and replays exactly once (the
sliced sweep's writer thread included), a seeded Prometheus error rate
releases documents without making them terminal, and the receiver
answers the rule's status.

The JAX cases of the ``transfer`` and ``clock`` edges (planned handoff
and mesh membership, ROADMAP.md Queue 1 item 7) and of ``kube`` (the
watch plane, item 8) have no port counterpart yet: a plan naming them
parses and its rules count nothing."""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_multihost_worker import _serve_fake_es  # noqa: E402

from benchmarks.worker_bench import build_mixed_fleet  # noqa: E402
from foremast_tpu import chaos as J  # noqa: E402
from foremast_tpu.config import BrainConfig as JaxConfig  # noqa: E402
from foremast_tpu.jobs import BrainWorker as JaxWorker  # noqa: E402
from foremast_tpu.jobs.store import ElasticsearchStore as JaxES  # noqa: E402
from foremast_tpu.metrics.source import PrometheusSource as JaxProm  # noqa: E402
from foremast_tpu_torch import chaos as T  # noqa: E402
from foremast_tpu_torch.chaos.degrade import REASON_BUFFERED, REASON_FETCH, REASON_REPLAYED  # noqa: E402
from foremast_tpu_torch.config import BrainConfig  # noqa: E402
from foremast_tpu_torch.ingest import RingStore, start_ingest_server, stop_ingest_server  # noqa: E402
from foremast_tpu_torch.jobs import BrainWorker  # noqa: E402
from foremast_tpu_torch.jobs import models as tm  # noqa: E402
from foremast_tpu_torch.jobs.store import ElasticsearchStore as PortES  # noqa: E402
from foremast_tpu_torch.metrics.source import PrometheusSource as PortProm  # noqa: E402

NOW = 1_760_000_000.0
PACKAGES = {"jax": J, "port": T}


def _decisions(pkg, plan_json: dict, calls) -> tuple[list, dict]:
    """Run `calls` ((edge, op) pairs, in order) through one package's plan
    built from `plan_json`; each call's outcome is None (passed), or the
    fault's (class name, kind, status). Returns (outcomes, injections)."""
    plan = pkg.FaultPlan.from_json(plan_json).activate()
    out = []
    for edge, op in calls:
        fault = plan.edge(edge).perturb(op, raise_faults=False)
        out.append(None if fault is None else (type(fault).__name__, fault.kind, fault.status))
    return out, plan.injections_snapshot()


def _calls(seed: int, n: int, edges) -> list:
    rng = np.random.default_rng(seed)
    ops = ("http://es/documents/_search", "http://es/documents/_bulk", "http://p/api/v1/query_range?q=a",
           "/api/v1/write")
    return [(edges[int(rng.integers(len(edges)))], ops[int(rng.integers(len(ops)))]) for _ in range(n)]


@pytest.mark.parametrize(
    "plan_json",
    [
        {"seed": 7, "rules": [{"edge": "prometheus", "error_rate": 0.5}]},
        {"seed": 8, "rules": [{"edge": "prometheus", "error_rate": 0.5}]},
        {"seed": 3, "rules": [{"edge": "store", "error_rate": 0.3, "kind": "timeout"},
                              {"edge": "store", "op": "_bulk", "error_rate": 0.6, "kind": "status", "status": 502},
                              {"edge": "prometheus", "error_rate": 0.2},
                              {"edge": "receiver", "error_rate": 0.4, "kind": "status", "status": 503}]},
        {"seed": 2**31 - 1, "rules": [{"edge": "receiver", "blackhole": True, "op": "write"},
                                      {"edge": "prometheus", "error_rate": 0.9, "kind": "timeout"}]},
    ],
    ids=["seed7", "seed8", "mixed-kinds", "blackhole-and-big-seed"],
)
def test_same_plan_same_decisions_as_jax(plan_json):
    """Per-edge RNGs seeded from (plan seed, edge name) through zlib: the
    same plan and call order give the JAX package's decisions exactly,
    whatever order the edges are first asked for."""
    calls = _calls(int(plan_json["seed"]) % 1000, 400, ("prometheus", "store", "receiver", "pusher"))
    got, got_inj = _decisions(T, plan_json, calls)
    want, want_inj = _decisions(J, plan_json, calls)
    assert got == want
    assert got_inj == want_inj
    hits = sum(o is not None for o in got)
    assert 0 < hits < len(calls)


def test_different_seeds_diverge_and_replays_repeat():
    plan_json = {"rules": [{"edge": "prometheus", "error_rate": 0.5}]}
    calls = [("prometheus", f"http://p/{i}") for i in range(64)]
    a = _decisions(T, dict(plan_json, seed=7), calls)[0]
    b = _decisions(T, dict(plan_json, seed=7), calls)[0]
    c = _decisions(T, dict(plan_json, seed=8), calls)[0]
    assert a == b and a != c


def _window_case(pkg):
    t = [100.0]
    plan = pkg.FaultPlan(rules=({"edge": "store", "after": 5.0, "duration": 10.0, "error_rate": 1.0},),
                         clock=lambda: t[0]).activate()
    out = [plan.edge("store").perturb("op", raise_faults=False) is not None]
    t[0] = 106.0
    out += [plan.edge("store").perturb("op", raise_faults=False) is not None,
            plan.edge("prometheus").perturb("op", raise_faults=False) is not None]
    t[0] = 116.0
    out.append(plan.edge("store").perturb("op", raise_faults=False) is not None)
    return out, plan.injections_snapshot(), plan.elapsed() == 16.0


def _op_case(pkg):
    plan = pkg.FaultPlan(rules=({"edge": "store", "op": "_bulk", "error_rate": 1.0},)).activate()
    e = plan.edge("store")
    return [e.perturb("http://es/documents/_search", raise_faults=False),
            type(e.perturb("http://es/documents/_bulk", raise_faults=False)).__name__], plan.injections_snapshot()


def _latency_case(pkg):
    plan = pkg.FaultPlan(rules=({"edge": "a", "latency_seconds": 0.02},)).activate()
    t0 = time.perf_counter()
    fault = plan.edge("a").perturb("x")
    return fault, time.perf_counter() - t0 >= 0.02, plan.injections_snapshot()


def _blackhole_case(pkg):
    plan = pkg.FaultPlan(rules=({"edge": "b", "blackhole": True, "status": 504},)).activate()
    try:
        plan.edge("b").perturb("x")
        raised = None
    except TimeoutError as e:  # a blackhole is an injected timeout
        raised = (type(e).__name__, e.kind, e.status, isinstance(e, ConnectionError))
    return raised, plan.injections_snapshot()


def _status_case(pkg):
    plan = pkg.FaultPlan(rules=({"edge": "c", "error_rate": 1.0, "kind": "status", "status": 503},)).activate()
    fault = plan.edge("c").perturb("x", raise_faults=False)
    return fault.status, fault.kind, fault.edge, str(fault), pkg.is_transient_error(fault), plan.injections_snapshot()


def _skew_case(pkg):
    t = [50.0]
    plan = pkg.FaultPlan(rules=({"edge": "clock", "after": 10.0, "skew_seconds": 7.5},),
                         clock=lambda: t[0]).activate()
    clock = plan.edge("clock").clock(base=lambda: 1000.0)
    before = clock()
    t[0] = 65.0
    return before, clock(), plan.edge("other").skew_seconds(), plan.injections_snapshot()


@pytest.mark.parametrize(
    "case", [_window_case, _op_case, _latency_case, _blackhole_case, _status_case, _skew_case],
    ids=["schedule-window", "op-scoping", "latency", "blackhole", "status", "clock-skew"],
)
def test_fault_kinds_answer_as_jax(case):
    got, want = case(T), case(J)
    assert got == want
    assert any(x not in (None, {}, False) for x in (got if isinstance(got, tuple) else (got,)))


def test_rule_and_plan_parsing_as_jax():
    for bad in ({"edge": "x", "kind": "nope"}, {"edge": "x", "bogus": 1}):
        for pkg in PACKAGES.values():
            with pytest.raises(ValueError):
                pkg.FaultRule.from_json(bad)
    obj = {"seed": 5, "rules": [{"edge": "store", "op": "_bulk", "after": 1.5, "duration": 2.0,
                                 "latency_seconds": 0.1, "error_rate": 0.25, "kind": "status", "status": 429}]}
    got, want = T.FaultPlan.from_json(obj), J.FaultPlan.from_json(obj)
    assert [r.__dict__ for r in got.rules] == [r.__dict__ for r in want.rules]
    assert got.seed == want.seed == 5
    assert got.elapsed() == want.elapsed() == -1.0  # not yet activated: nothing fires
    assert got.debug_state() == want.debug_state()


def test_chaos_from_env_inline_file_and_unset(tmp_path, monkeypatch):
    from foremast_tpu.chaos import plan as jplan
    from foremast_tpu_torch.chaos import plan as tplan

    monkeypatch.delenv("FOREMAST_CHAOS_PLAN", raising=False)
    assert tplan.chaos_from_env() is None and jplan.chaos_from_env() is None
    inline = '{"seed": 3, "rules": [{"edge": "store", "error_rate": 1.0}]}'
    p = tmp_path / "plan.json"
    p.write_text('{"rules": [{"edge": "kube"}, {"edge": "receiver", "status": 429, "kind": "status"}]}')
    for raw in (inline, f"@{p}"):
        got = tplan.chaos_from_env({"FOREMAST_CHAOS_PLAN": raw})
        want = jplan.chaos_from_env({"FOREMAST_CHAOS_PLAN": raw})
        assert (got.seed, [r.__dict__ for r in got.rules]) == (want.seed, [r.__dict__ for r in want.rules])
        assert got.elapsed() >= 0.0  # chaos_from_env activates the plan
    monkeypatch.setenv("FOREMAST_CHAOS_PLAN", inline)
    assert tplan.chaos_from_env().rules[0].error_rate == 1.0
    for raw in ('{"rules": [{"bad": 1}]}', "{not json", f"@{tmp_path / 'missing.json'}"):
        for mod in (tplan, jplan):
            with pytest.raises((ValueError, TypeError, OSError)):
                mod.chaos_from_env({"FOREMAST_CHAOS_PLAN": raw})


@pytest.mark.parametrize("edge,item", [("transfer", "item 7"), ("clock", "item 7"), ("kube", "item 8")],
                         ids=["transfer-item7", "clock-item7", "kube-item8"])
def test_unwired_edges_parse_and_count_nothing(edge, item):
    """The port wires no client to these edges yet (`item`): a plan that
    names them parses, and a worker tick under it injects nothing."""
    plan = T.FaultPlan.from_json({"seed": 1, "rules": [{"edge": edge, "error_rate": 1.0}]}).activate()
    store, source, _ = build_mixed_fleet(2, 128, 30, NOW, seed=0)
    from tests.torch_workers import PortArraySource, port_store

    w = BrainWorker(port_store(store), PortArraySource(source.data), config=BrainConfig(), device="cpu",
                    claim_limit=4, degrade=T.Degradation(chaos_plan=plan))
    assert w.tick(now=NOW + 150) == 2
    assert plan.injections_snapshot() == {}
    assert w.debug_state()["degradation"]["chaos"]["rules"] == 1
    w.close()


def test_degradation_debug_state_chaos_section():
    for pkg in PACKAGES.values():
        assert pkg.Degradation().debug_state()["chaos"] is None  # production shape
    plans = {name: pkg.FaultPlan(rules=({"edge": "x", "error_rate": 1.0},), seed=4).activate()
             for name, pkg in PACKAGES.items()}
    states = {}
    for name, pkg in PACKAGES.items():
        with pytest.raises(pkg.InjectedFault):
            plans[name].edge("x").perturb("op")
        d = pkg.Degradation.from_env(env={}, chaos_plan=plans[name])
        assert d.chaos_plan is plans[name]
        state = d.debug_state()["chaos"]
        state.pop("elapsed_seconds")
        states[name] = state
    assert states["port"] == states["jax"] == {"seed": 4, "rules": 1, "injections": {"x/connection": 1}}


def _collected(pkg, registry_cls):
    from foremast_tpu.observe.metrics_lint import lint_registry

    plan = pkg.FaultPlan(rules=({"edge": "x", "error_rate": 1.0},)).activate()
    with pytest.raises(pkg.InjectedFault):
        plan.edge("x").perturb("op")
    degrade = pkg.Degradation(chaos_plan=plan)
    br = degrade.breakers.get("x")
    br.allow()
    br.record_failure()
    degrade.stats.count_docs("deadline_released")
    degrade.stats.count_event("receiver", "shed")
    registry = registry_cls()
    registry.register(pkg.ChaosCollector(degrade))
    assert lint_registry(registry) == []
    return sorted((m.name, m.type, tuple((s.name, tuple(sorted(s.labels.items())), s.value) for s in m.samples))
                  for m in registry.collect())


def test_chaos_collector_families_lint_clean_and_equal_jax():
    from prometheus_client import CollectorRegistry

    got, want = _collected(T, CollectorRegistry), _collected(J, CollectorRegistry)
    assert got == want
    assert {name for name, _, _ in got} == {
        "foremast_chaos_injections",
        "foremast_breaker_state",
        "foremast_breaker_transitions",
        "foremast_breaker_short_circuits",
        "foremast_degraded_docs",
        "foremast_degraded_events",
    }


class _Resp:
    def __init__(self, status=200):
        self.status_code = status

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"http {self.status_code}")

    def json(self):
        return {"status": "success", "data": {"result": [{"values": [[100, "1.0"]]}]}}


class _OkSession:
    def __init__(self):
        self.calls = 0

    def get(self, url, timeout=None):
        self.calls += 1
        return _Resp(200)


@pytest.mark.parametrize("cls,pkg", [(PortProm, T), (JaxProm, J)], ids=["port", "jax"])
def test_prometheus_source_injection_exhausts_retries_and_guard_opens(cls, pkg):
    plan = pkg.FaultPlan(rules=({"edge": "prometheus", "error_rate": 1.0},)).activate()
    sess = _OkSession()
    src = cls(session=sess, retries=2, backoff_seconds=0.001, chaos=plan.edge("prometheus"))
    with pytest.raises(pkg.InjectedFault):
        src.fetch("http://p/q")
    assert sess.calls == 0  # faults injected BEFORE the wire
    assert plan.injections_snapshot()[("prometheus", "connection")] == 3
    store_plan = pkg.FaultPlan(rules=({"edge": "store", "error_rate": 1.0},)).activate()
    br = pkg.CircuitBreaker("store", failure_threshold=2, open_seconds=60.0)
    gs = pkg.GuardedSession(sess, chaos=store_plan.edge("store"), breaker=br)
    for _ in range(2):
        with pytest.raises(pkg.InjectedFault):
            gs.post("http://es/_bulk")
    with pytest.raises(pkg.BreakerOpen):
        gs.post("http://es/_bulk")
    assert sess.calls == 0 and br.state == "open"


# ---------------------------------------------------------------------------
# the wired edges on a worker: store outage, Prometheus faults, receiver
# ---------------------------------------------------------------------------


class _PromSession:
    """A `query_range` endpoint over a fleet's URL -> (times, values) map,
    answering what Prometheus answers (one result series)."""

    def __init__(self, data):
        self.data = data
        self.calls = 0

    def get(self, url, timeout=None):
        self.calls += 1
        t, v = self.data[url]
        body = {"status": "success",
                "data": {"result": [{"values": [[int(a), repr(float(b))] for a, b in zip(t, v)]}]}}
        resp = _Resp(200)
        resp.json = lambda: body
        return resp


def _es_worker(pkg_name: str, services: int, plan_json: dict, clock, slice_docs: int = 0):
    """A worker of one package over ElasticsearchStore (chaos on its store
    edge, its breaker from the degradation bundle) against a fake index on
    a loopback socket, and a PrometheusSource (chaos on its edge) over the
    fleet's series. Returns (worker, store, server, plan, degrade, writes)
    where `writes` records (doc id, status) per write that landed."""
    pkg = PACKAGES[pkg_name]
    store0, source0, _ = build_mixed_fleet(services, 256, 30, NOW, seed=0)
    srv, _fake = _serve_fake_es()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    plan = pkg.FaultPlan.from_json(plan_json, clock=clock).activate()
    degrade = pkg.Degradation(chaos_plan=plan)
    es_cls, prom_cls, cfg_cls, worker_cls = (
        (PortES, PortProm, BrainConfig, BrainWorker) if pkg_name == "port" else (JaxES, JaxProm, JaxConfig, JaxWorker)
    )
    store = es_cls(url, chaos=plan.edge("store"), breaker=degrade.breakers.get("store"))
    assert store.wait_ready(max_wait=10)
    for doc in store0._docs.values():
        store.create(type(doc).from_json(doc.to_json()) if pkg_name == "jax" else tm.Document.from_json(doc.to_json()))
    src = prom_cls(session=_PromSession(source0.data), retries=0, backoff_seconds=0.001,
                   chaos=plan.edge("prometheus"), breaker=degrade.breakers.get("prometheus"))
    src.concurrent_fetch = False  # one call order: the serial path
    kw = dict(config=cfg_cls(algorithm="moving_average_all", season_steps=24, max_cache_size=4 * services + 64),
              claim_limit=2 * services, worker_id=f"chaos-{pkg_name}", degrade=degrade)
    if pkg_name == "port":
        kw["device"] = "cpu"
    else:
        kw["device_mesh"] = None
    worker = worker_cls(store, src, **kw)
    worker.sweep_slice_docs = slice_docs
    writes: list = []
    orig = store.update_many

    def recorded(docs):
        orig(docs)
        writes.extend((d.id, d.status) for d in docs)

    store.update_many = recorded
    return worker, store, srv, plan, degrade, writes


@pytest.mark.parametrize("slice_docs", [0, 2], ids=["monolithic", "sliced-writer-thread"])
def test_store_outage_mid_warm_tick_replays_exactly_once(slice_docs):
    """A `store` rule with error_rate 1.0 over one warm tick's write window
    (the plan clock enters it right after that tick's claim): every write
    of the tick fails through `GuardedSession`, the breaker records the
    failures, the verdicts go to write-behind, and the next tick replays
    each exactly once before writing its own. Sliced (2 docs a slice), the
    failing writes are the writer thread's. Both packages, one plan."""
    services = 4
    plan_json = {"seed": 11, "rules": [{"edge": "store", "after": 100.0, "duration": 50.0, "error_rate": 1.0}]}
    out = {}
    for name in ("jax", "port"):
        t = [0.0]
        worker, store, srv, plan, degrade, writes = _es_worker(name, services, plan_json, lambda t=t: t[0],
                                                               slice_docs)
        try:
            assert worker.tick(now=NOW + 150) == services  # cold: fits, all re-check docs
            first = list(writes)
            writes.clear()
            orig_claim = store.claim

            def claim_then_outage(*a, _orig=orig_claim, **kw):
                docs = _orig(*a, **kw)
                t[0] = 120.0  # inside the rule's window: the writes fail
                return docs

            store.claim = claim_then_outage
            assert worker.tick(now=NOW + 210) == services
            store.claim = orig_claim
            outage_writes = list(writes)
            buffered = degrade.stats.docs_snapshot().get(REASON_BUFFERED, 0)
            behind = len(degrade.write_behind)
            breaker = degrade.breakers.get("store").debug_state()
            injected = plan.injections_snapshot()
            t[0] = 200.0  # past the window: the store heals
            writes.clear()
            assert worker.tick(now=NOW + 270) == services
            per_doc: dict = {}
            for doc_id, status in writes:
                per_doc.setdefault(doc_id, []).append(status)
            out[name] = dict(first=sorted(first), outage_writes=outage_writes, buffered=buffered, behind=behind,
                             failures=breaker["consecutive_failures"],
                             injected=injected, replayed=degrade.stats.docs_snapshot().get(REASON_REPLAYED, 0),
                             left=len(degrade.write_behind), per_doc=per_doc,
                             statuses=sorted((d.id, d.status) for d in store.list_open()))
        finally:
            worker.close()
            srv.shutdown()
            srv.server_close()
    port, jax = out["port"], out["jax"]
    assert port == jax
    assert port["outage_writes"] == []  # nothing reached the store...
    assert port["buffered"] == port["behind"] == services  # ...everything buffered
    assert port["injected"].get(("store", "connection"), 0) >= 1  # the writes met the rule
    assert port["replayed"] == services and port["left"] == 0
    assert len(port["per_doc"]) == services
    assert all(v == [tm.STATUS_PREPROCESS_COMPLETED] * 2 for v in port["per_doc"].values()), port["per_doc"]


def test_store_breaker_sees_the_writer_threads_failures():
    """The sliced sweep's writer thread writes through the same guarded
    session: with the outage spanning the whole sweep, the store breaker
    counts the writer's failures and opens; after the cooldown and the
    window the next sweep's probe closes it and the backlog replays once."""
    t = [0.0]
    plan_json = {"rules": [{"edge": "store", "op": "_bulk", "after": 100.0, "duration": 50.0, "error_rate": 1.0}]}
    worker, store, srv, plan, degrade, writes = _es_worker("port", 6, plan_json, lambda: t[0], slice_docs=1)
    br = T.CircuitBreaker("store", failure_threshold=2, open_seconds=0.2)
    store._s.breaker = br
    try:
        assert worker.tick(now=NOW + 150) == 6
        orig_claim = store.claim

        def claim_then_outage(*a, **kw):
            docs = orig_claim(*a, **kw)
            t[0] = 120.0
            return docs

        store.claim = claim_then_outage
        worker.tick(now=NOW + 210)
        store.claim = orig_claim
        snap = br.debug_state()
        assert snap["state"] == "open" and snap["transitions"].get("open", 0) >= 1
        assert len(degrade.write_behind) == 6
        t[0] = 200.0
        time.sleep(0.25)  # the breaker's cooldown
        writes.clear()
        assert worker.tick(now=NOW + 270) == 6
        assert br.state == "closed"
        per_doc: dict = {}
        for doc_id, status in writes:
            per_doc.setdefault(doc_id, []).append(status)
        assert len(per_doc) == 6 and all(len(v) == 2 for v in per_doc.values()), per_doc
        assert len(degrade.write_behind) == 0
    finally:
        worker.close()
        srv.shutdown()
        srv.server_close()


def test_prometheus_error_rate_releases_docs_then_later_ticks_judge_all():
    """A seeded 0.3 error rate on the ``prometheus`` edge: fetches that
    meet a fault release their documents un-judged (never terminal), the
    same documents in both packages on the serial path, with the same
    injection counts; later ticks without the rule judge every document
    to the same statuses."""
    services = 6
    plan_json = {"seed": 21, "rules": [{"edge": "prometheus", "duration": 100.0, "error_rate": 0.3}]}
    out = {}
    for name in ("jax", "port"):
        t = [0.0]
        worker, store, srv, plan, degrade, _ = _es_worker(name, services, plan_json, lambda t=t: t[0])
        try:
            worker.tick(now=NOW + 150)
            first = sorted((d.id, d.status) for d in store.list_open())
            released = degrade.stats.docs_snapshot().get(REASON_FETCH, 0)
            injected = plan.injections_snapshot()
            t[0] = 150.0  # the rule's window is over
            for k in range(3):
                worker.tick(now=NOW + 210 + 60 * k)
            out[name] = dict(first=first, released=released, injected=injected,
                             statuses=sorted((d.id, d.status) for d in store.list_open()),
                             claims=degrade.stats.events_snapshot())
        finally:
            worker.close()
            srv.shutdown()
            srv.server_close()
    assert out["port"] == out["jax"]
    assert out["port"]["released"] > 0
    assert out["port"]["injected"][("prometheus", "connection")] >= out["port"]["released"]
    assert {s for _, s in out["port"]["first"]} == {tm.STATUS_PREPROCESS_COMPLETED}
    assert len(out["port"]["statuses"]) == services
    assert {s for _, s in out["port"]["statuses"]} == {tm.STATUS_PREPROCESS_COMPLETED}


# ---------------------------------------------------------------------------
# the receiver edge
# ---------------------------------------------------------------------------


def _push(addr, payload=b'{"timeseries": []}'):
    req = urllib.request.Request(f"http://{addr}/api/v1/write", data=payload, method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=10)


@pytest.mark.parametrize("status", [503, 429])
def test_receiver_chaos_fault_answers_status(status):
    from foremast_tpu.ingest import RingStore as JaxRing
    from foremast_tpu.ingest import start_ingest_server as jax_start
    from foremast_tpu.ingest import stop_ingest_server as jax_stop

    got = {}
    for name, (pkg, ring, start, stop) in {"port": (T, RingStore, start_ingest_server, stop_ingest_server),
                                           "jax": (J, JaxRing, jax_start, jax_stop)}.items():
        plan = pkg.FaultPlan(rules=({"edge": "receiver", "error_rate": 1.0, "kind": "status", "status": status},),
                             seed=2).activate()
        srv, _ = start(0, ring(budget_bytes=1 << 20, shards=1), host="127.0.0.1", chaos=plan.edge("receiver"))
        addr = "127.0.0.1:%d" % srv.server_address[1]
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _push(addr)
            got[name] = (ei.value.code, json.loads(ei.value.read())["reason"], plan.injections_snapshot())
            ei.value.close()
        finally:
            stop(srv)
    assert got["port"] == got["jax"]
    assert got["port"][0] == status  # answered, not a dropped thread
    assert got["port"][2] == {("receiver", "status"): 1}


def test_receiver_chaos_latency_sheds_past_the_inflight_cap():
    """A slow handler (the receiver edge's latency) and max_inflight=1:
    a concurrent push is shed with 429 + Retry-After, counted."""
    plan = T.FaultPlan(rules=({"edge": "receiver", "latency_seconds": 0.4},)).activate()
    stats = T.DegradeStats()
    srv, _ = start_ingest_server(0, RingStore(budget_bytes=1 << 20, shards=1), host="127.0.0.1", max_inflight=1,
                                 chaos=plan.edge("receiver"), degrade_stats=stats)
    addr = "127.0.0.1:%d" % srv.server_address[1]
    try:
        results = {}
        entered = threading.Event()
        orig = plan.edge("receiver").perturb

        def perturb(op="", raise_faults=True):
            entered.set()
            return orig(op, raise_faults)

        plan.edge("receiver").perturb = perturb
        t = threading.Thread(target=lambda: results.setdefault("slow", _push(addr).status))
        t.start()
        assert entered.wait(10)  # the slow handler is inside its latency
        with pytest.raises(urllib.error.HTTPError) as ei:
            _push(addr)
        assert ei.value.code == 429 and ei.value.headers["Retry-After"] == "1"
        ei.value.close()
        t.join(timeout=30)
        assert results["slow"] == 200
        assert stats.events_snapshot()[("receiver", "shed")] >= 1
        assert plan.injections_snapshot()[("receiver", "latency")] == 1
    finally:
        stop_ingest_server(srv)
