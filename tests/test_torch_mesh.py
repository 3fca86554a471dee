"""The port's worker mesh (`foremast_tpu_torch/mesh/`, the receiver's
`router=` / `handoff=`, `RingStore.evict_unowned`, `BrainWorker(mesh=)`)
against the JAX package's, after `tests/test_mesh.py`.

Parity cases give both packages the same members, keys, fleets and state,
built from a seed with numpy, and compare what comes out: ring owners,
member-record JSON (both ways), claim partitions, redirect hints, handoff
bodies applied by both packages to the same caches and rings (the joint
caches' LSTM entries included), evictions and autoscale decisions. The
behavioural cases of `tests/test_mesh.py` (leases, pusher retries, torn
and duplicate transfers, the join deadline, restarts, drains) run against
the port with the same assertions, on injected clocks. The port's lock
witness rides the module, as JAX's rides `tests/test_mesh.py`."""

from __future__ import annotations

import io
import json
import pickle
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from foremast_tpu import mesh as J  # noqa: E402
from foremast_tpu_torch import mesh as P  # noqa: E402
from foremast_tpu_torch.ingest import RingStore, start_ingest_server  # noqa: E402
from foremast_tpu_torch.ingest.receiver import TRANSFER_PATH  # noqa: E402
from foremast_tpu_torch.ingest.snapshot import append_record  # noqa: E402
from foremast_tpu_torch.jobs.models import Document  # noqa: E402
from foremast_tpu_torch.jobs.store import InMemoryStore  # noqa: E402
from foremast_tpu_torch.mesh import (  # noqa: E402
    MESH_APP,
    HashRing,
    Membership,
    MeshNode,
    MeshRouter,
    RoutingPusher,
    doc_route_key,
    live_members,
    series_route_key,
)
from foremast_tpu_torch.mesh.handoff import HANDOFF_VERSION  # noqa: E402
from foremast_tpu_torch.models.cache import ModelCache  # noqa: E402


def _pkg(name: str):
    """(mesh module, ingest module, InMemoryStore, Document, ModelCache,
    RefineBook) of the JAX package ("jax") or the port ("port")."""
    if name == "jax":
        from foremast_tpu import ingest
        from foremast_tpu.jobs.models import Document as Doc
        from foremast_tpu.jobs.refine import RefineBook
        from foremast_tpu.jobs.store import InMemoryStore as Store
        from foremast_tpu.models.cache import ModelCache as Cache

        return J, ingest, Store, Doc, Cache, RefineBook
    from foremast_tpu_torch import ingest
    from foremast_tpu_torch.jobs.refine import RefineBook

    return P, ingest, InMemoryStore, Document, ModelCache, RefineBook


@pytest.fixture(scope="module", autouse=True)
def lock_witness():
    """The port's runtime lock witness rides this whole module, as JAX's
    rides `tests/test_mesh.py`: the handoff cases nest the
    handoff manager's lock under receiver handler threads racing the
    tick-side sender. At teardown every OBSERVED acquisition edge
    between the port's locks must already be in the committed static
    graph (`analysis_lockgraph_torch.json`); a miss means the static
    model has a hole: run `python -m foremast_tpu_torch.analysis
    --write-lockgraph` and review the new edge."""
    from foremast_tpu_torch.analysis import witness

    wit = witness.install()
    yield wit
    graph = witness.load_graph()
    witness.uninstall()
    assert graph is not None, "analysis_lockgraph_torch.json missing from the repo root"
    missing = wit.unobserved_edges(graph)
    assert not missing, f"runtime lock-acquisition edges missing from the static graph: {missing}"


def _clock(box):
    return lambda: box[0]


# ---------------------------------------------------------------------------
# parity: the same inputs through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_owners_match_jax(seed):
    """Placement, replicas and capacity weighting are JAX's, key for key:
    a mixed fleet agrees on every owner."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    members = {f"w-{rng.integers(1 << 30):x}": int(rng.integers(1, 4)) for _ in range(n)}
    replicas = int(rng.choice([1, 16, 64, 100]))
    keys = [f"app{i}" for i in rng.integers(0, 1 << 40, 2000)] + [f'm{{app="x{i}"}}' for i in range(50)]
    got = P.HashRing(members, replicas=replicas)
    want = J.HashRing(members, replicas=replicas)
    assert got.members == want.members and len(got) == len(want)
    assert [got.owner(k) for k in keys] == [want.owner(k) for k in keys]
    plain = list(members)
    assert [P.HashRing(plain).owner(k) for k in keys] == [J.HashRing(plain).owner(k) for k in keys]


@pytest.mark.parametrize("state", ["active", "draining", "joining"])
def test_member_record_json_matches_jax_both_ways(state):
    kw = dict(worker_id="w-7", ingest_address="10.0.0.7:9009", observe_port=8001, capacity=3,
              lease_seconds=12.5, renewed_at=1_760_000_123.25, state=state)
    got, want = P.MemberRecord(**kw), J.MemberRecord(**kw)
    assert got.to_payload() == want.to_payload()
    assert P.MemberRecord.from_payload(want.to_payload()) == got
    assert J.MemberRecord.from_payload(got.to_payload()) == want
    for raw in ('{"workerId": "w", "state": "hibernating"}', '{"workerId": "w"}', "{not json", '{"state": 1}'):
        a, b = P.MemberRecord.from_payload(raw), J.MemberRecord.from_payload(raw)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclass_fields(a) == dataclass_fields(b)


def dataclass_fields(rec) -> dict:
    import dataclasses

    return dataclasses.asdict(rec)


def test_member_documents_match_jax():
    """The stored member documents are the same JSON in both stores, and
    each package lists the other's members."""
    docs = {}
    for name in ("jax", "port"):
        mesh, _, Store, _, _, _ = _pkg(name)
        store = Store()
        t = [1000.0]
        m = mesh.Membership(store, "w-a", lease_seconds=9.0, ingest_address="h:1", observe_port=7, clock=_clock(t))
        m.join()
        t[0] = 1004.0
        m.set_state("draining")
        docs[name] = store.get("mesh::w-a").to_json()
    strip = ("createdAt", "modifiedAt")
    assert {k: v for k, v in docs["port"].items() if k not in strip} == {
        k: v for k, v in docs["jax"].items() if k not in strip
    }
    # each package reads the other's record
    for reader, writer in (("port", "jax"), ("jax", "port")):
        mesh, _, Store, Doc, _, _ = _pkg(reader)
        store = Store()
        store.create(Doc.from_json(docs[writer]))
        (rec,) = mesh.live_members(store, now=1010.0)
        assert (rec.worker_id, rec.state, rec.ingest_address, rec.renewed_at) == ("w-a", "draining", "h:1", 1004.0)


def _seeded_fleet(name: str, n: int, seed: int):
    mesh, _, Store, Doc, _, _ = _pkg(name)
    rng = np.random.default_rng(seed)
    store = Store()
    apps = [f"svc{x}" for x in rng.integers(0, 1 << 30, n)]
    for i, app in enumerate(apps):
        store.create(Doc(id=f"j{i}", app_name=app, current_config="m== http://x", strategy="continuous"))
    return mesh, store


@pytest.mark.parametrize("members", [("w-a", "w-b"), ("w-a", "w-b", "w-c", "w-d")])
def test_claim_partitions_match_jax(members):
    """N members claiming one store take disjoint partitions whose union is
    the fleet, and each member's partition is the JAX member's."""
    parts = {}
    for name in ("jax", "port"):
        mesh, store = _seeded_fleet(name, 300, seed=5)
        t = [0.0]
        nodes = []
        for wid in members:
            mem = mesh.Membership(store, wid, lease_seconds=30.0, clock=_clock(t))
            node = mesh.MeshNode(mem, mesh.MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t)), clock=_clock(t))
            node.start()
            nodes.append(node)
        for node in nodes:
            node.router.refresh(force=True)
        parts[name] = {
            node.worker_id: sorted(d.id for d in store.claim(node.worker_id, 90.0, limit=1000,
                                                               claim_filter=node.claim_filter))
            for node in nodes
        }
        ids = [i for p in parts[name].values() for i in p]
        assert len(ids) == len(set(ids)) == 300
    assert parts["port"] == parts["jax"]


def _hint_pair(name: str):
    mesh, ingest, Store, _, _, _ = _pkg(name)
    store = Store()
    t = [0.0]
    routers = {}
    for wid, addr in (("w-a", "10.0.0.1:7001"), ("w-b", "10.0.0.2:7002"), ("w-c", "10.0.0.3:7003")):
        mem = mesh.Membership(store, wid, lease_seconds=30.0, clock=_clock(t), ingest_address=addr)
        mem.join()
        routers[wid] = mesh.MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t))
    for r in routers.values():
        r.refresh(force=True)
    return ingest, routers["w-a"]


def test_redirect_hints_match_jax():
    """The same pushes to a receiver with a router: the same samples are
    accepted, and the `redirects` maps are JAX's, key for key."""
    rng = np.random.default_rng(3)
    entries = [
        {"alias": f'lat{{app="app{int(a)}",ns="n{int(a) % 3}"}}', "times": [60, 120], "values": [1.0, float(v)]}
        for a, v in zip(rng.integers(0, 500, 120), rng.normal(size=120))
    ] + [{"alias": 'opaque{ns="x"}', "times": [60], "values": [2.0]}]
    body = json.dumps({"timeseries": entries}).encode()
    outs, counters = {}, {}
    for name in ("jax", "port"):
        ingest, router = _hint_pair(name)
        srv, _ = ingest.start_ingest_server(0, ingest.RingStore(shards=2), host="127.0.0.1", router=router)
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write", data=body,
                                         method="POST")
            outs[name] = json.loads(urllib.request.urlopen(req, timeout=10).read())
        finally:
            srv.shutdown()
            srv.server_close()
        counters[name] = dict(router.counters)
    assert outs["port"] == outs["jax"]
    assert outs["port"]["redirects"] and counters["port"] == counters["jax"]


def test_series_route_keys_match_jax():
    keys = ['errors{app="checkout",ns="prod"}', 'errors{ns="prod", app="checkout"}', 'errors{ns="prod"}',
            'm{myapp="x"}', 'm{app="a\\"b"}', "rate(x[5m])", 'up{service="s",app=""}']
    for label in ("app", "service"):
        assert [series_route_key(k, label) for k in keys] == [J.series_route_key(k, label) for k in keys]
    assert doc_route_key(Document(id="j", app_name="")) == J.doc_route_key(Document(id="j", app_name="")) == "j"


def _ring_contents(ring) -> dict:
    out = {}
    for i in range(ring.shard_count):
        for key, t, v, cf, ct, older in ring.shard_state(i):
            out[key] = (t.tolist(), v.tolist(), cf, ct, [list(iv) for iv in older])
    return out


def _evict_case(name: str, tenanted: bool):
    mesh, ingest, Store, _, _, _ = _pkg(name)
    reg = None
    if tenanted:
        if name == "jax":
            from foremast_tpu.tenant.registry import tenancy_from_env
        else:
            from foremast_tpu_torch.tenant.registry import tenancy_from_env
        reg = tenancy_from_env({"FOREMAST_TENANTS": json.dumps({"a": {"ring_bytes": 1 << 20}, "b": {}})})
    ring = ingest.RingStore(budget_bytes=1 << 22, shards=3, tenancy=reg)
    rng = np.random.default_rng(9)
    for i in range(60):
        n = int(rng.integers(4, 40))
        ts = 60 * np.arange(n, dtype=np.int64) + 6000
        ring.push(f'm{{app="app{i}",tenant="{"ab"[i % 2]}"}}', ts, rng.normal(size=n).astype(np.float32),
                  start=5400.0, record_lag=False)
    store = Store()
    t = [0.0]
    routers = []
    for wid in ("w-a", "w-b", "w-c"):
        mem = mesh.Membership(store, wid, lease_seconds=30.0, clock=_clock(t))
        mem.join()
        routers.append(mesh.MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t)))
    routers[0].refresh(force=True)
    before = ring.tenancy.accounting.snapshot() if reg is not None else None
    dropped = ring.evict_unowned(routers[0].owns_series)
    acct = (before, ring.tenancy.accounting.snapshot()) if reg is not None else None
    return dropped, _ring_contents(ring), ring.stats(), acct


@pytest.mark.parametrize("tenanted", [False, True], ids=["untenanted", "tenanted"])
def test_evictions_match_jax(tenanted):
    """`evict_unowned` drops the series another member owns, the same ones
    as JAX's; under tenancy residency moves and no tenant is charged."""
    got = _evict_case("port", tenanted)
    want = _evict_case("jax", tenanted)
    assert got[0] == want[0] > 0
    assert got[1] == want[1]
    assert {k: got[2][k] for k in ("series", "bytes", "evictions")} == {
        k: want[2][k] for k in ("series", "bytes", "evictions")
    }
    if tenanted:
        (g0, g1), (w0, w1) = got[3], want[3]
        assert g1 == w1 and g0 == w0
        assert {t: v["evictions"] for t, v in g1.items()} == {t: v["evictions"] for t, v in g0.items()}
        assert sum(v["ring_bytes"] for v in g1.values()) == got[2]["bytes"] < sum(
            v["ring_bytes"] for v in g0.values())


def test_autoscale_decisions_match_jax():
    rng = np.random.default_rng(11)
    cfg = dict(breach_ticks=3, cooldown_seconds=30.0, min_workers=1, max_workers=6)
    t = [0.0]
    got = P.AutoscaleDriver(P.AutoscaleConfig(**cfg), clock=_clock(t))
    want = J.AutoscaleDriver(J.AutoscaleConfig(**cfg), clock=_clock(t))
    members = 3
    decisions = []
    for i in range(400):
        t[0] += float(rng.uniform(1, 8))
        busy = (i // 25) % 2 == 0  # alternating busy and quiet spells, noisy inside
        occ = float(rng.uniform(0.6, 1.0) if busy else rng.uniform(0.0, 0.4))
        wq = int(rng.integers(0, 12) if busy else rng.integers(0, 8))
        rp = float(rng.uniform(0.5, 1.0) if busy else rng.uniform(0.0, 0.9))
        a = got.observe(occ, members, write_queue_peak=wq, ring_pressure=rp)
        b = want.observe(occ, members, write_queue_peak=wq, ring_pressure=rp)
        assert a == b
        decisions.append(a)
        members += {"scale_up": 1, "scale_down": -1}.get(a, 0)
    assert {"scale_up", "scale_down"} <= set(decisions)
    assert got.debug_state() == want.debug_state()
    env = {"FOREMAST_AUTOSCALE_BREACH_TICKS": "5", "FOREMAST_AUTOSCALE_HIGH_OCCUPANCY": "0.7"}
    assert P.AutoscaleConfig.from_env(env).__dict__ == J.AutoscaleConfig.from_env(env).__dict__


# -- handoff bodies across the two packages -----------------------------------

APPS = [f"app{i}" for i in range(24)]


def _lstm_entry(name: str, rng, f: int = 4, h: int = 32):
    """One joint LSTM cache entry in the package's own layout: the JAX
    worker caches jax arrays in its AEParams, the port numpy."""
    if name == "jax":
        import jax.numpy as jnp

        from foremast_tpu.models.lstm_ae import AEParams, LSTMParams

        arr = jnp.asarray
    else:
        from foremast_tpu_torch.models.lstm_ae import AEParams, LSTMParams

        arr = np.asarray

    def cell(fi):
        return LSTMParams(arr(rng.normal(size=(fi, 4 * h)).astype(np.float32)),
                          arr(rng.normal(size=(h, 4 * h)).astype(np.float32)),
                          arr(rng.normal(size=(4 * h,)).astype(np.float32)))

    params = AEParams(cell(f), cell(f), arr(rng.normal(size=(h, f)).astype(np.float32)),
                      arr(rng.normal(size=(f,)).astype(np.float32)))
    mvn = (rng.normal(size=f).astype(np.float32), rng.normal(size=f).astype(np.float32),
           rng.normal(size=(f, 24)).astype(np.float32), np.arange(f, dtype=np.int32),
           rng.normal(size=f).astype(np.float32), np.eye(f, dtype=np.float32), True, 1_760_000_000, 10080)
    return (params, float(rng.normal()), float(abs(rng.normal())), mvn)


def _sender_state(name: str):
    """A sender seat of package `name`: ring series and every cache kind
    the worker registers, for 24 apps, built from one seed."""
    mesh, ingest, _, _, Cache, Book = _pkg(name)
    rng = np.random.default_rng(17)
    ring = ingest.RingStore(budget_bytes=1 << 24, shards=2)
    caches = {"fits": Cache(256), "gaps": Cache(256), "refine": Book(), "joint": Cache(256), "jmeta": Cache(256)}
    for app in APPS:
        n = int(rng.integers(16, 64))
        ts = 6000 + 60 * np.arange(n, dtype=np.int64)
        key = f'lat{{app="{app}",ns="prod"}}'
        ring.push(key, (), (), start=3000.0, end=4000.0, record_lag=False)  # an older span
        ring.push(key, ts, rng.normal(size=n).astype(np.float32), start=5400.0, record_lag=False)
        fk = f"{app}|latency|http://p/q?{app}"
        caches["fits"].put(("moving_average_all", 1440, fk),
                           (float(rng.normal()), 0.0, rng.normal(size=24).astype(np.float32), 3, 0.5, n))
        caches["gaps"].put(fk, (int(ts[-1]), 60.0))
        caches["refine"].note_uni(("moving_average_all", 1440, fk), fk, f"http://p/q?{app}", n)
        caches["joint"].put(("lstm", app, ("a", "b", "c", "d"), 2, 30, 1440), _lstm_entry(name, rng))
        caches["joint"].put(("bivariate", app, ("a", "b"), 2, 30, 1440),
                            (rng.normal(size=2).astype(np.float32), np.eye(2, dtype=np.float32)))
        caches["jmeta"].put(("jmeta", "lstm", app, ("a", "b", "c", "d"), ("h",)),
                            (30, rng.normal(size=4).astype(np.float32), np.ones(4, np.float32), 60.0, 1, n))
    return mesh, ring, caches


def _bodies(name: str) -> tuple[list[bytes], dict]:
    """Every transfer body package `name`'s sender streams to a joiner
    (captured at the POST), and the sender's counters."""
    mesh, ring, caches = _sender_state(name)
    _, _, Store, _, _, _ = _pkg(name)
    store = Store()
    t = [0.0]
    routers = {}
    for wid, state in (("w-s", "active"), ("w-j", "joining")):
        mem = mesh.Membership(store, wid, lease_seconds=30.0, clock=_clock(t), state=state, ingest_address=f"{wid}:1")
        mem.join()
        routers[wid] = mesh.MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t))
    routers["w-s"].refresh(force=True)
    h = mesh.HandoffManager(ring_store=ring, batch_bytes=64 << 10, sleep=lambda s: None)
    h.register_caches(caches)
    bodies = []
    h._post = lambda address, body: bodies.append(body)
    assert h.send_all([routers["w-s"].member("w-j")], routers["w-s"], "w-s") == {"w-j": True}
    return bodies, h.counters_snapshot()


def _receiver(name: str):
    mesh, ingest, _, _, Cache, Book = _pkg(name)
    ring = ingest.RingStore(budget_bytes=1 << 24, shards=3)
    caches = {"fits": Cache(256), "gaps": Cache(256), "refine": Book(), "joint": Cache(256), "jmeta": Cache(256)}
    h = mesh.HandoffManager(ring_store=ring, deadline_seconds=10.0)
    h.register_caches(caches)
    return h, ring, caches


def _plain(v):
    """A cache value with every parameter tree as a dict and every array as
    numpy: the layout-free form two packages' entries compare in."""
    if hasattr(v, "_fields") and isinstance(v, tuple):
        return {f: _plain(x) for f, x in zip(v._fields, v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    if hasattr(v, "__array__") and not isinstance(v, (bool, int, float)):
        return np.asarray(v)
    return v


def _same_tree(a, b) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _cache_contents(caches) -> dict:
    return {name: {k: _plain(v) for k, v in c.persistable_snapshot().items()} for name, c in caches.items()}


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_handoff_bodies_apply_alike_in_both_packages(sender):
    """A transfer streamed by either package, applied by the port's and by
    the JAX package's handoff plane, leaves the same rings and the same
    caches, LSTM entries included (the port carries JAX's arrays as numpy,
    its parameter trees as its own; JAX takes the port's dict layout)."""
    bodies, sent = _bodies(sender)
    assert sent["send"]["ok"] == 1 and sent["series_sent"] > 0 and sent["fits_sent"] > 0 and len(bodies) > 1
    got = {}
    for receiver in ("jax", "port"):
        h, ring, caches = _receiver(receiver)
        for body in bodies:
            code, out = h.apply_transfer(body)
            assert code == 200 and not out["torn"]
        c = h.counters_snapshot()
        assert (c["series_received"], c["fits_received"]) == (sent["series_sent"], sent["fits_sent"])
        assert h.debug_state()["done_from"] == ["w-s"]
        got[receiver] = (_ring_contents(ring), _cache_contents(caches))
    assert got["port"][0] == got["jax"][0]
    _same_tree(got["port"][1], got["jax"][1])
    moved_joint = [k for k in got["port"][1]["joint"] if k[0] == "lstm"]
    assert moved_joint and {"fits", "gaps", "refine", "joint", "jmeta"} == {
        n for n, c in got["port"][1].items() if c
    }
    # the sender's own state, as it held it, is what arrived
    _, ring, caches = _sender_state(sender)
    want = _ring_contents(ring)
    for key, val in got["port"][0].items():
        assert val == want[key]
    src = _cache_contents(caches)
    for name, entries in got["port"][1].items():
        for k, v in entries.items():
            _same_tree(v, src[name][k])


def test_port_handoff_sends_the_same_records_as_jax():
    """Record for record (kind, target, key), the port's sender streams
    what JAX's streams from the same state."""
    def records(name):
        out = []
        for body in _bodies(name)[0]:
            from foremast_tpu_torch.ingest.snapshot import read_record_stream
            from foremast_tpu_torch.mesh.handoff import _loads

            for payload, reason in read_record_stream(io.BytesIO(body)):
                assert reason is None
                rec = _loads(payload)
                out.append(rec[:3] if rec[0] in ("fit", "hello") else rec[:2] if rec[0] == "series" else rec)
        return out

    assert records("port") == records("jax")


def test_port_sender_pickles_no_tensor():
    """A cache holding tensors (on any device) goes on the wire as numpy."""
    import torch

    from foremast_tpu_torch.mesh.handoff import _wire_value
    from foremast_tpu_torch.models.lstm_ae import AEParams, LSTMParams

    x = torch.arange(6, dtype=torch.float32)
    v = _wire_value((AEParams(LSTMParams(x, x, x), LSTMParams(x, x, x), x, x), 1.0, [x], {"k": x}))
    blob = pickle.dumps(v)
    assert b"torch" not in blob and b"foremast_tpu" not in blob
    assert isinstance(v[0]["enc"]["w_x"], np.ndarray) and v[0]["w_out"].tolist() == x.tolist()


# ---------------------------------------------------------------------------
# partition, membership and routing: the JAX cases against the port
# ---------------------------------------------------------------------------


def test_ring_deterministic_and_total():
    r1 = HashRing(["w0", "w1", "w2"])
    r2 = HashRing(["w2", "w0", "w1"])
    for i in range(500):
        assert r1.owner(f"app{i}") == r2.owner(f"app{i}") in ("w0", "w1", "w2")
    assert HashRing([]).owner("x") is None
    assert HashRing(["solo"]).owner("anything") == "solo"


def test_ring_balance_and_minimal_movement():
    members = [f"w{i}" for i in range(4)]
    ring = HashRing(members, replicas=64)
    keys = [f"app{i}" for i in range(8000)]
    owners = {k: ring.owner(k) for k in keys}
    counts = {m: sum(1 for o in owners.values() if o == m) for m in members}
    assert min(counts.values()) > 0.5 * 2000 and max(counts.values()) < 1.6 * 2000, counts
    healed = HashRing(members[:3], replicas=64)
    for k in keys:
        if owners[k] != "w3":
            assert healed.owner(k) == owners[k]
        else:
            assert healed.owner(k) in ("w0", "w1", "w2")


def test_ring_capacity_weighting():
    ring = HashRing({"big": 4, "small": 1}, replicas=64)
    assert sum(1 for i in range(4000) if ring.owner(f"app{i}") == "big") > 2400


def test_membership_join_renew_expire_leave():
    store = InMemoryStore()
    t = [1000.0]
    a = Membership(store, "w-a", lease_seconds=10.0, clock=_clock(t))
    b = Membership(store, "w-b", lease_seconds=10.0, clock=_clock(t))
    a.join()
    b.join()
    assert [m.worker_id for m in live_members(store, now=t[0])] == ["w-a", "w-b"]
    assert store.claim("claimer", 90.0, limit=10) == []  # member docs are never claimed
    t[0] = 1006.0
    assert a.renew() is True and a.renew() is False
    t[0] = 1011.0
    assert [m.worker_id for m in live_members(store, now=t[0])] == ["w-a"]
    b.renew()
    assert len(live_members(store, now=t[0])) == 2
    a.leave()
    assert [m.worker_id for m in live_members(store, now=t[0])] == ["w-b"]


def test_membership_lease_tolerates_reader_clock_skew():
    from foremast_tpu_torch.mesh.membership import CLOCK_SKEW_TOLERANCE_FRACTION

    assert CLOCK_SKEW_TOLERANCE_FRACTION == J.membership.CLOCK_SKEW_TOLERANCE_FRACTION
    lease = 12.0
    store = InMemoryStore()
    t = [1000.0]
    member = Membership(store, "w-m", lease_seconds=lease, clock=_clock(t))
    member.join()
    for step in range(12):
        t[0] = 1000.0 + (step + 1) * (lease / 3.0)
        member.renew()
        real_now = t[0] + lease / 3.0 - 0.01
        assert [m.worker_id for m in live_members(store, now=real_now + lease / 2.0)] == ["w-m"]
        safe = CLOCK_SKEW_TOLERANCE_FRACTION * lease - 0.05
        assert [m.worker_id for m in live_members(store, now=real_now + safe)] == ["w-m"]
    stale_now = t[0] + lease / 3.0 - 0.01
    assert live_members(store, now=stale_now + CLOCK_SKEW_TOLERANCE_FRACTION * lease + 0.1) == []


def test_membership_slow_reader_only_delays_death_detection():
    store = InMemoryStore()
    Membership(store, "w-dead", lease_seconds=10.0, clock=lambda: 1000.0).join()
    assert live_members(store, now=1011.0) == []
    assert [r.worker_id for r in live_members(store, now=1006.0)] == ["w-dead"]


def test_membership_record_carries_addresses():
    store = InMemoryStore()
    Membership(store, "w-x", lease_seconds=5.0, ingest_address="10.0.0.7:9009", observe_port=8001, capacity=2).join()
    (rec,) = live_members(store)
    assert (rec.ingest_address, rec.observe_port, rec.capacity) == ("10.0.0.7:9009", 8001, 2)


def test_membership_corrupt_record_is_dead_not_fatal():
    store = InMemoryStore()
    Membership(store, "w-ok", lease_seconds=60.0).join()
    store.create(Document(id="mesh::garbage", app_name=MESH_APP, status="mesh_member", current_config="{not json"))
    assert [m.worker_id for m in live_members(store)] == ["w-ok"]


def test_route_keys_colocate_doc_and_series():
    assert doc_route_key(Document(id="j1", app_name="checkout")) == "checkout"
    assert series_route_key('errors{app="checkout",ns="prod"}') == "checkout"
    assert series_route_key('errors{ns="prod", app="checkout"}') == "checkout"
    assert series_route_key('errors{ns="prod"}') == series_route_key('errors{ ns="prod" }')
    assert series_route_key('m{myapp="x"}') == 'm{myapp="x"}'


def _mesh_pair(store):
    t = [0.0]
    nodes = []
    for wid in ("w-a", "w-b"):
        mem = Membership(store, wid, lease_seconds=30.0, clock=_clock(t))
        node = MeshNode(mem, MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t)), clock=_clock(t))
        node.start()
        nodes.append(node)
    for node in nodes:
        node.router.refresh(force=True)
    return nodes, t


def test_router_ownership_is_a_partition():
    (a, b), _ = _mesh_pair(InMemoryStore())
    docs = [Document(id=f"j{i}", app_name=f"app{i}") for i in range(300)]
    owned_a = {d.id for d in docs if a.claim_filter(d)}
    owned_b = {d.id for d in docs if b.claim_filter(d)}
    assert owned_a.isdisjoint(owned_b) and len(owned_a) + len(owned_b) == 300 and owned_a and owned_b
    for d in docs[:50]:
        assert a.router.owns_series(f'latency{{app="{d.app_name}"}}') == (d.id in owned_a)
    assert a.claim_counts == {"owned": len(owned_a), "skipped": 300 - len(owned_a)}


def test_router_sole_member_owns_everything():
    mem = Membership(InMemoryStore(), "only", lease_seconds=30.0)
    router = MeshRouter(mem, refresh_seconds=0.0)
    node = MeshNode(mem, router)
    node.start()
    assert node.claim_filter(Document(id="x", app_name="anything"))
    assert router.redirect_hint('m{app="anything"}') is None


def test_rebalance_on_member_death_moves_only_orphans():
    (a, b), t = _mesh_pair(InMemoryStore())
    docs = [Document(id=f"j{i}", app_name=f"app{i}") for i in range(300)]
    before = {d.id for d in docs if a.router.owns_doc(d)}
    base = a.router.counters["rebalances"]
    t[0] = 31.0
    a.membership.renew(force=True)
    assert a.router.refresh(force=True) is True
    assert a.router.counters["rebalances"] == base + 1
    after = {d.id for d in docs if a.router.owns_doc(d)}
    assert after == {d.id for d in docs} and before <= after


def test_inmemory_claims_partition_the_fleet():
    store = InMemoryStore()
    (a, b), _ = _mesh_pair(store)
    for i in range(60):
        store.create(Document(id=f"j{i}", app_name=f"app{i}", current_config="m== http://x", strategy="continuous"))
    ids_a = {d.id for d in store.claim("w-a", 90.0, limit=100, claim_filter=a.claim_filter)}
    ids_b = {d.id for d in store.claim("w-b", 90.0, limit=100, claim_filter=b.claim_filter)}
    assert ids_a.isdisjoint(ids_b) and len(ids_a) + len(ids_b) == 60
    assert store.claim("w-a", 90.0, limit=100, claim_filter=a.claim_filter) == []


def test_es_store_claim_filter_and_list_app():
    """Through the port's ElasticsearchStore: only owned docs are CASed,
    and `list_app` finds the member records past the fleet's open page."""
    from test_es_store import FakeES

    from foremast_tpu_torch.jobs.store import ElasticsearchStore

    fake = FakeES()
    store = ElasticsearchStore("http://fake:9200", session=fake)
    store.ensure_index()
    for i in range(20):
        store.create(Document(id=f"j{i}", app_name=f"app{i}", current_config="m== http://x", strategy="continuous"))
    (a, b), _ = _mesh_pair(store)
    assert [d.id for d in store.list_app(MESH_APP)] == ["mesh::w-a", "mesh::w-b"]
    ids_a = {d.id for d in store.claim("w-a", 90.0, limit=50, claim_filter=a.claim_filter)}
    assert ids_a and len(ids_a) < 20
    for doc_id, rec in fake.docs.items():
        if doc_id.startswith("j"):
            assert rec["_source"]["status"] == ("preprocess_inprogress" if doc_id in ids_a else "initial")
    got_b = store.claim("w-b", 90.0, limit=50, claim_filter=b.claim_filter)
    assert {d.id for d in got_b} == {f"j{i}" for i in range(20)} - ids_a


# ---------------------------------------------------------------------------
# routed ingest: receiver hints and pusher convergence
# ---------------------------------------------------------------------------


def _serve(ring, **kw):
    srv, _ = start_ingest_server(0, ring, host="127.0.0.1", **kw)
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def _close(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def test_receiver_redirect_hint_accepts_and_points_at_owner():
    (a, b), _ = _mesh_pair(InMemoryStore())
    for node, addr in ((a, "127.0.0.1:7001"), (b, "127.0.0.1:7002")):
        node.membership.ingest_address = addr
        node.membership.renew(force=True)
    a.router.refresh(force=True)
    foreign = next(f"app{i}" for i in range(100) if not a.router.owns_doc(Document(id="x", app_name=f"app{i}")))
    ring = RingStore(shards=1)
    srv, addr = _serve(ring, router=a.router)
    try:
        body = json.dumps({"timeseries": [{"alias": f'm{{app="{foreign}"}}', "times": [60, 120],
                                           "values": [1.0, 2.0]}]}).encode()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(f"http://{addr}/api/v1/write", data=body,
                                                                       method="POST")).read())
        assert out["accepted_samples"] == 2
        assert out["redirects"] == {f'm{{app="{foreign}"}}': "127.0.0.1:7002"}
        assert ring.stats()["series"] == 1 and a.router.counters["redirect_hints"] == 1
    finally:
        _close(srv)


def test_routing_pusher_converges_in_one_cycle():
    (a, b), _ = _mesh_pair(InMemoryStore())
    rings, servers = {}, []
    try:
        for node in (a, b):
            ring = RingStore(shards=1)
            srv, addr = _serve(ring, router=node.router)
            node.membership.ingest_address = addr
            node.membership.renew(force=True)
            rings[node.worker_id] = ring
            servers.append(srv)
        a.router.refresh(force=True)
        b.router.refresh(force=True)
        series = [(f'm{{app="app{i}"}}', [60, 120], np.asarray([1.0, 2.0], np.float32), None) for i in range(40)]
        pusher = RoutingPusher([a.membership.ingest_address])
        assert pusher.push_cycle(series)["redirects"] > 0
        assert pusher.push_cycle(series)["redirects"] == 0
        for key, *_ in series:
            assert rings[a.router.owner_of_series(key)].query(key, 0, 120, now=150.0)[0] == "hit"
    finally:
        _close(*servers)


def test_routing_pusher_retries_through_receiver_restart():
    ring = RingStore(shards=1)
    srv, addr = _serve(ring)
    try:
        slept = []
        pusher = RoutingPusher([addr], retries=3, backoff_seconds=0.1, sleep=slept.append)
        orig, fails = pusher._post, [2]

        def flaky(address, entries):
            if fails[0] > 0:
                fails[0] -= 1
                raise OSError("connection refused (restarting)")
            return orig(address, entries)

        pusher._post = flaky
        out = pusher.push_cycle([('m{app="a"}', [60, 120], [1.0, 2.0], None)])
        assert (out["accepted"], out["errors"], out["buffered"], out["dropped"]) == (2, 0, 0, 0)
        assert pusher.counters["retries"] == 2 and len(slept) == 2
        assert 0.05 <= slept[0] <= 0.15 and 0.1 <= slept[1] <= 0.3
        assert ring.stats()["series"] == 1
    finally:
        _close(srv)


def test_routing_pusher_buffers_and_flushes_across_outage():
    ring = RingStore(shards=1)
    srv, addr = _serve(ring)
    try:
        pusher = RoutingPusher([addr], retries=1, backoff_seconds=0.0, sleep=lambda s: None)
        down, orig = [True], pusher._post

        def gated(address, entries):
            if down[0]:
                raise OSError("connection refused")
            return orig(address, entries)

        pusher._post = gated
        out = pusher.push_cycle([('m{app="a"}', [60], [1.0], None), ('m{app="b"}', [60], [2.0], None)])
        assert out["errors"] == 1 and out["buffered"] == 2 and ring.stats()["series"] == 0
        down[0] = False
        out2 = pusher.push_cycle([('m{app="c"}', [60], [3.0], None)])
        assert (out2["errors"], out2["buffered"], out2["accepted"]) == (0, 0, 3)
        assert pusher.counters["resent_series"] == 2 and ring.stats()["series"] == 3
    finally:
        _close(srv)


def test_routing_pusher_rejected_batch_is_dropped_not_buffered():
    ring = RingStore(shards=1)
    srv, addr = _serve(ring)
    try:
        slept = []
        pusher = RoutingPusher([addr], retries=3, backoff_seconds=0.1, sleep=slept.append)
        out = pusher.push_cycle([('m{app="bad"}', [60, 120], [1.0], None)])  # a real 400 over the wire
        assert (out["errors"], out["rejected"], out["buffered"], pusher.buffered) == (1, 1, 0, 0)
        assert slept == [] and pusher.counters["rejected_series"] == 1
        out2 = pusher.push_cycle([('m{app="ok"}', [60], [1.0], None)])
        assert out2["accepted"] == 1 and out2["errors"] == 0 and ring.stats()["series"] == 1
    finally:
        _close(srv)


def test_routing_pusher_transient_status_retries_like_transport():
    ring = RingStore(shards=1)
    srv, addr = _serve(ring)
    try:
        slept = []
        pusher = RoutingPusher([addr], retries=3, backoff_seconds=0.1, sleep=slept.append)
        orig, fails = pusher._post, [2]

        def proxied(address, entries):
            if fails[0] > 0:
                fails[0] -= 1
                raise urllib.error.HTTPError(f"http://{address}", 503, "pod restarting", None, io.BytesIO(b""))
            return orig(address, entries)

        pusher._post = proxied
        out = pusher.push_cycle([('m{app="a"}', [60], [1.0], None)])
        assert (out["accepted"], out["errors"], out["rejected"], out["buffered"]) == (1, 0, 0, 0)
        assert pusher.counters["retries"] == 2 and len(slept) == 2 and pusher.counters["rejected_series"] == 0
    finally:
        _close(srv)


def test_routing_pusher_buffer_cap_drops_oldest_with_counter():
    pusher = RoutingPusher(["127.0.0.1:1"], retries=0, backoff_seconds=0.0, sleep=lambda s: None, buffer_bytes=300)

    def dead(address, entries):
        raise OSError("connection refused")

    pusher._post = dead
    for i in range(6):
        pusher.push_cycle([(f'm{{app="a{i}"}}', [60, 120], [1.0, 2.0], None)])
    kept = {key for _, key, _ in pusher._buffer}
    assert pusher.counters["dropped_series"] > 0 and pusher.buffered < 6
    assert 'm{app="a5"}' in kept and 'm{app="a0"}' not in kept
    c = pusher.counters
    assert c["buffered_series"] == c["dropped_series"] + c["resent_series"] + pusher.buffered


def test_routing_pusher_new_member_hint_survives_one_failure():
    pusher = RoutingPusher(["127.0.0.1:1"], retries=0, backoff_seconds=0.0, sleep=lambda s: None)
    new_addr = "127.0.0.1:2"
    pusher._route['m{app="a"}'] = new_addr
    flaky = [1]

    def post(address, entries):
        assert address == new_addr
        if flaky[0]:
            flaky[0] -= 1
            raise OSError("connection refused (receiver warming up)")
        return {"accepted_samples": sum(len(e["times"]) for e in entries), "redirects": {}}

    pusher._post = post
    out1 = pusher.push_cycle([('m{app="a"}', [60], [1.0], None)])
    assert out1["errors"] == 1 and out1["buffered"] == 1 and pusher._route['m{app="a"}'] == new_addr
    out2 = pusher.push_cycle([])
    assert out2["accepted"] == 1 and out2["errors"] == 0


def test_routing_pusher_forgets_dead_address_and_rotates_seed():
    dead, live, relearned = "127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"
    pusher = RoutingPusher([dead, live], retries=0, backoff_seconds=0.0, sleep=lambda s: None)

    def post(address, entries):
        if address == dead:
            raise OSError("connection refused (drained member)")
        return {"accepted_samples": sum(len(e["times"]) for e in entries), "redirects": {}}

    pusher._post = post
    pusher._route['m{app="x"}'] = dead
    pusher._route['m{app="a"}'] = relearned
    out1 = pusher.push_cycle([('m{app="x"}', [60], [1.0], None), ('m{app="a"}', [60], [1.0], None)])
    assert out1["errors"] == 1 and out1["accepted"] == 1 and pusher._route['m{app="x"}'] == dead
    assert pusher.push_cycle([])["errors"] == 1
    assert 'm{app="x"}' not in pusher._route and pusher._route['m{app="a"}'] == relearned
    out3 = pusher.push_cycle([('m{app="b"}', [60], [2.0], None)])
    assert out3["errors"] == 0 and out3["accepted"] == 2


def test_transfer_endpoint_404_without_handoff_plane():
    srv, addr = _serve(RingStore(shards=1))
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(f"http://{addr}{TRANSFER_PATH}", data=b"x", method="POST"),
                                   timeout=5)
        assert ei.value.code == 404
        ei.value.close()
    finally:
        _close(srv)


def test_transfer_endpoint_body_cap_and_inflight_shed():
    """The receiver's byte cap answers an oversized transfer 413 before
    reading it, and its inflight shed answers 429, exactly as for pushes."""
    h, ring, _ = _receiver("port")
    srv, addr = _serve(ring, handoff=h, max_body_bytes=64)
    try:
        body = _framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA"))
        assert len(body) > 64
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(f"http://{addr}{TRANSFER_PATH}", data=body, method="POST"),
                                   timeout=5)
        assert ei.value.code == 413
        ei.value.close()
        assert ring.stats()["series"] == 0
    finally:
        _close(srv)
    srv, addr = _serve(ring, handoff=h, max_inflight=1)
    try:
        inflight = srv._foremast_inflight
        with inflight:  # one handler already busy: the next POST is over the cap
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(f"http://{addr}{TRANSFER_PATH}",
                                                              data=_framed(("hello", HANDOFF_VERSION, "w")),
                                                              method="POST"), timeout=5)
            assert ei.value.code == 429
            ei.value.close()
        req = urllib.request.Request(f"http://{addr}{TRANSFER_PATH}", data=_framed(
            ("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA"), ("done", "w-s", 1, 0)), method="POST")
        out = json.loads(urllib.request.urlopen(req, timeout=5).read())
        assert out == {"applied_series": 1, "applied_fits": 0, "torn": False, "done": True}
    finally:
        _close(srv)


# ---------------------------------------------------------------------------
# planned elasticity: lifecycle states, two rings, handoff
# ---------------------------------------------------------------------------


def test_member_state_roundtrip_and_forward_compat():
    rec = P.MemberRecord(worker_id="w-d", renewed_at=5.0, state=P.STATE_DRAINING)
    assert P.MemberRecord.from_payload(rec.to_payload()).state == P.STATE_DRAINING
    legacy = json.loads(rec.to_payload())
    del legacy["state"]
    assert P.MemberRecord.from_payload(json.dumps(legacy)).state == "active"
    legacy["state"] = "hibernating"
    assert P.MemberRecord.from_payload(json.dumps(legacy)).state == "active"


def _routers_with_states(store, states):
    t = [0.0]
    routers = {}
    for wid, state in states.items():
        mem = Membership(store, wid, lease_seconds=30.0, clock=_clock(t), state=state)
        mem.join()
        routers[wid] = MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t))
    for r in routers.values():
        r.refresh(force=True)
    return routers, t


def test_two_rings_fence_joiner_and_retire_drainer():
    routers, _ = _routers_with_states(InMemoryStore(), {"w-a": "active", "w-j": "joining", "w-d": "draining"})
    ra = routers["w-a"]
    docs = [Document(id=f"j{i}", app_name=f"app{i}") for i in range(400)]
    claim = {d.id: ra._ring.owner(doc_route_key(d)) for d in docs}
    target = {d.id: ra._target_ring.owner(doc_route_key(d)) for d in docs}
    assert "w-j" not in claim.values() and "w-d" in claim.values()
    assert "w-d" not in target.values() and "w-j" in target.values()
    moved = {d.app_name: ra.transfer_target(doc_route_key(d)) for d in docs
             if ra.transfer_target(doc_route_key(d)) is not None}
    assert moved and set(moved.values()) <= {"w-j"}
    for app in moved:
        assert claim[f"j{app[3:]}"] == "w-a"


def test_redirect_hint_routes_to_target_ring_owner():
    routers, _ = _routers_with_states(InMemoryStore(), {"w-a": "active", "w-j": "joining"})
    ra, rj = routers["w-a"], routers["w-j"]
    rj.membership.ingest_address = "127.0.0.1:7777"
    rj.membership.renew(force=True)
    ra.refresh(force=True)
    hinted = 0
    for i in range(200):
        hint = ra.redirect_hint(f'm{{app="app{i}"}}')
        if hint is not None:
            assert hint == "127.0.0.1:7777" and ra._target_ring.owner(f"app{i}") == "w-j"
            hinted += 1
    assert hinted > 0


def _framed(*recs) -> bytes:
    buf = io.BytesIO()
    for r in recs:
        append_record(buf, pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL))
    return buf.getvalue()


def _handoff_worker(store, wid, t, state="active", deadline=20.0):
    """One elastic seat: ring, fit cache, handoff, receiver and MeshNode,
    everything on the injected clock `t`."""
    ring = RingStore(budget_bytes=1 << 20, shards=2)
    handoff = P.HandoffManager(ring_store=ring, deadline_seconds=deadline, clock=_clock(t), sleep=lambda s: None)
    fits = ModelCache(256)
    handoff.register_caches({"fits": fits})
    mem = Membership(store, wid, lease_seconds=60.0, clock=_clock(t), state=state)
    router = MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t))
    srv, addr = _serve(ring, handoff=handoff)
    mem.ingest_address = addr
    node = MeshNode(mem, router, ring_store=ring, handoff=handoff, clock=_clock(t))
    node.fits, node.srv, node.ring = fits, srv, ring
    return node


def _seed_state(node, apps, t0=6000):
    for app in apps:
        node.ring.push(f'm{{app="{app}"}}', np.arange(t0, t0 + 60 * 32, 60, np.int64), np.ones(32, np.float32),
                       start=float(t0 - 600), record_lag=False)
        node.fits.put(("ma", 0, f"{app}|m0|http://x"), {"app": app})


def _hit(node, app, t) -> bool:
    return node.ring.query(f'm{{app="{app}"}}', 6000, 6000 + 60 * 31, now=t[0] + 6000 + 60 * 32)[0] == "hit"


def test_join_fenced_handoff_moves_state():
    store = InMemoryStore()
    t = [100.0]
    w1 = _handoff_worker(store, "w1", t)
    w2 = None
    try:
        w1.start()
        w1.on_tick()
        assert w1.state == "active"
        apps = [f"app{i}" for i in range(24)]
        _seed_state(w1, apps)
        w2 = _handoff_worker(store, "w2", t)
        w2.start()
        assert w2.state == "joining"
        assert not any(w2.claim_filter(Document(id=f"j{a}", app_name=a)) for a in apps)
        w1.on_tick()
        assert w1.wait_handoff_streams(10)
        w2.on_tick()
        assert w2.state == "active"
        sent, got = w1.handoff.counters_snapshot(), w2.handoff.counters_snapshot()
        assert sent["send"]["ok"] == 1 and sent["send"]["failed"] == 0 and got["receive"]["ok"] >= 1
        w1.router.refresh(force=True)
        moved = [a for a in apps if w2.router.owns_series(f'm{{app="{a}"}}')]
        assert moved and sent["series_sent"] == len(moved) == sent["fits_sent"]
        for a in moved:
            assert _hit(w2, a, t) and w2.fits.peek(("ma", 0, f"{a}|m0|http://x")) is not None
        for a in [a for a in apps if a not in moved][:5]:
            assert w1.fits.peek(("ma", 0, f"{a}|m0|http://x")) is not None
    finally:
        _close(w1.srv, *([w2.srv] if w2 is not None else []))


def _two_active(store, t):
    w1 = _handoff_worker(store, "w1", t)
    w2 = _handoff_worker(store, "w2", t)
    w1.start()
    w2.start()
    w1.on_tick()
    assert w1.wait_handoff_streams(10)
    w2.on_tick()
    w1.router.refresh(force=True)
    assert w1.state == w2.state == "active"
    return w1, w2


def test_drain_streams_state_then_leaves():
    store = InMemoryStore()
    t = [100.0]
    w1, w2 = _two_active(store, t)
    try:
        w2_apps = [a for a in (f"app{i}" for i in range(24)) if w2.router.owns_series(f'm{{app="{a}"}}')]
        assert w2_apps
        _seed_state(w2, w2_apps)
        assert w2.drain()["targets"] == {"w1": "ok"}
        assert w1.router.refresh(force=True) is True
        for a in w2_apps:
            assert w1.router.owns_series(f'm{{app="{a}"}}') and _hit(w1, a, t)
            assert w1.fits.peek(("ma", 0, f"{a}|m0|http://x")) is not None
        recv = w1.handoff.counters_snapshot()
        assert recv["series_received"] == recv["fits_received"] == len(w2_apps)
    finally:
        _close(w1.srv, w2.srv)


def test_drain_enumerates_state_once_for_all_targets():
    store = InMemoryStore()
    t = [100.0]
    workers = {w: _handoff_worker(store, w, t) for w in ("w1", "w2", "w3")}
    try:
        for w in workers.values():
            w.start()
        for _ in range(3):
            for w in workers.values():
                w.on_tick()
                assert w.wait_handoff_streams(10)
        assert all(w.state == "active" for w in workers.values())
        w3 = workers["w3"]
        w3_apps = [a for a in (f"app{i}" for i in range(32)) if w3.router.owns_series(f'm{{app="{a}"}}')]
        assert w3_apps
        _seed_state(w3, w3_apps)
        calls, orig = [0], w3.ring.shard_state

        def counting(i):
            calls[0] += 1
            return orig(i)

        w3.ring.shard_state = counting
        out = w3.drain()
        assert set(out["targets"]) == {"w1", "w2"} and all(r == "ok" for r in out["targets"].values())
        assert calls[0] == w3.ring.shard_count
        for w in ("w1", "w2"):
            workers[w].router.refresh(force=True)
        for a in w3_apps:
            owner = next(workers[w] for w in ("w1", "w2") if workers[w].router.owns_series(f'm{{app="{a}"}}'))
            assert _hit(owner, a, t)
    finally:
        _close(*(w.srv for w in workers.values()))


def test_stream_drain_keeps_the_seat_until_drain_leaves():
    store = InMemoryStore()
    t = [100.0]
    w1, w2 = _two_active(store, t)
    try:
        w2_apps = [a for a in (f"app{i}" for i in range(24)) if w2.router.owns_series(f'm{{app="{a}"}}')]
        _seed_state(w2, w2_apps)
        out = w2.stream_drain()
        assert out["targets"] == {"w1": "ok"} and w2.state == "draining"
        w1.router.refresh(force=True)
        assert {m.worker_id: m.state for m in w1.router.members()}.get("w2") == "draining"
        assert all(w2.claim_filter(Document(id=f"j{a}", app_name=a)) for a in w2_apps)
        # the drainer's refinement guard: no invalidation while streaming
        assert w2.draining
        before = w1.handoff.counters_snapshot()
        assert w2.drain() == out
        assert w1.router.refresh(force=True) is True
        assert [m.worker_id for m in w1.router.members()] == ["w1"]
        assert w1.handoff.counters_snapshot() == before
        assert w2.handoff.counters_snapshot()["send"]["ok"] == 1
    finally:
        _close(w1.srv, w2.srv)


def test_drain_streams_joiner_slice_too():
    store = InMemoryStore()
    t = [100.0]
    w1, w2 = _two_active(store, t)
    w3 = None
    try:
        w2_apps = [a for a in (f"app{i}" for i in range(32)) if w2.router.owns_series(f'm{{app="{a}"}}')]
        _seed_state(w2, w2_apps)
        w3 = _handoff_worker(store, "w3", t)
        w3.start()
        assert w3.state == "joining"
        w2.router.refresh(force=True)
        out = w2.drain()
        assert set(out["targets"]) == {"w1", "w3"} and all(r == "ok" for r in out["targets"].values())
        for w in (w1, w3):
            w.router.refresh(force=True)
        to_w3 = [a for a in w2_apps if w3.router.target_owner_of_route(a) == "w3"]
        assert to_w3 and all(_hit(w3, a, t) for a in to_w3)
        w1.on_tick()
        assert w1.wait_handoff_streams(10)
        w3.on_tick()
        assert w3.state == "active"
    finally:
        _close(w1.srv, w2.srv, *([w3.srv] if w3 is not None else []))


def test_restart_retaking_live_seat_does_not_fence():
    store = InMemoryStore()
    t = [100.0]
    w1 = _handoff_worker(store, "w1", t)
    w2 = _handoff_worker(store, "w2", t)
    w2b = None
    try:
        w1.start()
        w2.start()
        w2b = _handoff_worker(store, "w2", t)  # same persisted identity, lease still live
        w2b.start()
        assert w2b.state == "active" and not w2b.handoff.join_pending()
    finally:
        _close(w1.srv, w2.srv, *([w2b.srv] if w2b is not None else []))


def test_bootstrap_solo_member_never_fences():
    t = [100.0]
    w1 = _handoff_worker(InMemoryStore(), "w1", t)
    try:
        w1.start()
        assert w1.state == "active" and not w1.handoff.join_pending()
    finally:
        _close(w1.srv)


def test_simultaneous_joiners_restream_on_target_change():
    h = P.HandoffManager(deadline_seconds=10.0)

    def rec(wid, state):
        return P.MemberRecord(worker_id=wid, state=state, ingest_address=f"{wid}:1")

    view1 = [rec("w1", "active"), rec("w3", "joining")]
    h.note_members(view1)
    assert [m.worker_id for m in h.pending_joiners(view1, "w1")] == ["w3"]
    h.mark_served("w3")
    h.note_members(view1)
    assert h.pending_joiners(view1, "w1") == []
    view2 = view1 + [rec("w4", "joining")]
    h.note_members(view2)
    assert [m.worker_id for m in h.pending_joiners(view2, "w1")] == ["w3", "w4"]


def test_autoscale_cooldown_absorbs_transient_streaks():
    t = [0.0]
    d = P.AutoscaleDriver(P.AutoscaleConfig(breach_ticks=3, cooldown_seconds=60.0), clock=_clock(t))
    assert [d.observe(0.95, members=2) for _ in range(3)] == ["hold", "hold", "scale_up"]
    for _ in range(10):
        t[0] += 5.0
        assert d.observe(0.95, members=3) == "hold"
    t[0] = 61.0
    assert [d.observe(0.95, members=3) for _ in range(3)] == ["hold", "hold", "scale_up"]


def test_handoff_rejected_send_counted_once():
    h = P.HandoffManager(sleep=lambda s: None)

    def rejecting(address, body):
        raise urllib.error.HTTPError(f"http://{address}", 400, "version mismatch", {}, None)

    h._post = rejecting
    assert h.send_to(P.MemberRecord(worker_id="w-j", ingest_address="old:1"), None, "w-s") is False
    c = h.counters_snapshot()
    assert (c["send"]["rejected"], c["send"]["failed"], c["send"]["ok"]) == (1, 0, 0)


# -- the torn-state matrix: every damage shape degrades per record ------------


def _series_rec(app, t0=6000, n=16):
    ts = np.arange(t0, t0 + 60 * n, 60, np.int64)
    return ("series", f'm{{app="{app}"}}', ts, np.ones(n, np.float32), [[float(t0 - 600), float(t0 + 60 * (n - 1))]])


def _fit_rec(app):
    return ("fit", "fits", ("ma", 0, f"{app}|m0|http://x"), {"app": app})


def _receiver_manager():
    h, ring, caches = _receiver("port")
    return h, ring, caches["fits"]


def test_handoff_truncated_stream_keeps_healthy_prefix():
    h, ring, _ = _receiver_manager()
    body = _framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA"), _fit_rec("appA"), _series_rec("appB"),
                   ("done", "w-s", 2, 1))
    code, out = h.apply_transfer(body[:-10])
    assert code == 200 and out["torn"] is True and out["done"] is False and out["applied_series"] >= 1
    assert ring.query('m{app="appA"}', 6000, 6000 + 60 * 15, now=7000.0)[0] == "hit"
    assert h.counters_snapshot()["receive"]["torn"] == 1
    assert "w-s" not in h.debug_state()["done_from"]


def test_handoff_version_mismatch_rejected_whole_batch():
    h, ring, _ = _receiver_manager()
    code, _ = h.apply_transfer(_framed(("hello", 99, "w-s"), _series_rec("appA")))
    assert code == 400 and ring.stats()["series"] == 0 and h.counters_snapshot()["receive"]["rejected"] == 1


def test_handoff_garbage_and_empty_bodies_rejected():
    h, ring, _ = _receiver_manager()
    for raw in (b"", b"not-a-frame-at-all"):
        assert h.apply_transfer(raw)[0] == 400
    assert h.counters_snapshot()["receive"]["rejected"] == 2 and ring.stats()["series"] == 0


def test_handoff_undecodable_record_keeps_prefix():
    buf = io.BytesIO(_framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA")))
    buf.seek(0, 2)
    append_record(buf, b"\x80\x04 this is not a pickle")
    h, _, _ = _receiver_manager()
    code, out = h.apply_transfer(buf.getvalue())
    assert code == 200 and out["torn"] is True and out["applied_series"] == 1


def test_handoff_record_needing_jax_is_a_tear_not_an_import():
    """A record that names any other JAX object than its arrays is refused
    by the port's unpickler: the prefix is kept and the record torn."""
    h, ring, fits = _receiver_manager()
    buf = io.BytesIO(_framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA")))
    buf.seek(0, 2)
    append_record(buf, b"\x80\x02cjaxlib.xla_extension\nDeviceArray\n)R.")  # GLOBAL, (), REDUCE
    code, out = h.apply_transfer(buf.getvalue())
    assert code == 200 and out["applied_series"] == 1 and out["torn"] is True and len(fits) == 0


class _Reduces:
    """Pickles as a call of `fn(*args)`: what a crafted record would carry."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("callee", ["os.system", "builtins.eval", "subprocess.call", "a port function"])
def test_handoff_record_naming_a_callable_is_refused(tmp_path, callee):
    """The transfer endpoint faces the network: a record that names a
    callable outside the allow-list (here one that would create a file) is
    torn before anything runs, and the prefix stays applied."""
    import os
    import subprocess

    from foremast_tpu_torch.ingest.snapshot import atomic_write

    marker = tmp_path / "ran"
    fn, args = {
        "os.system": (os.system, (f"touch {marker}",)),
        "builtins.eval": (eval, (f"open({str(marker)!r}, 'w')",)),
        "subprocess.call": (subprocess.call, (["touch", str(marker)],)),
        "a port function": (atomic_write, (str(marker), b"x")),
    }[callee]
    h, ring, fits = _receiver_manager()
    body = _framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA"), ("fit", "fits", ("ma", 0, "appA|m0|u"),
                                                                             _Reduces(fn, *args)))
    code, out = h.apply_transfer(body)
    assert code == 200 and out["applied_series"] == 1 and out["torn"] is True and len(fits) == 0
    assert not marker.exists()


def test_handoff_record_of_numpy_scalars_and_containers_applies():
    """What the allow-list lets through: numpy arrays, scalars and dtypes,
    and the plain containers a cache value may hold."""
    import collections

    h, _, fits = _receiver_manager()
    value = {"app": "appA", "mu": np.float32(1.5), "n": np.int64(3), "dt": np.dtype("f4"),
             "w": np.arange(4, dtype=np.float32), "seen": {1, 2}, "order": collections.OrderedDict(a=1),
             "span": complex(1, 2), "raw": bytearray(b"ab")}
    body = _framed(("hello", HANDOFF_VERSION, "w-s"), ("fit", "fits", ("ma", 0, "appA|m0|u"), value))
    code, out = h.apply_transfer(body)
    assert code == 200 and out["torn"] is False
    got = fits.persistable_snapshot()[("ma", 0, "appA|m0|u")]
    assert sorted(got) == sorted(value) and np.array_equal(got["w"], value["w"]) and got["mu"] == value["mu"]
    assert type(got["order"]) is collections.OrderedDict and got["seen"] == {1, 2}


def test_handoff_duplicate_delivery_replays_clean():
    h, ring, _ = _receiver_manager()
    body = _framed(("hello", HANDOFF_VERSION, "w-s"), _series_rec("appA"), _fit_rec("appA"), ("done", "w-s", 1, 1))
    assert h.apply_transfer(body)[0] == 200
    code, out = h.apply_transfer(body)
    assert code == 200 and out["done"] is True and ring.stats()["series"] == 1
    assert ring.query('m{app="appA"}', 6000, 6000 + 60 * 15, now=7000.0)[0] == "hit"
    c = h.counters_snapshot()
    assert c["receive"]["ok"] == 1 and c["receive"]["duplicate"] == 1
    assert h.debug_state()["done_from"] == ["w-s"]


def test_handoff_mid_transfer_receiver_death_degrades_sender():
    routers, _ = _routers_with_states(InMemoryStore(), {"w-s": "active", "w-j": "joining"})
    ring = RingStore(budget_bytes=1 << 20, shards=1)
    h = P.HandoffManager(ring_store=ring, batch_bytes=64, retries=1, sleep=lambda s: None)
    h.register_caches({"fits": ModelCache(64)})
    for i in range(8):
        ring.push(f'm{{app="app{i}"}}', np.arange(6000, 6000 + 60 * 16, 60, np.int64), np.ones(16, np.float32),
                  record_lag=False)
    receiver, _, _ = _receiver_manager()
    calls = [0]

    def dying(address, body):
        calls[0] += 1
        if calls[0] > 2:
            raise ConnectionRefusedError("receiver died mid-transfer")
        receiver.apply_transfer(body)

    h._post = dying
    assert h.send_to(P.MemberRecord(worker_id="w-j", ingest_address="dead:1"), routers["w-s"], "w-s") is False
    c = h.counters_snapshot()
    assert c["send"]["failed"] == 1 and c["send"]["ok"] == 0
    assert receiver.counters_snapshot()["series_received"] >= 1 and receiver.debug_state()["done_from"] == []


def test_concurrent_transfers_lose_no_count():
    """Receiver threads apply transfers while a tick-side thread purges
    protections and reads counters: with a short switch interval, no
    applied record, counter or done marker is lost."""
    import threading

    h, ring, fits = _receiver_manager()
    bodies = {w: [_framed(("hello", HANDOFF_VERSION, f"w{w}"), _series_rec(f"app{w}-{k}"), _fit_rec(f"app{w}-{k}"),
                          ("done", f"w{w}", 1, 1)) for k in range(25)] for w in range(8)}
    stop = threading.Event()
    errors = []

    def apply(w):
        try:
            for body in bodies[w]:
                assert h.apply_transfer(body)[0] == 200
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def tick_side():
        while not stop.is_set():
            h.purge_protected()
            h.counters_snapshot()
            h.is_protected('m{app="app0-0"}')

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ticker = threading.Thread(target=tick_side)
        ticker.start()
        threads = [threading.Thread(target=apply, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stop.set()
        ticker.join(60)
    finally:
        sys.setswitchinterval(saved)
    assert not errors and not ticker.is_alive() and not any(t.is_alive() for t in threads)
    c = h.counters_snapshot()
    assert (c["series_received"], c["fits_received"]) == (200, 200)
    assert c["receive"]["ok"] == 8 and c["receive"]["duplicate"] == 192
    assert h.debug_state()["done_from"] == [f"w{w}" for w in range(8)]
    assert ring.stats()["series"] == 200 and len(fits) == 200 and h.debug_state()["protected_series"] == 200


def test_join_deadline_degrades_to_cold_refit_not_deadlock():
    t = [1000.0]
    h = P.HandoffManager(deadline_seconds=30.0, clock=_clock(t))
    h.begin_join({"w-a", "w-b"})
    assert h.join_pending()
    assert h.apply_transfer(_framed(("hello", 1, "w-a"), ("done", "w-a", 0, 0)))[0] == 200
    assert h.join_ready({"w-a", "w-b"}) is False
    t[0] = 1029.0
    assert h.join_ready({"w-a", "w-b"}) is False
    t[0] = 1031.0
    assert h.join_ready({"w-a", "w-b"}) is True and not h.join_pending()
    assert h.debug_state()["join_wait_seconds"] == 31.0


def test_join_discounts_dead_senders():
    h = P.HandoffManager(deadline_seconds=1e9, clock=lambda: 1000.0)
    h.begin_join({"w-a", "w-b"})
    h.apply_transfer(_framed(("hello", 1, "w-a"), ("done", "w-a", 0, 0)))
    assert h.join_ready({"w-a"}) is True


def test_evict_unowned_never_races_a_transfer():
    t = [1000.0]
    ring = RingStore(budget_bytes=1 << 20, shards=1)
    h = P.HandoffManager(ring_store=ring, deadline_seconds=10.0, clock=_clock(t))
    assert h.apply_transfer(_framed(("hello", 1, "w-s"), _series_rec("appX")))[0] == 200
    key = 'm{app="appX"}'
    assert h.is_protected(key)
    assert ring.evict_unowned(lambda k: h.is_protected(k)) == 0 and ring.stats()["series"] == 1
    t[0] = 1021.0
    assert not h.is_protected(key)
    assert ring.evict_unowned(lambda k: h.is_protected(k)) == 1


def test_node_eviction_keeps_target_ring_and_protected_series():
    """MeshNode's retention: on a membership change the ring keeps series
    owned on the claim ring, on the target ring, or just transferred."""
    store = InMemoryStore()
    t = [100.0]
    w1, w2 = _two_active(store, t)
    try:
        apps = [f"app{i}" for i in range(40)]
        _seed_state(w1, apps)
        foreign = [a for a in apps if not w1.router.owns_series(f'm{{app="{a}"}}')]
        assert foreign
        w1.handoff.protect([f'm{{app="{foreign[0]}"}}'])
        w3 = _handoff_worker(store, "w3", t)  # a joiner: the rings move
        try:
            w3.start()
            w1.on_tick()
            assert w1.wait_handoff_streams(10)
            kept = {k for k, *_ in _ring_contents(w1.ring).items()}
            assert f'm{{app="{foreign[0]}"}}' in kept
            for a in foreign[1:]:
                assert f'm{{app="{a}"}}' not in kept
            for a in apps:
                key = f'm{{app="{a}"}}'
                if w1.router.owns_series(key) or w1.router.target_owner_of_route(a) == "w1":
                    assert key in kept
        finally:
            _close(w3.srv)
    finally:
        _close(w1.srv, w2.srv)


def test_on_tick_keeps_the_last_view_through_a_transient_store_error():
    """A transient store error during renew or refresh degrades the tick:
    the mesh keeps its last ring view, and nothing raises."""
    store = InMemoryStore()
    (a, b), t = _mesh_pair(store)
    owned = {f"app{i}" for i in range(100) if a.router.owns_doc(Document(id="x", app_name=f"app{i}"))}

    def down(*_a, **_k):
        raise ConnectionError("store unreachable")

    store.update = down
    store.list_app = down
    t[0] = 100.0  # a renew is due and would fail
    a.on_tick()
    assert {f"app{i}" for i in range(100) if a.router.owns_doc(Document(id="x", app_name=f"app{i}"))} == owned
    assert len(a.router.members()) == 2
    store.list_app = lambda app: (_ for _ in ()).throw(ValueError("a bug, not an outage"))
    store.update = InMemoryStore.update.__get__(store)
    a.router._last_refresh = -1e9
    with pytest.raises(ValueError):
        a.on_tick()


def test_mesh_collector_states_and_handoff_families_lint_clean():
    pytest.importorskip("prometheus_client")
    from prometheus_client import CollectorRegistry

    from foremast_tpu.observe.metrics_lint import lint_registry
    from foremast_tpu_torch.mesh.node import MeshCollector

    store = InMemoryStore()
    t = [100.0]
    w1 = _handoff_worker(store, "w1", t)
    w2 = None
    try:
        w1.start()
        w1.on_tick()
        w2 = _handoff_worker(store, "w2", t)
        w2.start()
        w1.router.refresh(force=True)
        reg = CollectorRegistry()
        reg.register(MeshCollector(w1))
        assert lint_registry(reg) == []
        for state, n in (("active", 1.0), ("joining", 1.0), ("draining", 0.0)):
            assert reg.get_sample_value("foremast_mesh_members", {"state": state}) == n
        assert reg.get_sample_value("foremast_handoff_state_total", {"kind": "series", "direction": "sent"}) == 0.0
        assert reg.get_sample_value("foremast_handoff_transfers_total", {"role": "send", "result": "failed"}) == 0.0
    finally:
        _close(w1.srv, *([w2.srv] if w2 is not None else []))


def test_observe_server_auto_increments_busy_port():
    """Co-hosted mesh members walk past a busy scrape port; the member
    record then carries the one each got."""
    pytest.importorskip("prometheus_client")
    import socket

    from foremast_tpu_torch.observe.spans import start_observe_server

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        srv, _ = start_observe_server(port, state_fn=lambda: {"ok": 1}, host="127.0.0.1", max_port_tries=8)
        try:
            actual = srv.server_address[1]
            assert port < actual <= port + 7
            assert json.loads(urllib.request.urlopen(f"http://127.0.0.1:{actual}/debug/state").read()) == {"ok": 1}
        finally:
            _close(srv)
    finally:
        blocker.close()


def test_mesh_debug_state_carries_lifecycle_and_handoff():
    t = [100.0]
    w1 = _handoff_worker(InMemoryStore(), "w1", t)
    try:
        w1.start()
        w1.on_tick()
        state = w1.debug_state()
        assert state["state"] == "active" and state["members"][0]["state"] == "active"
        assert state["handoff"]["join_pending"] is False and state["handoff"]["deadline_seconds"] == 20.0
    finally:
        _close(w1.srv)


# ---------------------------------------------------------------------------
# the worker on the mesh
# ---------------------------------------------------------------------------


def _mesh_workers(pkg: str, services: int, wids, t):
    """Workers of package `pkg` over one push fleet, each with its own
    ring holding the whole fleet, mesh node, handoff plane and receiver."""
    from tests.torch_workers import push_fleet

    mesh, ingest, _, _, _, _ = _pkg(pkg)
    store, ring0, keys, _, _ = push_fleet(pkg, services)
    seats = {}
    for wid in wids:
        ring = ingest.RingStore(shards=2)
        for i in range(ring0.shard_count):
            for key, tt, vv, cf, ct, _older in ring0.shard_state(i):
                ring.push(key, tt, vv, start=cf, end=ct, record_lag=False)
        handoff = mesh.HandoffManager(ring_store=ring, deadline_seconds=20.0, clock=_clock(t), sleep=lambda s: None)
        mem = mesh.Membership(store, wid, lease_seconds=60.0, clock=_clock(t))
        router = mesh.MeshRouter(mem, refresh_seconds=0.0, clock=_clock(t))
        srv, _ = ingest.start_ingest_server(0, ring, host="127.0.0.1", router=router, handoff=handoff)
        mem.ingest_address = f"127.0.0.1:{srv.server_address[1]}"
        node = mesh.MeshNode(mem, router, ring_store=ring, handoff=handoff, clock=_clock(t))
        seats[wid] = (node, ring, srv)
    return store, keys, seats


def _make_worker(pkg, store, ring, node, services):
    from foremast_tpu import ingest as JI
    from foremast_tpu.config import BrainConfig as JaxConfig
    from foremast_tpu.jobs import BrainWorker as JaxWorker
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.ingest import RingSource
    from foremast_tpu_torch.jobs import BrainWorker

    kw = dict(claim_limit=services + 4, worker_id=node.worker_id, mesh=node)
    if pkg == "jax":
        return JaxWorker(store, JI.RingSource(ring, fallback=None), config=JaxConfig(
            algorithm="moving_average_all", season_steps=24, max_cache_size=4 * services), device_mesh=None, **kw)
    return BrainWorker(store, RingSource(ring, fallback=None), config=BrainConfig(
        algorithm="moving_average_all", season_steps=24, max_cache_size=4 * services), device="cpu", **kw)


def _statuses(store) -> dict:
    return {d.id: (d.status, d.status_code, d.reason, d.anomaly_info) for d in store._docs.values()
            if d.app_name != "__foremast_mesh__"}


def _reset(store):
    for d in store._docs.values():
        if d.app_name != "__foremast_mesh__":
            d.status = "initial"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_worker_mesh_partitions_then_a_planned_join_moves_fits(pkg):
    """Two mesh workers judge a shared fleet without a double claim; a
    third joins through the handoff, and its first claims make 0 cold
    fits and 0 fallback reads. Both packages write the same statuses."""
    from foremast_tpu_torch.jobs.models import STATUS_PREPROCESS_COMPLETED

    services = 24
    t = [1000.0]
    store, keys, seats = _mesh_workers(pkg, services, ("w1", "w2", "w3"), t)
    workers = {}
    try:
        w1, w2 = seats["w1"][0], seats["w2"][0]
        w1.start()
        w2.start()  # fenced behind w1; the (empty) handoff activates it
        w1.on_tick()
        assert w1.wait_handoff_streams(20)
        w2.on_tick()
        w1.on_tick()
        assert w1.state == w2.state == "active"
        for wid in ("w1", "w2"):
            node, ring, _ = seats[wid]
            workers[wid] = _make_worker(pkg, store, ring, node, services)
        judged = {wid: workers[wid].tick(now=1_760_000_150.0) for wid in ("w1", "w2")}
        assert sum(judged.values()) == services and all(judged.values())
        first = _statuses(store)
        assert {s[0] for s in first.values()} == {STATUS_PREPROCESS_COMPLETED}
        _reset(store)
        node3, ring3, _ = seats["w3"]
        node3.start()
        assert node3.joining
        workers["w3"] = _make_worker(pkg, store, ring3, node3, services)
        for wid in ("w1", "w2"):
            seats[wid][0].on_tick()
            assert seats[wid][0].wait_handoff_streams(20)
        n3 = workers["w3"].tick(now=1_760_000_200.0)  # activates, then claims its partition
        assert node3.state == "active" and n3 > 0
        st = workers["w3"].debug_state()
        assert st["mesh"]["handoff"]["fits_received"] > 0 and st["mesh"]["state"] == "active"
        # every claim took the warm columnar path (no cold fit) and no
        # history was read, from the ring or anywhere else
        assert st["last_tick"]["fast"] == n3
        assert sum(st["cold_start"]["hist_reads"].values()) == 0
        for wid in ("w1", "w2"):
            workers[wid].tick(now=1_760_000_200.0)
        assert _statuses(store) == first
    finally:
        for w in workers.values():
            w.close()
        for _node, _ring, srv in seats.values():
            _close(srv)


def test_worker_attaches_the_five_caches_and_shows_the_mesh():
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.ingest import RingSource
    from foremast_tpu_torch.jobs import BrainWorker

    store = InMemoryStore()
    t = [100.0]
    seat = _handoff_worker(store, "w-a", t)
    try:
        w = BrainWorker(store, RingSource(seat.ring, fallback=None), config=BrainConfig(), device="cpu",
                        worker_id="w-a", mesh=seat)
        assert set(seat.handoff.fit_caches) == {"fits", "gaps", "refine", "joint", "jmeta"}
        assert seat.handoff.fit_caches["fits"] is w._fit_cache
        assert w.claim_filter == seat.claim_filter
        w.tick(now=1_760_000_000.0)
        state = w.debug_state()["mesh"]
        assert state["live_members"] == 1 and state["worker_id"] == "w-a" and state["claim_docs"]["owned"] >= 0
        w.close()
    finally:
        _close(seat.srv)
