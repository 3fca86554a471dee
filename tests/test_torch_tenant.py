"""The port's tenant plane (`foremast_tpu_torch/tenant/` and its hooks in
the arena, the ring, the receiver, the dirty set and the worker) against
the JAX package's, after `tests/test_tenant.py`.

The same inputs, made from numpy seeds, go to both packages: tenant
resolution of series, documents and fit keys (the worker's own keys,
built by each package from one document), envelopes from
`FOREMAST_TENANTS`, the cardinality cap, deficit-round-robin pick
sequences, dirty drains and sweep-pool slice orders (fair and FIFO), ring
evictions under envelopes (the same resident keys), and arena row maps
with and without tenancy. With no tenancy, or one tenant without an
envelope, every seam is byte-identical to the untenanted path. The
receiver sheds only the flooding tenant; the verdict-latency histogram
carries each doc's tenant; a tenanted worker writes the statuses an
untenanted one writes and the JAX worker writes, serving quiet tenants
in the first slice."""

from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu import tenant as J
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.ingest import RingStore as JaxRing
from foremast_tpu.ingest import canonical_series as jax_canonical
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.jobs.models import Document as JaxDocument
from foremast_tpu.jobs.store import InMemoryStore as JaxStore
from foremast_tpu.metrics.promql import prometheus_url
from foremast_tpu.reactive import DirtySet as JaxDirty
from foremast_tpu_torch import tenant as T
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.ingest import RingStore, canonical_series, start_ingest_server, stop_ingest_server
from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
from foremast_tpu_torch.reactive import DirtySet
from tests.torch_workers import NOW, PortArraySource

PACKAGES = {"jax": J, "port": T}


@pytest.fixture(autouse=True)
def _no_global_tenancy():
    """Every test starts and ends untenanted in both packages: workers,
    rings, dirty sets and arenas read the process-global registry at
    construction."""
    for pkg in PACKAGES.values():
        pkg.set_tenancy(None)
    yield
    for pkg in PACKAGES.values():
        pkg.set_tenancy(None)


def _reg(pkg, **whale_fields):
    return pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale", **whale_fields),
                               "quiet": pkg.TenantSpec(name="quiet")})


def _series(tenant: str, i: int) -> str:
    return canonical_series(f'up{{app="app{i}",namespace="t",tenant="{tenant}"}}')


def _doc_json(s: int, tenant: str) -> dict:
    expr = f'latency{{app="app{s}",namespace="t",tenant="{tenant}"}}'
    url = prometheus_url({"endpoint": "http://p/api/v1/", "query": expr, "start": 0, "end": 600, "step": 60})
    return JaxDocument(id=f"job-{s}", app_name=f"app{s}", historical_config=f"latency== {url}",
                       current_config=f"latency== {url}").to_json()


def _docs(specs) -> tuple[list, list]:
    """(JAX docs, port docs) from (index, tenant) pairs: the same JSON."""
    js = [_doc_json(s, t) for s, t in specs]
    return [JaxDocument.from_json(d) for d in js], [Document.from_json(d) for d in js]


# ---------------------------------------------------------------------------
# resolution + envelope config
# ---------------------------------------------------------------------------


def test_resolution_series_doc_and_key_as_jax():
    rng = np.random.default_rng(3)
    tenants = ["whale", "quiet", "acme", None]
    keys = []
    for i in range(40):
        t = tenants[int(rng.integers(4))]
        lab = f',tenant="{t}"' if t else ""
        keys.append(f'up{{app="a{i}",zone="z{int(rng.integers(3))}"{lab}}}')
    for label in ("tenant", "zone"):
        regs = {n: pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale")}, label=label)
                for n, pkg in PACKAGES.items()}
        assert [regs["port"].tenant_of_series(k) for k in keys] == [regs["jax"].tenant_of_series(k) for k in keys]
    jdocs, pdocs = _docs([(i, tenants[i % 3]) for i in range(6)])
    pdocs.append(Document(id="d", app_name="a"))
    jdocs.append(JaxDocument(id="d", app_name="a"))
    reg_t, reg_j = _reg(T), _reg(J)
    got = [reg_t.tenant_of_doc(d) for d in pdocs]
    assert got == [reg_j.tenant_of_doc(d) for d in jdocs]
    assert got == ["whale", "quiet", "acme", "whale", "quiet", "acme", T.DEFAULT_TENANT]


def test_fit_key_tenant_matches_jax_for_the_same_document():
    """The arena resolves a fit key's tenant from the URL-encoded history
    URL inside it: each package's worker builds its own key from the same
    document, and both resolve to the doc's tenant. This pins the port's
    key format to the JAX package's."""
    jdocs, pdocs = _docs([(7, "whale"), (8, "quiet")])
    jw = JaxWorker(JaxStore(), PortArraySource({}), config=JaxConfig(), device_mesh=None)
    pw = BrainWorker(InMemoryStore(), PortArraySource({}), config=BrainConfig(), device="cpu")
    for jd, pd, tenant in zip(jdocs, pdocs, ("whale", "quiet")):
        jkeys = [a[-1] for a in jw._doc_meta(jd)[0]]
        pkeys = [a[-1] for a in pw._doc_meta(pd)[0]]
        assert pkeys == jkeys and pkeys[0] is not None
        assert _reg(T).tenant_of_key(pkeys[0]) == _reg(J).tenant_of_key(jkeys[0]) == tenant
    jw.close()
    pw.close()


def test_tenancy_from_env_inline_path_and_errors(tmp_path, monkeypatch):
    for pkg in PACKAGES.values():
        assert pkg.tenancy_from_env({}) is None
    spec = {"acme": {"weight": 4, "ring_bytes": 1024, "arena_rows": 8, "ingest_bytes_per_s": 64,
                     "burst_bytes": 256}, "default": {}}
    p = tmp_path / "tenants.json"
    p.write_text(json.dumps({"tenants": spec}))
    for raw in (json.dumps(spec), f"@{p}"):
        env = {"FOREMAST_TENANTS": raw, "FOREMAST_TENANT_LABEL": "team", "FOREMAST_TENANT_LABEL_MAX": "5"}
        got, want = T.tenancy_from_env(env), J.tenancy_from_env(env)
        assert got.debug_state() == want.debug_state()
        assert got.weight("acme") == 4.0 and got.fair and got.label == "team" and got.label_max == 5
    single = T.tenancy_from_env({"FOREMAST_TENANTS": json.dumps({"only": {"weight": 2}})})
    assert single is not None and not single.fair
    for bad in ("{not json", json.dumps({"x": {"bogus_field": 1}}), json.dumps({"x": {"weight": 0}}), "[1]",
                json.dumps({"tenants": [1]})):
        for pkg in PACKAGES.values():
            with pytest.raises(ValueError):
                pkg.tenancy_from_env({"FOREMAST_TENANTS": bad})
    # the process-global registry is built from the env on first use
    monkeypatch.setenv("FOREMAST_TENANTS", json.dumps(spec))
    monkeypatch.setattr(T.registry, "_GLOBAL_SET", False)
    assert T.get_tenancy().weights() == {"acme": 4.0, "default": 1.0}
    prev = T.set_tenancy(None)
    assert prev is not None and T.get_tenancy() is None


# ---------------------------------------------------------------------------
# bounded-cardinality attribution
# ---------------------------------------------------------------------------


def _capped(pkg):
    from prometheus_client import CollectorRegistry

    from foremast_tpu.observe.metrics_lint import lint_registry

    reg = pkg.TenantRegistry({"a": pkg.TenantSpec(name="a"), "b": pkg.TenantSpec(name="b")}, label_max=3)
    names = [reg.metric_tenant(t) for t in ("a", "default", "u0", "u1", "u2", "u3", "u4", "u3", "u1")]
    acct = pkg.TenantAccounting(reg)
    for t in ("a", "u0", "u9", "u10"):
        acct.count_shed(reg.metric_tenant(t))
        acct.add_ring_bytes(reg.metric_tenant(t), 64)
    acct.count_eviction("b", 3)
    acct.count_claims("u1", 2)
    acct.add_ring_bytes("b", 100)
    acct.add_ring_bytes("b", -500)  # clamped at zero
    registry = CollectorRegistry()
    registry.register(pkg.TenantCollector(acct))
    assert lint_registry(registry) == []
    families = sorted((m.name, m.type, tuple((s.name, tuple(sorted(s.labels.items())), s.value) for s in m.samples))
                      for m in registry.collect())
    return names, reg.dropped_label_values, acct.snapshot(), families, reg.debug_state()


def test_tenant_label_cardinality_cap_and_lint_clean_as_jax():
    got, want = _capped(T), _capped(J)
    assert got == want
    names, dropped, snap, families, _ = got
    assert names == ["a", "default", "u0", "u1", "u2", "other", "other", "other", "u1"]
    assert dropped == 5  # u3, u4, then u9, u10 and `other` itself as the ledger folds them again
    assert snap["other"]["shed"] == 2 and snap["b"]["ring_bytes"] == 0
    assert {f[0] for f in families} == {"foremast_tenant_shed", "foremast_tenant_evictions",
                                        "foremast_tenant_claims", "foremast_tenant_ring_bytes"}


def test_accounting_for_is_one_ledger_per_registry():
    reg = _reg(T)
    assert T.accounting_for(reg) is T.accounting_for(reg)
    assert T.accounting_for(reg) is not T.accounting_for(_reg(T))


# ---------------------------------------------------------------------------
# weighted-fair scheduling: DRR, dirty-set drain, sweep pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drr_pick_sequences_as_jax(seed):
    """Random weights, backlogs and slot counts over several calls (the
    deficits persist between calls, and an emptied tenant forfeits)."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(int(rng.integers(2, 6)))]
    weights = {n: float(rng.choice([0.5, 1.0, 2.0, 3.0, 4.0])) for n in names}
    drrs = {n: pkg.DeficitRoundRobin(weights, default_weight=float(rng.choice([1.0, 2.0])))
            for n, pkg in PACKAGES.items()}
    for _ in range(12):
        queued = {n: int(rng.integers(0, 20)) for n in names + ["stranger"]}
        n_slots = int(rng.integers(0, 30))
        got, want = drrs["port"].pick(queued, n_slots), drrs["jax"].pick(queued, n_slots)
        assert got == want
        assert len(got) == min(n_slots, sum(queued.values()))


def test_drr_weighted_split_and_forfeit():
    drr = T.DeficitRoundRobin({"a": 4.0, "b": 1.0})
    order = drr.pick({"a": 100, "b": 100}, 10)
    assert order.count("a") == 8 and order.count("b") == 2
    drr = T.DeficitRoundRobin({"a": 1.0, "b": 1.0})
    assert drr.pick({"a": 10}, 4) == ["a"] * 4
    assert drr.pick({"a": 10, "b": 10}, 4).count("b") == 2  # no hoarded credit


def _drain(dirty_cls, tenancy, marks, takes):
    d = dirty_cls(max_keys=1024, tenancy=tenancy)
    for key, stamp in marks:
        d.mark_series(key, now=stamp)
    out = [[rk for rk, _ in d.take(n)] for n in takes]
    return out, d.debug_state()["tenant_fair"]


@pytest.mark.parametrize("tenancy", ["none", "single", "two", "weighted"])
def test_dirty_drains_as_jax(tenancy):
    """Fair drains (two tenants, weighted or not) and FIFO drains (none,
    or a single tenant: the parity pin) take the same keys in the same
    order as the JAX package's."""
    rng = np.random.default_rng(5)
    marks = []
    now = 1_000_000.0
    for i in range(120):
        t = "whale" if i < 100 else ("quiet" if rng.random() < 0.7 else "acme")
        marks.append((_series(t, i), now + 0.001 * i))
    takes = [8, 3, 16, 0, 200]

    def reg(pkg):
        if tenancy == "none":
            return None
        if tenancy == "single":
            return pkg.TenantRegistry({"only": pkg.TenantSpec(name="only")})
        w = 3.0 if tenancy == "weighted" else 1.0
        return pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale", weight=w),
                                   "quiet": pkg.TenantSpec(name="quiet")})

    got = _drain(DirtySet, reg(T), marks, takes)
    want = _drain(JaxDirty, reg(J), marks, takes)
    assert got == want
    order, fair = got
    assert fair is (tenancy in ("two", "weighted"))
    if fair:
        assert "app100" in order[0] or "app101" in order[0]  # a quiet arrival made the first drain
    else:
        assert order[0] == [f"app{i}" for i in range(8)]  # strict FIFO


def test_fair_drain_keeps_oldest_first_within_a_tenant():
    dirty = DirtySet(max_keys=1024, tenancy=_reg(T))
    now = time.time()
    for i in range(100):
        dirty.mark_series(_series("whale", i), now=now)
    dirty.mark_series(_series("quiet", 0), now=now + 0.001)
    first = [rk for rk, _ in dirty.take(8)]
    assert "app0" in first
    whale = [rk for rk in first if rk != "app0"]
    assert whale == sorted(whale, key=lambda rk: int(rk[3:]))


@pytest.mark.parametrize("tenancy", ["none", "single", "two", "weighted"])
def test_sweep_pool_slice_orders_as_jax(tenancy):
    from foremast_tpu.jobs.worker import _SweepPool as JaxPool
    from foremast_tpu_torch.jobs.worker import _SweepPool

    specs = [(s, "whale") for s in range(40)] + [(100 + s, "quiet") for s in range(6)] + \
        [(200 + s, "acme") for s in range(5)]
    jdocs, pdocs = _docs(specs)

    def reg(pkg):
        if tenancy == "none":
            return None
        if tenancy == "single":
            return pkg.TenantRegistry({"only": pkg.TenantSpec(name="only")})
        w = 2.0 if tenancy == "weighted" else 1.0
        return pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale", weight=w),
                                   "quiet": pkg.TenantSpec(name="quiet")})

    def orders(pool_cls, pkg, docs):
        pool = pool_cls(docs, tenancy=reg(pkg))
        out = [[d.id for d in pool.take(8)]]
        pool.promote("app30")  # a promoted doc jumps every tenant
        out += [[d.id for d in pool.take(n)] for n in (5, 9, 1)]
        out.append(sorted(d.id for d in pool.drain()))
        out.append(pool.take(4))
        return out

    got, want = orders(_SweepPool, T, pdocs), orders(JaxPool, J, jdocs)
    assert got == want
    if tenancy in ("two", "weighted"):
        assert any(i.startswith("job-10") for i in got[0]), got[0]
    else:
        assert got[0] == [f"job-{s}" for s in range(8)]
    assert got[1][0] == "job-30" and got[-1] == []


# ---------------------------------------------------------------------------
# resource isolation: ring envelopes + arena envelopes
# ---------------------------------------------------------------------------


def _ring_run(ring_cls, canon, tenancy, pushes, budget):
    ring = ring_cls(budget_bytes=budget, shards=2, tenancy=tenancy)
    for key, ts, vs in pushes:
        ring.push(canon(key), ts, vs, now=1_000_000.0)
    resident = sorted(k for s in ring._shards for k in s._series)
    return resident, ring.stats()


@pytest.mark.parametrize("ring_bytes,budget", [(0, 48 * 1024), (8192, 48 * 1024), (8192, 1 << 20), (20000, 1 << 20)],
                         ids=["global-lru", "envelope-and-global", "envelope-8k", "envelope-20k"])
def test_ring_evictions_under_envelopes_as_jax(ring_bytes, budget):
    """The same pushes (the whale floods, quiet and unlabelled series
    trickle) leave the same resident keys, the same stats and the same
    per-tenant ledger in both packages, under the global LRU budget, the
    whale's envelope or both; under a roomy global budget the quiet tenant
    loses nothing to the whale's envelope."""
    rng = np.random.default_rng(11)
    pushes = []
    for i in range(260):
        t = "whale" if i % 10 else ("quiet" if i % 20 else "default-ish")
        key = f'up{{app="app{i}",namespace="t"' + (f',tenant="{t}"}}' if t != "default-ish" else "}")
        n = int(rng.integers(4, 40))
        ts = np.arange(0, 60 * n, 60, dtype=np.int64)
        pushes.append((key, ts, rng.normal(1, 0.1, n).astype(np.float32)))
    reg_t, reg_j = _reg(T, ring_bytes=ring_bytes), _reg(J, ring_bytes=ring_bytes)
    got = _ring_run(RingStore, canonical_series, reg_t, pushes, budget)
    want = _ring_run(JaxRing, jax_canonical, reg_j, pushes, budget)
    assert got == want
    snap = T.accounting_for(reg_t).snapshot()
    assert snap == J.accounting_for(reg_j).snapshot()
    assert got[1]["evictions"] > 0
    if ring_bytes and budget > 1 << 19:
        assert snap["whale"]["evictions"] > 0
        assert snap.get("quiet", {}).get("evictions", 0) == 0
        assert snap["whale"]["ring_bytes"] <= ring_bytes
        quiet = [canonical_series(k) for k, _, _ in pushes if 'tenant="quiet"' in k]
        assert set(quiet) <= set(got[0])


def test_ring_untenanted_parity():
    """Same pushes, no registry: the same residency and stats as a
    single-tenant registry (the parity pin at the ring seam)."""
    def build(tenancy):
        ring = RingStore(budget_bytes=4096, shards=2, tenancy=tenancy)
        ts = np.arange(0, 600, 60, dtype=np.int64)
        vs = np.ones(len(ts), np.float32)
        for i in range(40):
            ring.push(_series("x", i), ts, vs, now=1e6)
        return ring.stats(), sorted(k for s in ring._shards for k in s._series)

    assert build(None) == build(T.TenantRegistry({"only": T.TenantSpec(name="only")}))


def _arena_key(t: str, i: int) -> str:
    url = prometheus_url({"endpoint": "http://p/api/v1/", "query": f'up{{app="a{i}",tenant="{t}"}}',
                          "start": 0, "end": 600, "step": 60})
    return f"a{i}|up|{url}"


def _arena_rows(arena_cls, pkg, tenancy, seq):
    pkg.set_tenancy(tenancy)
    kw = {"device": "cpu"} if pkg is T else {}
    arena = arena_cls(4, max_bytes=1 << 14, **kw)
    out = [arena.assign(ks, force)[0].tolist() for ks, force in seq]
    qos = arena._qos
    return out, sorted(arena.rows.items()), arena.counters(), (dict(qos.rows) if qos is not None else None)


@pytest.mark.parametrize("arena_rows", [0, 4])
def test_arena_row_maps_as_jax(arena_rows):
    """The same assign sequence (a whale past its envelope, a quiet
    tenant, pads and transients, forced rescatters) gives both packages'
    arenas the same row maps, counters and per-tenant row counts."""
    from foremast_tpu.engine.arena import StateArena as JaxArena
    from foremast_tpu_torch.engine.arena import StateArena

    rng = np.random.default_rng(17)
    seq = [([_arena_key("quiet", i) for i in range(6)], [])]
    for rnd in range(5):
        keys = [_arena_key("whale", rnd * 8 + i) for i in range(8)] + [None, "__pad__0"]
        seq.append((keys, [int(rng.integers(8))]))
        seq.append(([_arena_key("quiet", i) for i in range(6)], []))
    got = _arena_rows(StateArena, T, _reg(T, arena_rows=arena_rows), seq)
    want = _arena_rows(JaxArena, J, _reg(J, arena_rows=arena_rows), seq)
    assert got == want
    assert got[3]["quiet"] == 6
    # a budget reorders recycling but never blocks a verdict: a batch of
    # 8 new whale keys gets 8 rows even past an envelope of 4, and later
    # batches recycle those; without the envelope the whale keeps 40 rows
    assert got[3]["whale"] == (8 if arena_rows else 40)


def test_arena_envelope_same_tenant_recycle():
    """An over-envelope tenant recycles its OWN least-recent rows; the
    quiet tenant's rows never move and every eviction is charged to the
    whale."""
    from foremast_tpu_torch.engine.arena import StateArena

    reg = _reg(T, arena_rows=4)
    T.set_tenancy(reg)
    arena = StateArena(4, max_bytes=1 << 16, device="cpu")
    assert arena._qos is not None
    first = arena.assign([_arena_key("quiet", i) for i in range(6)], [])[0].tolist()
    for rnd in range(4):
        arena.assign([_arena_key("whale", rnd * 8 + i) for i in range(8)], [])
        assert arena.assign([_arena_key("quiet", i) for i in range(6)], [])[0].tolist() == first
    assert arena._qos.rows["quiet"] == 6
    acct = T.accounting_for(reg).snapshot()
    assert acct["whale"]["evictions"] > 0
    assert acct.get("quiet", {}).get("evictions", 0) == 0
    arena.clear()
    assert arena._qos.rows == {} and arena._qos.of == {}


def test_arena_untenanted_and_single_tenant_parity():
    from foremast_tpu.engine.arena import StateArena as JaxArena
    from foremast_tpu_torch.engine.arena import StateArena, TreeArena

    seq = [([f"k{j}-{i}" for i in range(8)], []) for j in range(3)]
    single = T.TenantRegistry({"only": T.TenantSpec(name="only")})
    untenanted = _arena_rows(StateArena, T, None, seq)
    assert untenanted == _arena_rows(StateArena, T, single, seq)
    assert untenanted[:3] == _arena_rows(JaxArena, J, None, seq)[:3]
    T.set_tenancy(single)
    assert StateArena(4, device="cpu")._qos is None
    assert TreeArena({"w": ((2,), np.float32) and ((2,), __import__("torch").float32)}, device="cpu")._qos is None


# ---------------------------------------------------------------------------
# receiver fairness: 429 + Retry-After target the flooding tenant
# ---------------------------------------------------------------------------


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=json.dumps(payload).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = json.loads(e.read())
        return e.code, dict(e.headers), body


def _flood(start, stop, ring_cls, pkg):
    reg = _reg(pkg, ingest_bytes_per_s=1024)  # whale burst = 2 KiB
    ring = ring_cls(budget_bytes=1 << 20, shards=2, tenancy=reg)
    srv, _ = start(0, ring, host="127.0.0.1", tenancy=reg)
    port = srv.server_address[1]
    ts = list(range(0, 60 * 40, 60))

    def payload(tenant, i):
        return {"timeseries": [{"alias": _series(tenant, i), "times": ts, "values": [1.0] * len(ts)}]}

    try:
        whale = [_post(port, payload("whale", i)) for i in range(8)]  # ~25 KB against a 2 KiB burst
        quiet = [_post(port, payload("quiet", i)) for i in range(3)]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/state", timeout=10) as resp:
            state = json.load(resp)
    finally:
        stop(srv)
    return whale, quiet, pkg.accounting_for(reg).snapshot(), state


def test_receiver_sheds_flooding_tenant_only():
    from foremast_tpu.ingest import start_ingest_server as jax_start
    from foremast_tpu.ingest import stop_ingest_server as jax_stop

    got = _flood(start_ingest_server, stop_ingest_server, RingStore, T)
    want = _flood(jax_start, jax_stop, JaxRing, J)
    codes = [c for c, _, _ in got[0]]
    assert codes == [c for c, _, _ in want[0]]
    assert 429 in codes, codes
    for code, hdrs, body in got[0]:
        if code == 429:
            assert body == {"reason": "tenant over ingest envelope", "tenant": "whale"}
            assert 1 <= int(hdrs["Retry-After"]) <= 60
    assert [c for c, _, _ in got[1]] == [200, 200, 200]  # the quiet tenant passes, same socket
    assert got[2] == want[2]
    assert got[2]["whale"]["shed"] == codes.count(429)
    assert got[2].get("quiet", {}).get("shed", 0) == 0
    assert got[3]["tenants"]["accounting"]["whale"]["shed"] > 0
    assert set(got[3]["tenants"]) == set(want[3]["tenants"]) == {"registry", "accounting", "ingest_buckets"}
    assert list(got[3]["tenants"]["ingest_buckets"]) == ["whale"]


def test_governor_blame_targets_the_deepest_over_envelope_tenant():
    out = {}
    for name, pkg in PACKAGES.items():
        reg = pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale", ingest_bytes_per_s=1000),
                                  "mid": pkg.TenantSpec(name="mid", ingest_bytes_per_s=1000, burst_bytes=4000),
                                  "quiet": pkg.TenantSpec(name="quiet")})
        gov = pkg.IngestGovernor(reg)
        seq = [gov.admit("quiet", 10**6, 0.0), gov.admit("whale", 1500, 0.0), gov.admit("whale", 1500, 0.1),
               gov.admit("mid", 3000, 0.2), gov.blame(0.3), gov.admit("whale", 100, 5.0), gov.blame(5.0)]
        out[name] = (seq, gov.debug_state(5.0))
    assert out["port"] == out["jax"]
    # `mid` (a 4 KB burst, 3 KB spent) is a second further from half-full
    # than the whale
    assert out["port"][0][:3] == [0.0, 0.0, 1.0] and out["port"][0][4] == "mid"


# ---------------------------------------------------------------------------
# the worker: attribution, verdict latency, and verdicts unchanged
# ---------------------------------------------------------------------------


def test_verdict_latency_carries_tenant_label():
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.jobs.worker import _TickLedger
    from foremast_tpu_torch.observe.gauges import WorkerMetrics

    registry = CollectorRegistry()
    T.set_tenancy(T.TenantRegistry({"whale": T.TenantSpec(name="whale"), "quiet": T.TenantSpec(name="quiet")},
                                   label_max=1))
    w = BrainWorker(InMemoryStore(), PortArraySource({}), config=BrainConfig(), device="cpu",
                    metrics=WorkerMetrics(registry=registry))
    _, docs = _docs([(1, "whale"), (2, "quiet"), (3, "acme"), (4, "zeta"), (5, "zeta")])
    led = _TickLedger("micro", {d.app_name: time.time() - 0.5 for d in docs})
    w._observe_verdicts(docs, led)
    counts = {s.labels["tenant"]: s.value for m in registry.collect()
              if m.name == "foremast_verdict_latency_seconds" for s in m.samples if s.name.endswith("_count")}
    # configured tenants keep their label; one unconfigured value claims
    # the only slot, the rest fold into `other`
    assert counts == {"whale": 1.0, "quiet": 1.0, "acme": 1.0, "other": 2.0}
    w.close()
    T.set_tenancy(None)
    bare = CollectorRegistry()
    w = BrainWorker(InMemoryStore(), PortArraySource({}), config=BrainConfig(), device="cpu",
                    metrics=WorkerMetrics(registry=bare))
    w._observe_verdicts(docs[:1], _TickLedger("sweep", {"app1": time.time()}))
    assert [s.labels["tenant"] for m in bare.collect() if m.name == "foremast_verdict_latency_seconds"
            for s in m.samples if s.name.endswith("_count")] == ["default"]
    assert not any(m.name.startswith("foremast_tenant_") for m in bare.collect())
    w.close()


def test_worker_registers_tenant_collector_on_metrics_registry():
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.observe.gauges import WorkerMetrics

    T.set_tenancy(_reg(T))
    registry = CollectorRegistry()
    metrics = WorkerMetrics(registry=registry)
    w = BrainWorker(InMemoryStore(), PortArraySource({}), config=BrainConfig(), device="cpu", metrics=metrics)
    BrainWorker(InMemoryStore(), PortArraySource({}), config=BrainConfig(), device="cpu", metrics=metrics).close()
    w._tenant_acct.count_shed("whale")
    names = {m.name for m in registry.collect()}
    assert {"foremast_tenant_shed", "foremast_tenant_evictions", "foremast_tenant_claims",
            "foremast_tenant_ring_bytes"} <= names
    shed = [s for m in registry.collect() if m.name == "foremast_tenant_shed" for s in m.samples
            if s.labels.get("tenant") == "whale"]
    assert shed and shed[0].value == 1
    w.close()


_Q = re.compile(r"q=(\w+):app(\d+)&")


def _tenanted(store, source, tenant_of):
    """The fleet with each series' query a selector carrying its app's
    tenant label (URL-encoded, as a watcher writes it)."""
    def sub(m):
        app = int(m.group(2))
        sel = f'{m.group(1)}{{app="app{app}",tenant="{tenant_of(app)}"}}'
        return "q=" + urllib.request.quote(sel, safe="") + "&"

    for doc in store._docs.values():
        for f in ("historical_config", "current_config", "baseline_config"):
            if getattr(doc, f):
                setattr(doc, f, _Q.sub(sub, getattr(doc, f)))
    source.data = {_Q.sub(sub, u): v for u, v in source.data.items()}


def _fleet_run(pkg_name: str, tenancy, services: int, slice_docs: int, tenant_of):
    pkg = PACKAGES[pkg_name]
    pkg.set_tenancy(tenancy)
    store, source, _ = build_mixed_fleet(services, 256, 30, NOW, seed=1, baseline_frac=0.25)
    _tenanted(store, source, tenant_of)
    cfg = dict(algorithm="moving_average_all", season_steps=24, max_cache_size=4 * services + 64)
    kw = dict(claim_limit=services, worker_id="tenant-w", band_mode="last")
    if pkg_name == "port":
        from tests.torch_workers import port_store

        store = port_store(store)
        worker = BrainWorker(store, PortArraySource(source.data), config=BrainConfig(**cfg), device="cpu", **kw)
    else:
        worker = JaxWorker(store, source, config=JaxConfig(**cfg), device_mesh=None, **kw)
    worker.sweep_slice_docs = slice_docs
    slices: list = []
    orig = worker._prepare_slice

    def record(*a, **k):
        prep = orig(*a, **k)
        slices.append([d.id for d in prep.docs])
        return prep

    worker._prepare_slice = record
    ticks = []
    for k in range(2):
        worker.tick(now=NOW + 150 + 60 * k)
        ticks.append(sorted((d.id, d.status, d.status_code, d.reason, json.dumps(d.anomaly_info, sort_keys=True))
                            for d in store._docs.values()))
    state = worker.debug_state()
    worker.close()
    return ticks, slices, state


def test_tenanted_sliced_sweep_writes_as_untenanted_and_jax():
    """Tenancy reorders the slices and never changes a verdict: a fleet
    of one whale and two quiet tenants (weights 1, interleaved late in
    the claim order) swept in slices of 8 writes, cold and warm, what the
    untenanted sweep writes and what the JAX worker's tenanted sweep
    writes; every quiet doc is in the first slice, and the claims are
    charged per tenant."""
    services = 24

    def tenant_of(app):
        return "quiet-a" if app in (19, 21) else ("quiet-b" if app in (20, 22) else "whale")

    def reg(pkg):
        return pkg.TenantRegistry({n: pkg.TenantSpec(name=n, arena_rows=48 if n == "whale" else 0)
                                   for n in ("whale", "quiet-a", "quiet-b")})

    tenanted = _fleet_run("port", reg(T), services, 8, tenant_of)
    plain = _fleet_run("port", None, services, 8, tenant_of)
    jax = _fleet_run("jax", reg(J), services, 8, tenant_of)
    assert tenanted[0] == plain[0] == jax[0]
    assert tenanted[1] == jax[1]
    quiet = {f"job-{a}" for a in (19, 20, 21, 22)}
    first = set(tenanted[1][0])
    assert quiet <= first, tenanted[1][0]
    assert not quiet <= set(plain[1][0])  # untenanted: claim order
    acct = tenanted[2]["tenants"]["accounting"]
    assert {t: acct[t]["claims"] for t in acct} == {"whale": 40, "quiet-a": 4, "quiet-b": 4}
    assert acct == jax[2]["tenants"]["accounting"]
    assert plain[2]["tenants"] is None


def test_tenant_plane_loses_nothing_under_concurrent_marks_takes_and_charges():
    """Receiver threads mark tenanted series and charge the ledger while
    the tick thread takes fair drains: with more threads than cores and a
    tiny switch interval, every inserted key is taken exactly once and
    every charge lands in the ledger, past the label cap too."""
    import os
    import sys
    import threading

    reg = T.TenantRegistry({"whale": T.TenantSpec(name="whale", weight=2.0), "quiet": T.TenantSpec(name="quiet")},
                           label_max=4)
    acct = T.accounting_for(reg)
    n_threads, per_thread = 2 * (os.cpu_count() or 4) + 2, 300
    d = DirtySet(max_keys=n_threads * per_thread, tenancy=reg)
    taken: list = []
    done = threading.Event()

    def marker(t):
        tenant = ("whale", "quiet", f"u{t}")[t % 3]
        for i in range(per_thread):
            d.mark_series(canonical_series(f'up{{app="a{t}-{i}",tenant="{tenant}"}}'), now=float(i))
            acct.count_shed(tenant)
            acct.add_ring_bytes(tenant, 8)

    def taker():
        while not done.is_set():
            taken.extend(d.take(7))
        taken.extend(d.take_all())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=marker, args=(t,)) for t in range(n_threads)]
        drain = threading.Thread(target=taker)
        drain.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        done.set()
        drain.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not drain.is_alive() and not any(th.is_alive() for th in threads)
    keys = [k for k, _ in taken] + [k for k, _ in d.take_all()]
    assert sorted(keys) == sorted({f"a{t}-{i}" for t in range(n_threads) for i in range(per_thread)})
    snap = acct.snapshot()
    assert sum(v["shed"] for v in snap.values()) == n_threads * per_thread
    assert sum(v["ring_bytes"] for v in snap.values()) == 8 * n_threads * per_thread
    assert len(snap) <= len(reg.specs) + 1 + reg.label_max + 1  # configured, default, capped, `other`
