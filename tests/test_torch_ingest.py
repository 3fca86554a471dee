"""The port's ingest plane (`foremast_tpu_torch/ingest/`) against the JAX
package's, on the same pushes made from numpy seeds: keys and URL
resolution agree, ring and store queries answer bit for bit alike
(status, times, values, coverage, counters), the receiver round trip, its
413 and its drain answer alike, and a worker fleet judged from pushed
samples (JSON and FMW1 through the receiver) writes the statuses the JAX
worker writes on the same pushes and the port's pull path writes on the
same samples. A pure-push source with an admission floor admits a
newcomer as a provisional fit as JAX's does; refinement has its own file,
`tests/test_torch_refine.py`."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from foremast_tpu import ingest as J
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs.models import Document as JaxDocument
from foremast_tpu.jobs.store import InMemoryStore as JaxStore
from foremast_tpu.jobs.worker import BrainWorker as JaxWorker
from foremast_tpu.metrics.promql import prometheus_url
from foremast_tpu.metrics.source import MetricSource as JaxMetricSource
from foremast_tpu_torch import ingest as T
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
from foremast_tpu_torch.jobs.models import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED
from foremast_tpu_torch.metrics.source import MetricSource, PrometheusSource
from tests.torch_workers import NOW, ring_fleet



@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _same_answer(got, want) -> None:
    """Two query answers (status, arrays..., extras) are bit-equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g.view(np.uint8), w.view(np.uint8))
        else:
            assert g == w


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

EXPRS = [
    'm{b="2",a="1"}', 'm{a="1",b="2"}', "sum(rate(x[5m]))", "plain_name", ' m { a = "x" , b=~"y.*" } ',
    'm{a="1",}', 'm{a="q\\"uote"}', "", "namespace_app_per_pod:latency", 'm{a="1" junk}',
]


@pytest.mark.parametrize("expr", EXPRS)
def test_canonical_series_equals_jax(expr):
    assert T.canonical_series(expr) == J.canonical_series(expr)
    assert T.canonical_series('m{b="2",a="1"}') == 'm{a="1",b="2"}'


@pytest.mark.parametrize(
    "labels",
    [{"__name__": "m", "a": "1", "b": "2"}, {"__name__": "m", "a": '1",b="2'}, {"__name__": "m"},
     {"__name__": "m", "z": "\\", "a": ""}],
)
def test_series_key_equals_jax_and_round_trips(labels):
    key = T.series_key(labels)
    assert key == J.series_key(labels)
    assert T.canonical_series(key) == key


@pytest.mark.parametrize(
    "url",
    [
        prometheus_url({"endpoint": "http://p/api/v1/", "query": 'm{b="2",a="1"}', "start": 100, "end": 200,
                        "step": 60}),
        "ts(cpu)&&100&&m&&200", "ts(cpu)&&100&&h&&4000", "ts(cpu)&&100&&s&&200", "ts(cpu)&&x",
        "http://p/other?x=1", "http://prom/hist?q=latency:app3&end=1759999940&step=60",
        "http://p/api/v1/query_range?query=m&start=2024-01-01T00:00:00Z&end=&step=",
    ],
)
def test_resolve_query_range_equals_jax(url):
    assert T.resolve_query_range(url) == J.resolve_query_range(url)


def test_resolve_query_range_shapes():
    url = prometheus_url({"endpoint": "http://p/api/v1/", "query": 'm{b="2",a="1"}', "start": 100, "end": 200,
                          "step": 60})
    assert T.resolve_query_range(url) == ('m{a="1",b="2"}', 100.0, 200.0, 60.0)
    key, t0, t1, _ = T.resolve_query_range("ts(cpu)&&100&&m&&200")
    assert (key, t0, t1) == ("ts(cpu)", 100.0, 200.0)
    assert T.resolve_query_range("http://p/other?x=1")[0] is None


def test_parse_push_labels_and_alias_forms_equal_jax():
    body = {
        "timeseries": [
            {"labels": {"__name__": "m", "app": "a"}, "samples": [[60, 1.5], [120, 2.5]], "start": 0},
            {"alias": 'q{b="2",a="1"}', "times": [60], "values": [9]},
            {"labels": [{"name": "__name__", "value": "p"}, {"name": "x", "value": "1"}], "samples": []},
        ]
    }
    got, want = T.parse_push(body), J.parse_push(body)
    assert [e[0] for e in got] == ['m{app="a"}', 'q{a="1",b="2"}', 'p{x="1"}'] == [e[0] for e in want]
    for g, w in zip(got, want):
        _same_answer(g[1:3], w[1:3])
        assert g[3] == w[3]


@pytest.mark.parametrize(
    "payload",
    [
        {"timeseries": [{"samples": [[1, 2]]}]},
        {"nope": []},
        [],
        {"timeseries": [{"labels": {"__name__": "x"}, "samples": [[1, 2]], "start": [1, 2]}]},
        {"timeseries": [{"labels": [["__name__", "x"]], "samples": [[1, 2]]}]},
        {"timeseries": [{"alias": "x", "samples": [{"t": 1}]}]},
        {"timeseries": [{"alias": "x", "times": [[1], [2]], "values": [[1], [2]]}]},
        {"timeseries": [{"labels": [{"name": "__name__", "value": "m"}, {"value": "x"}], "samples": [[1, 1.5]]}]},
        {"timeseries": [{"alias": "x"}]},
        {"timeseries": ["x"]},
    ],
)
def test_parse_push_malformed_shapes_raise_the_same_wire_error(payload):
    with pytest.raises(T.WireError) as got:
        T.parse_push(payload)
    with pytest.raises(J.WireError) as want:
        J.parse_push(payload)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ring + shards: bit-equal to JAX on the same operations
# ---------------------------------------------------------------------------


def _random_ops(seed: int, n: int = 60):
    """A sequence of pushes (ordered, overlapping, out of order, backfills
    with an asserted window, empty backfills) and reads on a few keys."""
    rng = np.random.default_rng(seed)
    ops, head = [], {k: 1_000 for k in ("a", "b", 'm{x="1"}')}
    for _ in range(n):
        key = str(rng.choice(list(head)))
        kind = rng.integers(0, 6)
        if kind <= 1:  # live push, strictly newer
            t = head[key] + 60 * np.arange(1, int(rng.integers(1, 400)) + 1)
            head[key] = int(t[-1])
            ops.append(("push", key, t.astype(np.int64), rng.normal(1, 0.2, len(t)).astype(np.float32), None, None))
        elif kind == 2:  # revision of old timestamps (merge, last write wins)
            t = head[key] - 60 * rng.integers(0, 50, int(rng.integers(1, 20)))
            ops.append(("push", key, t.astype(np.int64), rng.normal(5, 1, len(t)).astype(np.float32), None, None))
        elif kind == 3:  # backfill of a historical window, maybe empty
            t0 = head[key] - int(rng.integers(5_000, 400_000))
            t = t0 + 60 * np.arange(int(rng.integers(0, 200)))
            ops.append(("push", key, t.astype(np.int64), np.ones(len(t), np.float32), float(t0),
                        float(t0 + 60 * max(len(t) - 1, 0))))
        else:
            t1 = head[key] - int(rng.integers(0, 2_000))
            t0 = None if kind == 4 else t1 - int(rng.integers(60, 30_000))
            ops.append(("read", key, t0, float(t1), float(head[key] + rng.integers(0, 600))))
    return ops


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_points", [256, 4096])
def test_store_answers_bit_equal_to_jax(seed, max_points):
    stores = [m.RingStore(shards=2, max_points=max_points, stale_seconds=300.0, budget_bytes=1 << 20)
              for m in (T, J)]
    for op in _random_ops(seed):
        if op[0] == "push":
            _, key, t, v, start, end = op
            got = [s.push(key, t, v, start=start, end=end, now=NOW) for s in stores]
            assert got[0] == got[1]
            continue
        _, key, t0, t1, now = op
        for read in ("query", "hist_query", "coverage"):
            answers = [getattr(s, read)(key, t0, t1, now) for s in stores]
            _same_answer(*answers)
    st = [s.stats() for s in stores]
    for s in st:
        s.pop("last_push_at")
    assert st[0] == st[1]
    for i in range(2):
        state = [s.shard_state(i) for s in stores]
        assert len(state[0]) == len(state[1])
        for a, b in zip(*state):
            _same_answer(a, b)


def test_ring_wraparound_keeps_newest_and_advances_coverage():
    rings = [m.SeriesRing(capacity=4, max_points=8) for m in (T, J)]
    for r in rings:
        r.append(np.arange(20, dtype=np.int64), np.arange(20, dtype=np.float32), start=0.0)
    t, v = rings[0].window(None, None)
    assert t.tolist() == list(range(12, 20)) and v.tolist() == [float(x) for x in range(12, 20)]
    assert rings[0].covered_from == rings[1].covered_from == 12.0
    _same_answer(rings[0].window(13, 15), rings[1].window(13, 15))
    assert rings[0].window(13, 15)[0].tolist() == [13, 14, 15]


def test_ring_merge_sorts_and_dedups_last_wins():
    r = T.SeriesRing()
    r.append([10, 5, 5, 20], [1.0, 2.0, 3.0, 4.0])
    t, v = r.window(None, None)
    assert t.tolist() == [5, 10, 20] and v.tolist() == [3.0, 1.0, 4.0]
    r.append([10], [7.0])
    assert r.window(None, None)[1].tolist() == [3.0, 7.0, 4.0]


def test_store_eviction_under_budget_is_lru():
    s = T.RingStore(budget_bytes=2 * 3072, shards=1, max_points=256)
    for name in ("a", "b", "c"):
        s.push(name, np.arange(10, dtype=np.int64), np.zeros(10, np.float32), start=0.0, now=100.0)
    st = s.stats()
    assert st["evictions"] == 1 and st["series"] == 2
    assert s.query("a", 0, 9, now=100.0)[0] == "miss"
    assert s.query("b", 0, 9, now=100.0)[0] == "hit"  # a query refreshes recency
    s.push("d", np.arange(10, dtype=np.int64), np.zeros(10, np.float32), start=0.0, now=100.0)
    assert s.query("b", 0, 9, now=100.0)[0] == "hit"
    assert s.query("c", 0, 9, now=100.0)[0] == "miss"
    assert s.stats()["bytes"] <= s.budget_bytes


@pytest.mark.parametrize(
    "pushes,query,want",
    [
        # staleness: the window head beyond the newest sample by more than the cutoff
        ([("m", [1000, 1060, 1120], [1, 2, 3], 1000.0, None)], ("m", 1000, 2000, 2000.0), "stale"),
        ([("m", [1000, 1060, 1120], [1, 2, 3], 1000.0, None)], ("m", 1000, 1400, 1400.0), "hit"),
        # reaching back before the coverage watermark
        ([("m", [1000, 1060, 1120], [1, 2, 3], 1000.0, None)], ("m", 0, 1120, 1180.0), "uncovered"),
        # a window entirely past coverage is never an empty hit
        ([("m", [0, 60, 100], [1, 2, 3], 0.0, None)], ("m", 200, 300, 300.0), "stale"),
        # an out-of-order batch covers its min..max
        ([("m", [180, 60, 120], [3.0, 1.0, 2.0], None, None)], ("m", 60, 180, 200.0), "hit"),
        # an empty backfilled range stays authoritative under a later live push
        ([("m", [], [], 1000.0, 1100.0), ("m", [1160, 1220], [1.0, 2.0], None, None)], ("m", 1000, 1220, 1230.0),
         "hit"),
        ([], ("m2", 0, 600, 700.0), "miss"),
    ],
    ids=["stale", "fresh", "uncovered", "past_coverage", "unsorted", "empty_backfill", "miss"],
)
def test_staleness_and_coverage_cutoffs_equal_jax(pushes, query, want):
    stores = [m.RingStore(shards=1, stale_seconds=300.0) for m in (T, J)]
    for s in stores:
        for key, t, v, start, end in pushes:
            s.push(key, t, v, start=start, end=end, now=1100.0, record_lag=False)
    answers = [s.query(*query[:3], now=query[3]) for s in stores]
    _same_answer(*answers)
    assert answers[0][0] == want


def test_disjoint_backfills_do_not_claim_the_gap():
    stores = [m.RingStore(shards=1, stale_seconds=300.0) for m in (T, J)]
    now = 700_000.0
    cur_t = np.arange(699_000, 699_660, 60, dtype=np.int64)
    old_t = np.arange(0, 660, 60, dtype=np.int64)
    for s in stores:
        s.push("m", cur_t, np.ones(len(cur_t), np.float32), start=699_000.0, end=699_600.0, now=now,
               record_lag=False)
        s.push("m", old_t, np.ones(len(old_t), np.float32), start=0.0, end=600.0, now=now, record_lag=False)
    for q, want in (((699_000, 699_600), "hit"), ((0, 600), "hit"), ((60, 90_000), "stale"),
                    ((5_000, 90_000), "stale")):
        answers = [s.query("m", *q, now=now) for s in stores]
        _same_answer(*answers)
        assert answers[0][0] == want
    assert stores[0].query("m", 0, 600, now=now)[1].tolist() == old_t.tolist()


def test_backfill_does_not_report_receiver_lag():
    s = T.RingStore(shards=1)
    old = np.arange(0, 600, 60, dtype=np.int64)
    T.backfill(s, "m", (old, np.ones(len(old), np.float32)), start=0.0, end=600.0, now=700_000.0)
    assert s.stats()["receiver_lag_seconds"] is None
    s.push("m", [700_000], [1.0], now=700_030.0)
    assert s.stats()["receiver_lag_seconds"] == 30.0


def test_store_refuses_tenancy(monkeypatch):
    """The tenant plane replaced the old refusal: a store given a registry,
    or built from the env under `FOREMAST_TENANTS`, carries its per-tenant
    envelopes; without one it stays untenanted. The env sizing knobs read
    as before."""
    from foremast_tpu_torch.tenant import TenantRegistry, TenantSpec
    from foremast_tpu_torch.tenant import registry as treg

    reg = TenantRegistry({"a": TenantSpec(name="a", ring_bytes=4096), "b": TenantSpec(name="b")})
    assert T.RingStore(tenancy=reg, shards=2).tenancy.shard_envelope("a") == 2048
    assert T.RingStore().tenancy is None
    monkeypatch.setenv("FOREMAST_TENANTS", '{"tenants": {"a": {"ring_bytes": 4096}, "b": {}}}')
    monkeypatch.setattr(treg, "_GLOBAL", None)
    monkeypatch.setattr(treg, "_GLOBAL_SET", False)
    env_store = T.RingStore.from_env({"FOREMAST_INGEST_SHARDS": "4"})
    assert env_store.tenancy.registry.spec("a").ring_bytes == 4096
    assert env_store.tenancy.shard_envelope("a") == 1024
    monkeypatch.setattr(treg, "_GLOBAL", None)
    monkeypatch.setattr(treg, "_GLOBAL_SET", True)
    s = T.RingStore.from_env({"FOREMAST_INGEST_SHARDS": "3", "FOREMAST_INGEST_BUDGET_BYTES": "4096",
                              "FOREMAST_INGEST_STALE_SECONDS": "60", "FOREMAST_INGEST_MAX_POINTS": "512"})
    assert (s.shard_count, s.budget_bytes, s.stale_seconds, s.max_points) == (3, 4096, 60.0, 512)
    assert s.tenancy is None


def test_shard_lock_concurrency_smoke():
    s = T.RingStore(shards=4, max_points=512)
    n_threads, pushes = 8, 50
    errors = []

    def worker(i):
        try:
            for k in range(pushes):
                t0 = 60 * k
                s.push(f"series-{i % 4}", [t0, t0 + 30], [float(i), float(k)], start=0.0, now=float(t0 + 30))
                s.query(f"series-{i % 4}", 0, t0 + 30, now=float(t0 + 30))
        except Exception as e:  # noqa: BLE001 - the test is the guard
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    st = s.stats()
    assert st["samples"] == n_threads * pushes * 2 and st["series"] == 4


# ---------------------------------------------------------------------------
# RingSource
# ---------------------------------------------------------------------------


class WindowedSource(MetricSource):
    """What a real Prometheus returns for these URLs: the sample slice
    [start, end] of the series the query names."""

    concurrent_fetch = False

    def __init__(self, data=None):
        self.data: dict[str, tuple[np.ndarray, np.ndarray]] = dict(data or {})
        self.calls: list[str] = []

    def fetch(self, url: str):
        key, t0, t1, _ = T.resolve_query_range(url)
        self.calls.append(url)
        t, v = self.data[key]
        lo = 0 if t0 is None else int(np.searchsorted(t, t0, side="left"))
        hi = len(t) if t1 is None else int(np.searchsorted(t, t1, side="right"))
        return t[lo:hi].copy(), v[lo:hi].copy()


class JaxWindowedSource(JaxMetricSource):
    """The same for the JAX worker, over copies of the same arrays."""

    concurrent_fetch = False

    def __init__(self, data):
        self.inner = WindowedSource({k: (t.copy(), v.copy()) for k, (t, v) in data.items()})

    def fetch(self, url: str):
        return self.inner.fetch(url)


class _NoHTTPSession:
    """Any GET through it fails the test: the read must be ring-served."""

    def get(self, url, timeout=None):
        raise AssertionError(f"HTTP fetch attempted: {url}")


def test_empty_backfills_warm_and_serve_empty_hits():
    for url in ("http://p/api/v1/query_range?query=m&end=1100&step=60",
                "http://p/api/v1/query_range?query=m&start=1000&end=1100&step=60"):
        feed = WindowedSource({"m": (np.zeros(0, np.int64), np.zeros(0, np.float32))})
        source = T.RingSource(T.RingStore(shards=1, stale_seconds=300.0), fallback=feed, clock=lambda: 1200.0)
        for _ in range(3):
            assert len(source.fetch(url)[0]) == 0
        assert len(feed.calls) == 1


def test_stale_ring_degrades_to_fallback():
    t = np.arange(0, 6000, 60, dtype=np.int64)
    feed = WindowedSource({"m": (t, np.ones(len(t), np.float32))})
    ring = T.RingStore(shards=1, stale_seconds=300.0)
    ring.push("m", t[t <= 1200], np.ones(21, np.float32), start=0.0, now=1200.0)  # the pusher died at 1200
    source = T.RingSource(ring, fallback=feed, clock=lambda: 6000.0)
    url = "http://p/api/v1/query_range?query=m&start=0&end=5940&step=60"
    assert source.fetch(url)[0].tolist() == t.tolist() and len(feed.calls) == 1
    assert source.fetch(url)[0].tolist() == t.tolist() and len(feed.calls) == 1  # the backfill re-warmed it


def test_ring_source_concurrent_fetch_follows_fallback():
    ring = T.RingStore(shards=1)
    assert T.RingSource(ring, fallback=None).concurrent_fetch is False
    assert T.RingSource(ring, fallback=WindowedSource()).concurrent_fetch is False
    assert T.RingSource(ring, fallback=PrometheusSource(session=_NoHTTPSession())).concurrent_fetch is True


def test_fallback_cold_fit_counts_miss_once():
    expr = 'namespace_app_per_pod:latency{namespace="ns",app="mc"}'
    key = T.canonical_series(expr)
    t = np.arange(0, 6000, 60, dtype=np.int64)
    feed = WindowedSource({key: (t, np.ones(len(t), np.float32))})
    src = T.RingSource(T.RingStore(shards=1, stale_seconds=300.0), fallback=feed, clock=lambda: 6000.0)
    url = prometheus_url({"endpoint": "http://prom", "query": expr, "start": 0, "end": 3000, "step": 60})
    assert src.hist_columns(url, now=6000.0) is None
    src.fetch(url)
    stats = src.ring.stats()
    assert stats["misses"] == 1 and stats["uncovered"] == 0 and stats["stale"] == 0
    assert len(feed.calls) == 1
    snap = src.book.snapshot()
    assert snap["total"] == 1 and snap["recent"][key]["misses"] == 1


def test_partial_admission_is_pure_push_only_as_in_jax():
    t_full = np.arange(0, 60_000, 60, dtype=np.int64)
    live = t_full[t_full >= 50_000]
    url = "http://p/api/v1/query_range?query=m&start=0&end=59940&step=60"
    got = {}
    for name, m in (("port", T), ("jax", J)):
        feed = WindowedSource({"m": (t_full, np.ones(len(t_full), np.float32))})
        ring = m.RingStore(shards=1, stale_seconds=300.0)
        ring.push("m", live, np.ones(len(live), np.float32), now=60_000.0)
        pure = m.RingSource(ring, fallback=None, clock=lambda: 60_000.0, admit_floor=600.0)
        hybrid = m.RingSource(ring, fallback=feed, clock=lambda: 60_000.0, admit_floor=600.0)
        got[name] = [pure.hist_columns(url), hybrid.hist_columns(url), hybrid.fetch(url), hybrid.hist_columns(url),
                     len(feed.calls)]
    port, jax = got["port"], got["jax"]
    assert port[0][0] == "partial" and port[1] is None and port[3][0] == "full" and port[4] == 1
    for g, w in zip(port[:4], jax[:4]):
        if w is None:
            assert g is None
        else:
            _same_answer(g, w)


def test_pure_push_with_an_admission_floor_admits_provisional_fits_as_jax():
    """A pure-push source with a positive floor judges a newcomer with
    short coverage on its first tick from a provisional fit (one
    `ring_partial` read, one refine record), writing what the JAX worker
    writes."""
    from tests.torch_workers import newcomer_fleet

    base = int(NOW)
    (jstore, _, jsrc), (store, _, src) = (newcomer_fleet(pkg, base - 8200, base - 1200, base - 1000, 3600.0)
                                          for pkg in ("jax", "port"))
    jworker = JaxWorker(jstore, jsrc, config=JaxConfig(), claim_limit=4, device_mesh=None)
    worker = BrainWorker(store, src, config=BrainConfig(), device="cpu", claim_limit=4)
    assert jworker.tick(now=NOW + 150) == worker.tick(now=NOW + 150) == 1
    assert _statuses(store) == _statuses(jstore)
    assert json.loads(_statuses(store)["new-0"])[0] == STATUS_PREPROCESS_COMPLETED
    cs = worker.debug_state()["cold_start"]
    assert cs["hist_reads"] == jworker.debug_state()["cold_start"]["hist_reads"]
    assert cs["hist_reads"]["ring_partial"] == 1 and cs["refine"]["pending"] == 1


# ---------------------------------------------------------------------------
# receiver
# ---------------------------------------------------------------------------


def _post(port, body: bytes, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=body, method="POST")
    req.add_header("Content-Type", ctype)
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_receiver_push_roundtrip_and_rejection_equal_jax():
    body = json.dumps({"timeseries": [{"labels": {"__name__": "m", "app": "a"}, "samples": [[60, 1.5], [120, 2.5]],
                                       "start": 0}]}).encode()
    bad = b'{"timeseries": [{"samples": [[1, 2]]}]}'
    got = {}
    for name, m in (("port", T), ("jax", J)):
        store = m.RingStore(shards=2)
        srv, _ = m.start_ingest_server(0, store, host="127.0.0.1")
        try:
            port = srv.server_address[1]
            answers = [_post(port, body), _post(port, bad)]
            state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/state", timeout=10).read())
            health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10).read())
            got[name] = (answers, store.query('m{app="a"}', 0, 120, now=150.0), state, health)
        finally:
            m.stop_ingest_server(srv)
    (answers, query, state, health), jax = got["port"], got["jax"]
    assert answers == jax[0]
    assert answers[0] == (200, {"accepted_samples": 2, "series": 1}) and answers[1][0] == 400
    _same_answer(query, jax[1])
    assert query[0] == "hit"
    assert state["series"] == 1 and state["samples"] == 2 and state["receiver_lag_seconds"] is not None
    assert {k for k in state if k != "wire"} == {k for k in jax[2] if k != "wire"}
    assert health["ok"] is True


def test_receiver_rejects_oversized_body_with_413():
    big = json.dumps({"timeseries": [{"alias": "big_series", "times": list(range(60, 60 * 200, 60)),
                                      "values": [1.0] * 199}]}).encode()
    small = json.dumps({"timeseries": [{"alias": "s", "times": [60], "values": [1.0]}]}).encode()
    assert len(big) > 256
    got = {}
    for name, m in (("port", T), ("jax", J)):
        store = m.RingStore(shards=1)
        srv, _ = m.start_ingest_server(0, store, host="127.0.0.1", max_body_bytes=256)
        try:
            port = srv.server_address[1]
            got[name] = (_post(port, big), store.stats()["series"], _post(port, small))
        finally:
            m.stop_ingest_server(srv)
    assert got["port"] == got["jax"]
    (code, out), series, ok = got["port"]
    assert code == 413 and "cap" in out["reason"] and series == 0 and ok[0] == 200


def test_receiver_sheds_past_the_inflight_cap():
    store = T.RingStore(shards=1)
    srv, _ = T.start_ingest_server(0, store, host="127.0.0.1", max_inflight=1)
    try:
        inflight = srv._foremast_inflight
        with inflight:  # a handler already in flight
            with inflight:
                code, out = _post(srv.server_address[1], b'{"timeseries": []}')
        assert code == 429 and "overloaded" in out["reason"]
        # the shed handler leaves the count only after its answer is on
        # the wire: wait for it, then the receiver takes pushes again
        deadline = time.monotonic() + 10
        while inflight.count and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _post(srv.server_address[1], b'{"timeseries": []}')[0] == 200
    finally:
        T.stop_ingest_server(srv)


def test_receiver_graceful_drain_on_close():
    import socket

    srv, thread = T.start_ingest_server(0, T.RingStore(shards=1), host="127.0.0.1")
    port = srv.server_address[1]
    assert srv.daemon_threads is True
    assert T.stop_ingest_server(srv, drain_seconds=5.0) is True
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    with pytest.raises((ConnectionError, urllib.error.URLError, OSError)):
        urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=b"{}",
                                                      method="POST"), timeout=2.0)
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))  # the port is free at once
    finally:
        s.close()


# ---------------------------------------------------------------------------
# worker ticks from the ring
# ---------------------------------------------------------------------------


def _cfg(services):
    return dict(algorithm="moving_average_all", season_steps=24, max_cache_size=services + 16)


def _port_worker(docs, source, services):
    store = InMemoryStore()
    for d in docs:
        store.create(Document.from_json(d))
    return BrainWorker(store, source, config=BrainConfig(**_cfg(services)), device="cpu",
                       claim_limit=max(services, 4), worker_id="ingest-w"), store


def _jax_worker(docs, source, services):
    store = JaxStore()
    for d in docs:
        store.create(JaxDocument.from_json(d))
    return JaxWorker(store, source, config=JaxConfig(**_cfg(services)), device_mesh=None,
                     claim_limit=max(services, 4), worker_id="ingest-w"), store


def _statuses(store) -> dict:
    return {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
            for d in store._docs.values()}


def _push_body(codec: str, entries) -> tuple[bytes, str]:
    if codec == "fmw1":
        return T.encode_frame(entries), T.BINARY_CONTENT_TYPE
    return json.dumps({"timeseries": [{"alias": k, "times": t.tolist(), "values": v.tolist(),
                                       **({"start": s} if s is not None else {})}
                                      for k, t, v, s in entries]}).encode(), "application/json"


@pytest.mark.parametrize("codec", ["json", "fmw1"])
def test_worker_ticks_judged_from_pushes_equal_jax_and_pull(codec):
    """Every window of a cold tick, a warm tick and a spiked warm tick
    comes from samples pushed through the port's receiver (a fallback
    that fails on any GET); the statuses equal the JAX worker's on the
    same pushes and the port's pull worker's on the same samples."""
    services = 5
    docs, data, (ht, ct) = ring_fleet(services)
    entries = [(k, t, v, float(ht[0])) for k, (t, v) in data.items()]
    ring = T.RingStore(shards=4)
    srv, _ = T.start_ingest_server(0, ring, host="127.0.0.1")
    jring = J.RingStore(shards=4)
    jring.push_batch(entries)
    try:
        port = srv.server_address[1]
        assert _post(port, *_push_body(codec, entries))[0] == 200
        fallback = PrometheusSource(session=_NoHTTPSession(), retries=0)
        push_w, push_store = _port_worker(docs, T.RingSource(ring, fallback=fallback), services)
        pull_w, pull_store = _port_worker(docs, WindowedSource(data), services)
        jsrc = JaxWindowedSource(data)
        jax_w, jax_store = _jax_worker(docs, J.RingSource(jring, fallback=jsrc), services)
        workers = ((push_w, push_store), (pull_w, pull_store), (jax_w, jax_store))
        for now in (NOW + 150, NOW + 200):
            for w, _ in workers:
                assert w.tick(now=now) == services
            got = [_statuses(st) for _, st in workers]
            assert got[0] == got[1] == got[2]
        assert all(json.loads(v)[0] == STATUS_PREPROCESS_COMPLETED for v in got[0].values())
        stats = ring.stats()
        assert stats["misses"] == stats["stale"] == stats["uncovered"] == 0 and stats["hits"] >= 2 * services
        assert push_w.debug_state()["cold_start"]["hist_reads"]["ring_full"] == services
        # spike one service by a revising push (last write wins) and the
        # same samples in the pull feeds
        key = T.canonical_series('namespace_app_per_pod:latency{namespace="ns",app="app2"}')
        t, v = data[key]
        spiked = v.copy()
        spiked[-3:] = 40.0
        assert _post(port, *_push_body(codec, [(key, ct[-3:], spiked[-3:], None)]))[0] == 200
        jring.push(key, ct[-3:], spiked[-3:], now=NOW)
        pull_w.source.data[key] = (t, spiked)
        jsrc.inner.data[key] = (t, spiked)
        for w, _ in workers:
            assert w.tick(now=NOW + 300) == services
        got = [_statuses(st) for _, st in workers]
        assert got[0] == got[1] == got[2]
        assert json.loads(got[0]["job-2"])[0] == STATUS_COMPLETED_UNHEALTH
        assert jsrc.inner.calls == []  # the JAX worker read its ring too
    finally:
        T.stop_ingest_server(srv)


def test_cold_miss_falls_back_then_next_tick_is_warm():
    services = 4
    docs, data, _ = ring_fleet(services)
    feed = WindowedSource(data)
    source = T.RingSource(T.RingStore(shards=2), fallback=feed)
    worker, _ = _port_worker(docs, source, services)
    assert worker.tick(now=NOW + 150) == services
    calls_cold = len(feed.calls)
    assert calls_cold >= 2 * services
    assert len(source.book) == services and source.ring.stats()["series"] == services
    assert worker.tick(now=NOW + 300) == services
    assert len(feed.calls) == calls_cold  # current windows from the backfilled ring
    state = source.ingest_debug_state()
    assert state["subscriptions"]["total"] == services and state["fallback"] == "WindowedSource"


def test_fallback_fill_makes_the_next_cold_fit_zero_http():
    """A cold miss's fallback fetch of a historical range backfills the
    ring, and that span survives a later disjoint live push: the second
    cold fit of the same series reads resident columns."""
    docs, data, (ht, _) = ring_fleet(1)
    feed = WindowedSource(data)
    source = T.RingSource(T.RingStore(shards=1), fallback=feed)
    worker, store = _port_worker(docs, source, 2)
    assert worker.tick(now=NOW + 150) == 1
    hist_marker = f"start={int(ht[0])}"
    assert sum(hist_marker in u for u in feed.calls) == 1
    key = T.canonical_series('namespace_app_per_pod:latency{namespace="ns",app="app0"}')
    source.ring.push(key, np.asarray([int(NOW)], np.int64), np.ones(1, np.float32), now=NOW)
    proto = next(iter(store._docs.values()))
    store.create(Document(id="job-b", app_name="app0", end_time=proto.end_time,
                          current_config=proto.current_config.replace("latency== ", "latencyb== "),
                          historical_config=proto.historical_config.replace("latency== ", "latencyb== "),
                          strategy="continuous"))
    assert worker.tick(now=NOW + 300) == 2
    assert sum(hist_marker in u for u in feed.calls) == 1
    reads = worker.debug_state()["cold_start"]["hist_reads"]
    assert reads["ring_full"] == 1 and reads["http"] == 1


def test_hist_cache_bypassed_and_shrunk_with_ring_source():
    docs, data, (ht, _) = ring_fleet(1)
    feed = WindowedSource(data)
    ring = T.RingStore(shards=1)
    ring.push_batch([(k, t, v, float(ht[0])) for k, (t, v) in data.items()])
    worker, _ = _port_worker(docs, T.RingSource(ring, fallback=feed), 1)
    assert worker.tick(now=NOW + 150) == 1
    cs = worker.debug_state()["cold_start"]
    assert cs["hist_bypass"] is True and cs["hist_cache_cap"] == 16  # max(8, 256 // 16)
    assert cs["hist_reads"]["ring_full"] == 1 and cs["hist_reads"]["http"] == 0
    assert len(worker._hist_cache) == 0 and feed.calls == []
    pull, _ = _port_worker(docs, feed, 1)
    cs = pull.debug_state()["cold_start"]
    assert cs["hist_bypass"] is False and cs["hist_cache_cap"] == 256


def test_debug_state_ingest_and_cold_start_sections_match_jax():
    services = 2
    docs, data, (ht, _) = ring_fleet(services)
    entries = [(k, t, v, float(ht[0])) for k, (t, v) in data.items()]
    ring, jring = T.RingStore(shards=2), J.RingStore(shards=2)
    ring.push_batch(entries, now=NOW)
    jring.push_batch(entries, now=NOW)
    worker, _ = _port_worker(docs, T.RingSource(ring, fallback=WindowedSource(data)), services)
    jworker, _ = _jax_worker(docs, J.RingSource(jring, fallback=JaxWindowedSource(data)), services)
    worker.tick(now=NOW + 150)
    jworker.tick(now=NOW + 150)
    state, jstate = worker.debug_state(), jworker.debug_state()
    ing, jing = state["ingest"], jstate["ingest"]
    assert {k: v for k, v in ing.items() if k != "fallback"} == {k: v for k, v in jing.items() if k != "fallback"}
    assert (ing["fallback"], jing["fallback"]) == ("WindowedSource", "JaxWindowedSource")
    assert ing["series"] == services and ing["bytes"] > 0 and ing["hit_ratio"] == 1.0
    cs, jcs = state["cold_start"], jstate["cold_start"]
    assert {k: cs[k] for k in ("hist_bypass", "hist_cache_cap", "hist_reads", "admit_floor_seconds")} == {
        k: jcs[k] for k in ("hist_bypass", "hist_cache_cap", "hist_reads", "admit_floor_seconds")}
    pull, _ = _port_worker(docs, WindowedSource(data), services)
    assert pull.debug_state()["ingest"] is None


def test_pure_push_fleet_at_a_zero_floor_equals_jax():
    """No fallback and admission off: a covered series judges from the
    ring, an unpushed one reads empty (UNKNOWN) and counts "unserved",
    never "http" or "cache", on both packages."""
    services = 3
    docs, data, (ht, _) = ring_fleet(services)
    entries = [(k, t, v, float(ht[0])) for k, (t, v) in data.items() if 'app="app1"' not in k]
    ring, jring = T.RingStore(shards=2), J.RingStore(shards=2)
    ring.push_batch(entries, now=NOW)
    jring.push_batch(entries, now=NOW)
    worker, store = _port_worker(docs, T.RingSource(ring, fallback=None, admit_floor=0.0), services)
    jworker, jstore = _jax_worker(docs, J.RingSource(jring, fallback=None, admit_floor=0.0), services)
    for now in (NOW + 150, NOW + 200):
        worker.tick(now=now)
        jworker.tick(now=now)
        assert _statuses(store) == _statuses(jstore)
    reads = worker.debug_state()["cold_start"]["hist_reads"]
    assert reads == jworker.debug_state()["cold_start"]["hist_reads"]
    assert reads["unserved"] >= 1 and reads["http"] == reads["cache"] == 0 and reads["ring_full"] == 2
