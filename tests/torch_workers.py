"""Shared fixtures of the port's worker parity tests: one fleet built with
`benchmarks.worker_bench` for the JAX worker, copied document by document
and series by series into the port's own store and source, and the
comparisons of what the two workers write.

The JAX worker runs single-device (`device_mesh=None`) so its arena
counters are comparable row for row; the port's runs on the CPU."""

from __future__ import annotations

import time

import numpy as np

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.ingest import canonical_series
from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
from foremast_tpu_torch.metrics.promql import prometheus_url
from foremast_tpu_torch.metrics.source import MetricSource
from tests.torch_fleet import BAND_TOL

NOW = 1_760_000_000.0
HIST_LEN = 512
CUR_LEN = 30


class PortArraySource(MetricSource):
    """The port's exact-match URL -> series map, holding copies of the
    JAX fleet's arrays (the same numbers, not the same buffers)."""

    concurrent_fetch = False

    def __init__(self, data):
        self.data = {u: (t.copy(), v.copy()) for u, (t, v) in data.items()}

    def fetch(self, url: str):
        return self.data[url]


def port_store(jax_store) -> InMemoryStore:
    """The port's store holding copies of every JAX document."""
    store = InMemoryStore()
    for doc in jax_store._docs.values():
        store.create(Document.from_json(doc.to_json()))
    return store


# the shapes a seasonal fleet's aliases carry (`seasonal_series`)
ALIAS_SHAPES = {"latency": "seasonal", "error4xx": "flat", "error5xx": "trend", "tps": "sharp"}


def seasonal_series(sources, m: int) -> None:
    """Give every alias of the fleet a structured signal of period `m`, in
    every source (the same arrays): histories are the alias's shape
    (`ALIAS_SHAPES`) plus noise, and current windows continue that signal
    at their true time with a small deterministic wiggle, so they sit
    well inside any fitted band and the fleet stays healthy; a canary's
    baseline is its current window plus small noise (same distribution:
    the rank tests hold)."""
    rng = np.random.default_rng(m)

    def signal(shape, t):
        if shape == "seasonal":
            return 1.0 + 0.5 * np.sin(2 * np.pi * t / m)
        if shape == "trend":
            return 1.0 + 0.0001 * t
        if shape == "sharp":
            return 1.0 + 0.5 * ((t % m) < max(2, m // 144))
        return 1.0 + 0.0 * t

    src0 = sources[0]
    for url in sorted(u for u in src0.data if u.startswith("http://prom/hist")):
        alias = url.split("?q=")[1].split(":")[0]
        ht, _ = src0.data[url]
        query = url.split("&end")[0].split("?")[1] + "&"  # q=<alias>:app<i>&
        cur_url = next(u for u in src0.data if u.startswith("http://prom/cur") and query in u)
        base_url = next((u for u in src0.data if u.startswith("http://prom/base") and query in u), None)
        ct, _ = src0.data[cur_url]
        hv = (signal(ALIAS_SHAPES[alias], np.arange(len(ht))) + rng.normal(0, 0.05, len(ht))).astype(np.float32)
        t_cur = len(ht) + (ct - ct[0]) // 60 + (int(ct[0]) - int(ht[-1])) // 60 - 1
        cv = (signal(ALIAS_SHAPES[alias], t_cur) + 0.01 * np.sin(np.arange(len(ct)) / 3.0)).astype(np.float32)
        for src in sources:
            src.data[url] = (ht.copy(), hv.copy())
            src.data[cur_url] = (ct.copy(), cv.copy())
        if base_url is not None:
            bt, _ = src0.data[base_url]
            bv = (cv + rng.normal(0, 0.01, len(cv))).astype(np.float32)
            for src in sources:
                src.data[base_url] = (bt.copy(), bv.copy())


def worker_pair(
    services: int,
    hist_len: int = HIST_LEN,
    cur_len: int = CUR_LEN,
    band_mode: str = "last",
    hooks=(None, None),
    baseline_frac: float = 0.0,
    seed: int = 0,
    algorithm: str = "moving_average_all",
    season_steps: int = 24,
    **worker_kw,
):
    """((JAX worker, store, source), (port worker, store, source)) over
    the same fleet: `services` docs × 4 aliases, re-check steady state,
    both judging with `algorithm` at `season_steps`."""
    store, source, _ = build_mixed_fleet(
        services, hist_len, cur_len, NOW, seed=seed, baseline_frac=baseline_frac
    )
    pstore, psource = port_store(store), PortArraySource(source.data)
    kw = dict(claim_limit=2 * services, worker_id="parity-w", band_mode=band_mode, **worker_kw)
    cfg = dict(algorithm=algorithm, season_steps=season_steps, max_cache_size=4 * services + 64)
    jax_worker = JaxWorker(
        store,
        source,
        config=JaxConfig(**cfg),
        on_verdict=hooks[0],
        device_mesh=None,
        **kw,
    )
    port = BrainWorker(
        pstore,
        psource,
        config=BrainConfig(**cfg),
        device="cpu",
        on_verdict=hooks[1],
        **kw,
    )
    return (jax_worker, store, source), (port, pstore, psource)


def statuses(store) -> dict:
    """doc id -> (status, status code, reason, anomaly_info)."""
    return {
        d.id: (d.status, d.status_code, d.reason, d.anomaly_info)
        for d in store._docs.values()
    }


def spike(sources, prefix: str, needle: str, points: int = 3, value: float = 40.0) -> None:
    """Set the last `points` values of the series whose URL starts with
    `prefix` and contains `needle`, in every source."""
    for src in sources:
        url = next(u for u in src.data if u.startswith(prefix) and needle in u)
        t, v = src.data[url]
        v = v.copy()
        v[-points:] = value
        src.data[url] = (t, v)


def count_columnar(worker) -> list:
    """Wrap the worker's univariate judge's `judge_columnar` with a call
    counter (the JAX worker's `_uni`, the port's `judge`)."""
    judge = getattr(worker, "_uni", None) or worker.judge
    calls = []
    orig = judge.judge_columnar

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    judge.judge_columnar = counting
    return calls


def force_slow(worker) -> None:
    worker._fast_tick = lambda docs, now: (0, docs)


def hook_recorder(records: list):
    """on_verdict hook appending one record per verdict."""

    def hook(doc, verdicts):
        for v in verdicts:
            records.append(
                (
                    doc.id,
                    v.alias,
                    int(v.verdict),
                    tuple(v.anomaly_pairs),
                    np.asarray(v.upper, np.float32),
                    np.asarray(v.lower, np.float32),
                    float(v.p_value),
                    bool(v.dist_differs),
                )
            )

    return hook


def assert_same_hook_records(got: list, want: list, tol: float = BAND_TOL[True]) -> None:
    """Verdicts, pairs and differs exact; bands within `tol` (same length);
    p within 1e-5. One documented exception (ROADMAP.md Queue 3): where
    the port's rank statistic is exactly 0 (p = 1), JAX's jitted program
    contracts it into fused multiply-adds and lands near 2e-5, moving p
    by up to 3e-3. The worker_bench canaries' baselines are the current
    signal plus small noise, so such ties occur on some rows; the
    decision (`dist_differs`) is exact there too."""
    assert len(got) == len(want)
    for g, w in zip(sorted(got, key=lambda r: r[:2]), sorted(want, key=lambda r: r[:2])):
        assert g[:4] == w[:4], (g[:4], w[:4])
        assert g[7] == w[7], g[:2]
        exact = abs(g[6] - w[6]) <= 1e-5 * (1 + abs(w[6]))
        assert exact or (g[6] == 1.0 and abs(g[6] - w[6]) <= 3e-3), (g[:2], g[6], w[6])
        for a, b in ((g[4], w[4]), (g[5], w[5])):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def ring_fleet(services: int, seed: int = 0, hist_len: int = 256, cur_len: int = CUR_LEN):
    """Docs (JSON) and series of a continuous-strategy fleet whose current
    and historical windows are the SAME series at different ranges, with
    query_range URLs that carry start and end, as the watcher builds
    them: {canonical key: (times, values)}, (ht, ct)."""
    rng = np.random.default_rng(seed)
    t_now = int(NOW)
    ht = t_now - 86_400 * 7 + 60 * np.arange(hist_len, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(cur_len, dtype=np.int64)
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_now + 3600))
    endpoint = "http://prom/api/v1/"
    data, docs = {}, []
    for s in range(services):
        expr = f'namespace_app_per_pod:latency{{namespace="ns",app="app{s}"}}'
        hv = rng.normal(1.0, 0.1, hist_len).astype(np.float32)
        cv = (1.0 + 0.05 * np.sin(np.arange(cur_len) / 3.0)).astype(np.float32)
        data[canonical_series(expr)] = (np.concatenate([ht, ct]), np.concatenate([hv, cv]))
        cur = prometheus_url({"endpoint": endpoint, "query": expr, "start": int(ct[0]), "end": int(ct[-1]),
                              "step": 60})
        hist = prometheus_url({"endpoint": endpoint, "query": expr, "start": int(ht[0]), "end": int(ht[-1]),
                               "step": 60})
        docs.append(Document(id=f"job-{s}", app_name=f"app{s}", end_time=end_time,
                             current_config=f"latency== {cur}", historical_config=f"latency== {hist}",
                             strategy="continuous").to_json())
    return docs, data, (ht, ct)


def _package(pkg: str):
    """(ingest module, Document, InMemoryStore, prometheus_url) of the JAX
    package ("jax") or the port ("port")."""
    if pkg == "jax":
        from foremast_tpu import ingest
        from foremast_tpu.jobs.models import Document as Doc
        from foremast_tpu.jobs.store import InMemoryStore as Store
        from foremast_tpu.metrics.promql import prometheus_url as purl
    else:
        from foremast_tpu_torch import ingest
        from foremast_tpu_torch.jobs.models import Document as Doc
        from foremast_tpu_torch.jobs.store import InMemoryStore as Store
        from foremast_tpu_torch.metrics.promql import prometheus_url as purl
    return ingest, Doc, Store, purl


def newcomer_fleet(pkg: str, push0, push_end, t1, floor, services: int = 1, stale: float = 300.0, seed: int = 7):
    """`tests/test_ingest.py`'s newcomer fleet, for either package ("jax"
    or "port") from the same seed: docs requesting a 7-day history ending
    at `t1` with only [push0, push_end] pushed (a newcomer's short life),
    in a pure-push ring (no fallback) with admission floor `floor`.
    Returns (store, ring, source)."""
    ing, Doc, Store, purl = _package(pkg)
    store = Store()
    ring = ing.RingStore(shards=1, stale_seconds=stale)
    t0 = t1 - 7 * 86_400
    cur_t1 = push_end - 60
    cur_t0 = cur_t1 - 28 * 60
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(int(NOW) + 3600))
    rng = np.random.default_rng(seed)
    for s in range(services):
        expr = f'namespace_app_per_pod:latency{{namespace="ns",app="new{s}"}}'
        pt = np.arange(int(push0), int(push_end) + 60, 60, dtype=np.int64)
        pv = rng.normal(1.0, 0.1, len(pt)).astype(np.float32)
        ring.push(ing.canonical_series(expr), pt, pv, now=NOW)
        cur = purl({"endpoint": "http://prom/api/v1/", "query": expr, "start": int(cur_t0), "end": int(cur_t1),
                    "step": 60})
        hist = purl({"endpoint": "http://prom/api/v1/", "query": expr, "start": int(t0), "end": int(t1), "step": 60})
        store.create(Doc(id=f"new-{s}", app_name=f"new{s}", end_time=end_time, current_config=f"latency== {cur}",
                         historical_config=f"latency== {hist}", strategy="continuous"))
    return store, ring, ing.RingSource(ring, fallback=None, admit_floor=floor)


def push_fleet(pkg: str, services: int, t_now: float = NOW, hist_len: int = 256, cur_len: int = 30,
               open_window: bool = False, expr: str = 'lat{{namespace="ns",app="app{s}"}}', seed: int = 0,
               **ring_kw):
    """`tests/test_reactive.py`'s pure-push fleet (and, with
    `open_window=True`, `benchmarks/latency_bench.py`'s, whose current
    windows stay open past `t_now`), for either package ("jax" or "port")
    from the same seed: docs in an InMemoryStore, histories and currents
    resident in a ring. Returns (store, ring, keys, ht, ct)."""
    ing, Doc, Store, purl = _package(pkg)
    rng = np.random.default_rng(seed)
    store = Store()
    ring = ing.RingStore(**(ring_kw or {"shards": 2}))
    t_now = int(t_now)
    ht = t_now - 86_400 * 7 + 60 * np.arange(hist_len, dtype=np.int64)
    if open_window:
        ct = t_now - 60 * cur_len + 60 * np.arange(cur_len, dtype=np.int64)
        cur_end, end_time = t_now + 7200, t_now + 7200
    else:
        ct = ht[-1] + 60 + 60 * np.arange(cur_len, dtype=np.int64)
        cur_end, end_time = int(ct[-1]), t_now + 3600
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(end_time))
    keys = []
    for s in range(services):
        e = expr.format(s=s)
        key = ing.canonical_series(e)
        keys.append(key)
        hv = rng.normal(1.0, 0.1, hist_len).astype(np.float32)
        ring.push(key, np.concatenate([ht, ct]), np.concatenate([hv, np.ones(cur_len, np.float32)]),
                  start=float(ht[0]), now=float(t_now))
        cur = purl({"endpoint": "http://p/api/v1/", "query": e, "start": int(ct[0]), "end": cur_end, "step": 60})
        hist = purl({"endpoint": "http://p/api/v1/", "query": e, "start": int(ht[0]), "end": int(ht[-1]),
                     "step": 60})
        store.create(Doc(id=f"job-{s}", app_name=f"app{s}", end_time=end_time, current_config=f"latency== {cur}",
                         historical_config=f"latency== {hist}", strategy="continuous"))
    return store, ring, keys, ht, ct
