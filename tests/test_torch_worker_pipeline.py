"""The port worker's slow-path chunk pipeline and graceful degradation,
against the JAX worker where both run: pipelined equals serial on a mixed
warm/cold claim, fetch-failure isolation mid-pipeline, clean drain after
a judge exception, `StageError` partial writes, the write-behind buffer,
a store outage mid warm tick, claim outages, transient fetch releases and
the tick budget. Modeled on `tests/test_worker_pipeline.py` and
`tests/test_chaos.py`."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from benchmarks.worker_bench import _add_service
from foremast_tpu_torch.chaos import Degradation, WriteBehindBuffer, is_transient_error
from foremast_tpu_torch.chaos.breaker import BreakerOpen, CircuitBreaker
from foremast_tpu_torch.chaos.degrade import (
    REASON_BUFFERED,
    REASON_DEADLINE,
    REASON_DROPPED_AGE,
    REASON_FETCH,
    REASON_REPLAYED,
)
from foremast_tpu_torch.jobs import (
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_FAILED,
    STATUS_PREPROCESS_INPROGRESS,
    Document,
)
from foremast_tpu_torch.jobs.pipeline import ChunkPipeline, StageError
from tests.torch_workers import CUR_LEN, NOW, force_slow, statuses, worker_pair

HIST_LEN = 256


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _pair(services, chunk_docs=2, depth=2, **kw):
    """JAX and port workers with the slow path forced and a source that
    poses as blocking, so the pipeline engages."""
    (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(services, hist_len=HIST_LEN, **kw)
    for w, src in ((jw, jsrc), (pw, psrc)):
        src.concurrent_fetch = True
        w.cold_chunk_docs = chunk_docs
        w.pipeline_depth = depth
        force_slow(w)
    return (jw, jstore, jsrc), (pw, pstore, psrc)


def _grow_fleet(pairs, sids, seed=42):
    """Add the same fresh (cold) services to the JAX fleet and the port's."""
    t_now = int(NOW)
    ht = t_now - 86_400 * 7 + 60 * np.arange(HIST_LEN, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(CUR_LEN, dtype=np.int64)
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_now + 3600))
    jstore, jsrc, pstore, psrc = pairs
    rng = np.random.default_rng(seed)
    for sid in sids:
        doc_id, urls = _add_service(jstore, jsrc, sid, ht, ct, HIST_LEN, CUR_LEN, end_time, rng)
        pstore.create(Document.from_json(jstore.get(doc_id).to_json()))
        for u in urls:
            t, v = jsrc.data[u]
            psrc.data[u] = (t.copy(), v.copy())


def _record_writes(store):
    writes = []
    orig_update, orig_many = store.update, store.update_many

    def _u(doc):
        writes.append((doc.id, doc.status))
        return orig_update(doc)

    def _um(docs):
        writes.extend((d.id, d.status) for d in docs)
        return orig_many(docs)

    store.update, store.update_many = _u, _um
    return writes


def test_pipelined_equals_serial_and_jax_on_mixed_warm_cold_claims():
    """Tick 1 warms 6 services; 4 cold services join and a warm doc
    spikes; tick 2's claim is mixed warm/cold over 5 chunks. The
    pipelined port worker writes the same statuses, in the same order,
    with the same hook verdicts and fit keys, as the serial one — and
    the same statuses as the pipelined JAX worker."""
    va, vb = [], []
    (jw, jstore, jsrc), (a, a_store, a_src) = _pair(
        6, depth=2, hooks=(None, lambda d, vs: va.append((d.id, [(v.alias, v.verdict) for v in vs])))
    )
    _, (b, b_store, b_src) = _pair(
        6, depth=1, hooks=(None, lambda d, vs: vb.append((d.id, [(v.alias, v.verdict) for v in vs])))
    )
    for w in (jw, a, b):
        assert w.tick(now=NOW + 150) == 6
    assert statuses(a_store) == statuses(b_store) == statuses(jstore)

    _grow_fleet((jstore, jsrc, a_store, a_src), ["n0", "n1", "n2", "n3"])
    _grow_fleet((jstore, jsrc, b_store, b_src), ["n0", "n1", "n2", "n3"])
    for src in (jsrc, a_src, b_src):
        url = next(u for u in src.data if "cur" in u and "latency:app2&" in u)
        t, v = src.data[url]
        v = v.copy()
        v[-3:] = 40.0
        src.data[url] = (t, v)
    writes_a, writes_b = _record_writes(a_store), _record_writes(b_store)
    for w in (jw, a, b):
        assert w.tick(now=NOW + 200) == 10
    assert a._last_pipeline["pipelined"] is True and a._last_pipeline["chunks"] == 5
    assert b._last_pipeline["pipelined"] is False
    assert statuses(a_store) == statuses(b_store) == statuses(jstore)
    assert writes_a == writes_b
    assert va == vb
    keys = sorted(map(str, a._fit_cache._d))
    assert keys and keys == sorted(map(str, b._fit_cache._d))
    assert a._uni.device_state_counters() == jw._uni.device_state_counters()
    for w in (jw, a, b):
        w.close()


def test_fetch_failure_marks_only_its_doc_mid_pipeline():
    _, (worker, store, source) = _pair(8)
    orig = source.fetch

    def fetch(url):
        if "latency:app5&" in url and "cur" in url:
            raise RuntimeError("boom")
        return orig(url)

    source.fetch = fetch
    assert worker.tick(now=NOW + 150) == 8
    assert worker._last_pipeline["pipelined"] is True
    sts = {d.id: d.status for d in store._docs.values()}
    assert sts.pop("job-5") == STATUS_PREPROCESS_FAILED
    assert store.get("job-5").reason == "metric fetch failed"
    assert set(sts.values()) == {STATUS_PREPROCESS_COMPLETED}
    worker.close()


def test_judge_exception_drains_cleanly_and_persists_prior_chunks():
    """A judge failure on chunk 3 writes every chunk judged before it,
    leaves later docs claimed but unjudged, joins the writer thread and
    leaves the worker usable."""
    _, (worker, store, _) = _pair(8)
    orig = worker.judge.judge
    calls = []

    def judge(tasks):
        calls.append(len(tasks))
        if len(calls) == 3:
            raise RuntimeError("device on fire")
        return orig(tasks)

    worker.judge.judge = judge
    with pytest.raises(RuntimeError, match="device on fire"):
        worker.tick(now=NOW + 150)
    sts = {d.id: d.status for d in store._docs.values()}
    for sid in (0, 1, 2, 3):
        assert sts[f"job-{sid}"] == STATUS_PREPROCESS_COMPLETED
    for sid in (4, 5, 6, 7):
        assert sts[f"job-{sid}"] == STATUS_PREPROCESS_INPROGRESS
    assert len(calls) == 3
    assert worker._last_pipeline["completed"] is False
    assert not [t for t in threading.enumerate() if t.name == "foremast-writeback"]
    assert worker.tick(now=NOW + 200) == 4
    worker.close()


def test_fetch_failures_persist_even_when_judge_crashes():
    _, (worker, store, source) = _pair(4)
    orig_fetch = source.fetch

    def fetch(url):
        if "latency:app2&" in url and "cur" in url:
            raise RuntimeError("boom")
        return orig_fetch(url)

    source.fetch = fetch
    orig_judge = worker.judge.judge
    calls = []

    def judge(tasks):
        calls.append(len(tasks))
        if len(calls) == 2:
            raise RuntimeError("device on fire")
        return orig_judge(tasks)

    worker.judge.judge = judge
    with pytest.raises(RuntimeError, match="device on fire"):
        worker.tick(now=NOW + 150)
    sts = {d.id: d.status for d in store._docs.values()}
    assert sts["job-2"] == STATUS_PREPROCESS_FAILED
    assert sts["job-0"] == sts["job-1"] == STATUS_PREPROCESS_COMPLETED
    worker.close()


def test_concurrent_fetch_false_degrades_to_depth_1():
    _, (worker, store, source) = _pair(6, depth=4)
    source.concurrent_fetch = False
    assert worker.tick(now=NOW + 150) == 6
    assert worker._last_pipeline["pipelined"] is False
    assert worker._last_pipeline["chunks"] == 3
    assert worker._fetch_pool is None and worker._prefetch_pool is None
    assert {d.status for d in store._docs.values()} == {STATUS_PREPROCESS_COMPLETED}


def test_persistent_pools_and_knobs(monkeypatch):
    monkeypatch.setenv("FOREMAST_FETCH_WORKERS", "3")
    monkeypatch.setenv("FOREMAST_PIPELINE_DEPTH", "3")
    monkeypatch.setenv("FOREMAST_COLD_CHUNK_DOCS", "2")
    _, (worker, _, source) = worker_pair(4, hist_len=HIST_LEN)
    assert (worker.fetch_workers, worker.pipeline_depth, worker.cold_chunk_docs) == (3, 3, 2)
    source.concurrent_fetch = True
    force_slow(worker)
    assert worker.tick(now=NOW + 150) == 4
    pool = worker._fetch_pool
    assert pool is not None and pool._max_workers == 3 and worker._prefetch_pool is not None
    assert worker.tick(now=NOW + 160) == 4
    assert worker._fetch_pool is pool
    worker.close()
    assert worker._fetch_pool is None and worker._prefetch_pool is None
    worker.close()  # idempotent


# -- ChunkPipeline drain semantics ------------------------------------------


def _pipe(fetch, judge, write, depth=2):
    pool = ThreadPoolExecutor(max_workers=max(1, depth - 1))
    return ChunkPipeline(fetch, judge, write, depth=depth, prefetch_pool=pool), pool


def test_pipeline_write_error_propagates_and_stops_feeding():
    written = []

    def write(chunk, result):
        if result == 2:
            raise ValueError("store down")
        written.append(result)

    pipe, pool = _pipe(lambda c: c, lambda c, p: p, write)
    with pytest.raises(ValueError, match="store down"):
        pipe.run([1, 2, 3, 4, 5])
    pool.shutdown(wait=True)
    assert written == [1]


def test_pipeline_fetch_error_surfaces_after_draining_writes():
    written = []

    def fetch(chunk):
        if chunk == 3:
            raise RuntimeError("fetch exploded")
        return chunk

    pipe, pool = _pipe(fetch, lambda c, p: p, lambda c, r: written.append(r))
    with pytest.raises(RuntimeError, match="fetch exploded"):
        pipe.run([1, 2, 3, 4])
    pool.shutdown(wait=True)
    assert written == [1, 2]


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_stage_error_writes_partial_and_aborts(depth):
    written, judged = [], []

    def judge(chunk, payload):
        judged.append(chunk)
        if chunk == 2:
            raise StageError(RuntimeError("dead"), ("partial", chunk))
        return payload

    pipe, pool = _pipe(lambda c: c, judge, lambda c, r: written.append(r), depth=depth)
    with pytest.raises(RuntimeError, match="dead"):
        pipe.run([1, 2, 3, 4])
    pool.shutdown(wait=True)
    assert judged == [1, 2]
    assert written == [1, ("partial", 2)]


def test_pipeline_stats_account_stages():
    pipe, pool = _pipe(lambda c: c, lambda c, p: p, lambda c, r: None, depth=3)
    stats = pipe.run([1, 2, 3, 4])
    assert stats.pipelined is True and stats.chunks == 4 and stats.wall_seconds > 0
    d = stats.as_dict()
    assert d["depth"] == 3 and 0.0 <= d["overlap_ratio"] < 1.0
    assert pipe.run([1]).pipelined is False
    pool.shutdown(wait=True)


# -- degradation -------------------------------------------------------------


def test_write_behind_caps_ages_out_and_requeue_keeps_stamps():
    t = [0.0]
    buf = WriteBehindBuffer(max_docs=3, max_age_seconds=10.0, clock=lambda: t[0])
    buf.add(["d1", "d2", "d3", "d4"])  # cap 3: d1 drops (oldest)
    assert len(buf) == 3
    snap = buf.stats.docs_snapshot()
    assert snap[REASON_BUFFERED] == 4 and snap["write_dropped_cap"] == 1
    t[0] = 6.0
    entries = buf.drain()
    assert [d for _, d in entries] == ["d2", "d3", "d4"]
    buf.requeue(entries)  # replay failed: back with the ORIGINAL stamps
    t[0] = 11.0
    assert buf.drain() == []  # aged from the first buffering
    assert buf.stats.docs_snapshot()[REASON_DROPPED_AGE] == 3
    buf.add(["late"], now=0.0)  # stamped at the claim, not the failure
    assert buf.drain() == []


def test_breaker_opens_fails_fast_and_recovers_half_open():
    t = [0.0]
    br = CircuitBreaker("prom", failure_threshold=2, open_seconds=5.0, clock=lambda: t[0])
    for _ in range(2):
        br.allow()
        br.record_failure()
    assert br.state == "open"
    with pytest.raises(BreakerOpen) as e:
        br.allow()
    assert is_transient_error(e.value)
    t[0] = 6.0
    br.allow()  # the half-open probe
    br.record_success()
    assert br.state == "closed"


class _OutageStore:
    """Delegating store whose writes or claims can be browned out with
    transient errors — the store-outage stand-in."""

    def __init__(self, inner):
        self.inner = inner
        self.fail_writes = False
        self.fail_claims = False
        self.write_log = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def claim(self, *a, **kw):
        if self.fail_claims:
            raise ConnectionError("store down (claim)")
        return self.inner.claim(*a, **kw)

    def update(self, doc):
        if self.fail_writes:
            raise ConnectionError("store down (write)")
        self.write_log.append((doc.id, doc.status))
        return self.inner.update(doc)

    def update_many(self, docs):
        if self.fail_writes:
            raise ConnectionError("store down (write)")
        self.write_log.extend((d.id, d.status) for d in docs)
        return self.inner.update_many(docs)


def _outage_worker(services=3, **kw):
    _, (worker, store, source) = worker_pair(services, hist_len=HIST_LEN, **kw)
    outage = _OutageStore(store)
    worker.store = outage
    return worker, outage, store, source


def test_store_outage_mid_warm_tick_degrades_then_replays_exactly_once():
    worker, outage, store, _ = _outage_worker(3)
    assert worker.tick(now=NOW + 150) == 3
    assert {d.status for d in store._docs.values()} == {STATUS_PREPROCESS_COMPLETED}
    outage.fail_writes = True
    outage.write_log.clear()
    assert worker.tick(now=NOW + 210) == 3  # warm tick THROUGH the outage
    assert worker._fast_kinds["univariate"] == 3
    assert outage.write_log == []
    assert worker._degrade.stats.docs_snapshot()[REASON_BUFFERED] == 3
    assert worker.debug_state()["degradation"]["write_behind"]["buffered_docs"] == 3
    outage.fail_writes = False
    assert worker.tick(now=NOW + 270) == 3  # heals: replay, then a normal tick
    assert worker._degrade.stats.docs_snapshot()[REASON_REPLAYED] == 3
    assert len(worker._degrade.write_behind) == 0
    per_doc = {}
    for doc_id, status in outage.write_log:
        per_doc.setdefault(doc_id, []).append(status)
    assert all(v == [STATUS_PREPROCESS_COMPLETED] * 2 for v in per_doc.values()), per_doc
    worker.close()


def test_claim_outage_degrades_to_empty_tick():
    worker, outage, _, _ = _outage_worker(2)
    outage.fail_claims = True
    assert worker.tick(now=NOW + 150) == 0
    assert worker._degrade.stats.events_snapshot()[("store", "claim_error")] == 1
    outage.fail_claims = False
    assert worker.tick(now=NOW + 160) == 2
    worker.close()


@pytest.mark.parametrize("path", ["object", "columnar"])
def test_transient_fetch_failure_releases_doc_not_terminal(path):
    """A TRANSIENT fetch failure releases its doc un-judged (claimable
    next tick); a permanent one keeps the reference's preprocess_failed
    — on the object path (cold) and on the columnar tick (warm)."""
    worker, _, store, source = _outage_worker(3)
    if path == "object":
        force_slow(worker)
        source.concurrent_fetch = True
    else:
        assert worker.tick(now=NOW + 150) == 3  # warm the fits first
    orig = source.fetch

    def fetch(url):
        if "app0&" in url:
            raise ConnectionError("prometheus down")  # transient
        if "app1&" in url:
            raise RuntimeError("bad query")  # permanent
        return orig(url)

    source.fetch = fetch
    assert worker.tick(now=NOW + 200) == 3
    sts = {d.id: d.status for d in store._docs.values()}
    assert sts == {
        "job-0": STATUS_PREPROCESS_COMPLETED,
        "job-1": STATUS_PREPROCESS_FAILED,
        "job-2": STATUS_PREPROCESS_COMPLETED,
    }
    assert worker._degrade.stats.docs_snapshot()[REASON_FETCH] == 1
    worker.close()


def test_tick_budget_releases_unfetched_chunks():
    worker, _, store, source = _outage_worker(6, degrade=Degradation(tick_budget_seconds=0.15))
    force_slow(worker)
    worker.cold_chunk_docs = 2
    worker.pipeline_depth = 1
    source.concurrent_fetch = True
    orig = source.fetch

    def slow_fetch(url):
        time.sleep(0.02)  # ~0.16 s per 2-doc chunk (8 urls)
        return orig(url)

    source.fetch = slow_fetch
    assert worker.tick(now=NOW + 150) == 6
    assert {d.status for d in store._docs.values()} == {STATUS_PREPROCESS_COMPLETED}
    assert worker._degrade.stats.docs_snapshot().get(REASON_DEADLINE, 0) > 0
    assert worker._last_tick["docs"] == 6
    worker.close()


# -- the sweep extensions of ChunkPipeline (copied for the sliced sweep) --


@pytest.mark.parametrize("pooled", [False, True])
def test_pipeline_lazy_iterator_end_and_boundary(pooled):
    """run() over an unbounded iterator stops at the first END payload,
    counts only the real chunks, and calls `boundary` after each
    chunk's judgment — serial and pipelined."""
    import itertools

    from foremast_tpu_torch.jobs.pipeline import END

    pool = ThreadPoolExecutor(max_workers=1) if pooled else None
    seen, boundaries, judged = [], [], []

    def fetch(i):
        return END if i >= 4 else f"payload-{i}"

    pipe = ChunkPipeline(
        fetch,
        lambda i, p: judged.append(i) or (i, p),
        lambda i, r: seen.append(r),
        depth=2,
        prefetch_pool=pool,
        boundary=lambda: boundaries.append(len(judged)),
    )
    stats = pipe.run(itertools.count())
    assert seen == [(i, f"payload-{i}") for i in range(4)]
    assert stats.chunks == 4 and stats.completed
    assert boundaries == [1, 2, 3, 4]
    if pool is not None:
        pool.shutdown(wait=True)


def test_pipeline_on_drained_gets_unjudged_prefetches():
    """A judge abort hands completed-but-unjudged prefetches to
    `on_drained`. The judge raises only once chunk 2's fetch is running,
    so that fetch cannot be cancelled and must drain."""
    drained = []
    fetching_2 = threading.Event()

    def fetch(c):
        if c == 2:
            fetching_2.set()
        return f"prep-{c}"

    def judge(c, p):
        assert fetching_2.wait(timeout=30)
        raise RuntimeError("boom")

    pool = ThreadPoolExecutor(max_workers=2)
    pipe = ChunkPipeline(
        fetch, judge, lambda c, r: None, depth=3, prefetch_pool=pool,
        on_drained=lambda c, p: drained.append((c, p)),
    )
    with pytest.raises(RuntimeError, match="boom"):
        pipe.run([1, 2, 3])
    pool.shutdown(wait=True)
    assert (2, "prep-2") in drained
    assert (1, "prep-1") not in drained
