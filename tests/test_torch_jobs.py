"""The port's job plane against the JAX package's: wire models and ids,
the config-string codec and URL functions, the in-memory store's claim
CAS and stuck takeover, the worker end to end on the reference demo's
golden traces, the settled-history cache, the worker's construction
rules and its span breakdown. Modeled on `tests/test_jobs.py`.

Worker cases run the JAX worker and the port's (on the CPU) over copies
of the same documents and series; what they write is equal exactly."""

import threading
import time

import numpy as np
import pytest
import torch

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu.jobs import models as jm
from foremast_tpu.jobs import worker as jworker
from foremast_tpu.jobs.store import InMemoryStore as JaxStore
from foremast_tpu.metrics import promql as jpromql
from foremast_tpu.metrics.source import ReplaySource as JaxReplay
from foremast_tpu.observe.spans import Tracer as JaxTracer
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.jobs import (
    STATUS_COMPLETED_HEALTH,
    STATUS_COMPLETED_UNHEALTH,
    STATUS_COMPLETED_UNKNOWN,
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_FAILED,
    STATUS_PREPROCESS_INPROGRESS,
    AnalyzeRequest,
    BrainWorker,
    Document,
    InMemoryStore,
    MetricQuery,
    document_response,
    infer_metric_type,
    job_id,
    status_to_external,
)
from foremast_tpu_torch.jobs import worker as tworker
from foremast_tpu_torch.metrics import promql as tpromql
from foremast_tpu_torch.metrics.source import ReplaySource, load_csv_trace
from foremast_tpu_torch.observe.spans import TICK_STAGES, Tracer
from tests.torch_workers import NOW, statuses, worker_pair


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


# ---------------------------------------------------------------------------
# wire models, ids, codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "status",
    ["initial", "preprocess_inprogress", "postprocess_inprogress", "preprocess_completed",
     "completed_health", "completed_unhealth", "completed_unknown", "preprocess_failed", "weird"],
)
def test_status_translation_matches_jax(status):
    assert status_to_external(status) == jm.status_to_external(status)


def test_job_id_and_document_wire_shape_match_jax():
    args = ("app", "1", "2", ("c", "b", "h"), ("p", "p", "p"), "canary")
    assert job_id(*args) == jm.job_id(*args)
    assert job_id(*args) != job_id("app", "1", "2", ("c2", "b", "h"), ("p", "p", "p"), "canary")
    doc = Document(id="j1", app_name="demo", status="completed_unhealth", trace_id="t1")
    doc.anomaly_info = {"tags": "", "values": {"m": [1.0, 2.0]}}
    want = jm.Document(id="j1", app_name="demo", status="completed_unhealth", trace_id="t1")
    want.anomaly_info = {"tags": "", "values": {"m": [1.0, 2.0]}}
    assert doc.to_json() == want.to_json()
    assert document_response(doc) == jm.document_response(want)
    assert Document.from_json(doc.to_json()) == doc


def test_config_codec_and_urls_match_jax():
    params = [
        {"endpoint": "http://p/api/v1/", "query": 'up{pod=~"a|b"}', "start": 1, "end": 2, "step": 60},
        {"endpoint": "http://p/api/v1/", "query": "err", "start": 10, "end": 20, "step": 3600},
    ]
    tq = {"latency": MetricQuery("prometheus", params[0]), "error5xx": MetricQuery("wavefront", params[1])}
    jq = {"latency": jm.MetricQuery("prometheus", params[0]), "error5xx": jm.MetricQuery("wavefront", params[1])}
    cfg = tpromql.encode_config(tq)
    assert cfg == jpromql.encode_config(jq)
    assert tpromql.decode_config(cfg[0]) == jpromql.decode_config(cfg[0])
    for p in params:
        assert tpromql.prometheus_url(p) == jpromql.prometheus_url(p)
        assert tpromql.wavefront_url(p) == jpromql.wavefront_url(p)


def test_metrics_info_and_analyze_request_match_jax():
    args = ("canary", {"latency": "http_latency", "error5xx": "http_5xx"}, "ns", "app", 1000, 1600,
            "http://prom/api/v1/")
    kw = dict(new_pods=["p1", "p2"], old_pods=["p0"])
    got = tpromql.create_metrics_info(*args, **kw)
    assert got.to_json() == jpromql.create_metrics_info(*args, **kw).to_json()
    body = {"appName": "app", "startTime": "1", "endTime": "2", "strategy": "canary",
            "metrics": got.to_json(), "podCountURL": ["u"]}
    assert AnalyzeRequest.from_json(body).to_json() == jm.AnalyzeRequest.from_json(body).to_json()


def test_load_csv_trace_matches_jax(tmp_path):
    from foremast_tpu.metrics.source import load_csv_trace as jax_load

    path = tmp_path / "t.csv"
    path.write_text("2024-01-01 00:05:00,2.5\n2024-01-01 00:00:00,1.5\n\n2024-01-01 00:05:00,3.0\n")
    for got, want in zip(load_csv_trace(str(path)), jax_load(str(path))):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# store semantics
# ---------------------------------------------------------------------------


def test_inmemory_store_idempotent_create_claim_and_stuck_takeover():
    s = InMemoryStore()
    d1, created1 = s.create(Document(id="a", app_name="x"))
    d2, created2 = s.create(Document(id="a", app_name="x"))
    assert created1 and not created2 and d1 is d2
    docs = s.claim("w1", max_stuck_seconds=90)
    assert [d.id for d in docs] == ["a"]
    assert docs[0].status == STATUS_PREPROCESS_INPROGRESS and docs[0].processing_content == "w1"
    # in progress recently: not claimable again
    assert s.claim("w2", max_stuck_seconds=90) == []
    # stale: claimable again (work stealing, design.md:39)
    s.get("a").modified_at = "2020-01-01T00:00:00Z"
    assert [d.id for d in s.claim("w2", max_stuck_seconds=90)] == ["a"]
    # terminal docs are never claimable
    stale = s.get("a")
    stale.status = STATUS_COMPLETED_HEALTH
    s.update(stale)
    assert s.claim("w3", max_stuck_seconds=0) == []
    assert s.count_open() == 0


def test_claim_filter_and_limit():
    s = InMemoryStore()
    for i in range(5):
        s.create(Document(id=f"d{i}", app_name=f"a{i % 2}"))
    got = s.claim("w", 90, limit=2, claim_filter=lambda d: d.app_name == "a1")
    assert [d.id for d in got] == ["d1", "d3"]
    assert all(s.get(f"d{i}").status == "initial" for i in (0, 2, 4))


# ---------------------------------------------------------------------------
# the worker end to end on the golden traces, against the JAX worker
# ---------------------------------------------------------------------------


def _mk_doc(cls, app, alias, cur_key, end_time="0", hist="hist"):
    return cls(
        id=f"job-{app}-{alias}-{cur_key}",
        app_name=app,
        end_time=end_time,
        current_config=f"{alias}== http://replay/{cur_key}",
        baseline_config="",
        historical_config=f"{alias}== http://replay/{hist}",
        strategy="rollingUpdate",
    )


def _replays(demo_traces):
    nt, nv = demo_traces["normal"]
    st, sv = demo_traces["spike"]
    hist = np.tile(nv, 6).astype(np.float32)
    ht = 1_700_000_000 + 60 * np.arange(len(hist), dtype=np.int64)
    out = []
    for cls in (JaxReplay, ReplaySource):
        src = cls()
        src.register("replay/hist", (ht, hist.copy()))
        src.register("replay/normal", (nt, nv.copy()))
        src.register("replay/spike", (st, sv.copy()))
        out.append(src)
    return out


# (docs as (app, alias, current trace key, endTime), tick clock)
_FUTURE = str(int(time.time()) + 3600)
GOLDEN_CASES = {
    "spike-flagged": ([("demo", "error4xx", "spike", "0")], None),
    "healthy-past-endtime": ([("demo", "error4xx", "normal", "100")], 1e12),
    "recheck-until-endtime": ([("demo", "error4xx", "normal", _FUTURE)], None),
    "unknown-on-empty-data": ([("demo", "m", "missing", "100")], 1e12),
    "batched-jobs": (
        [(f"app{i}", "error4xx", "normal", "100") for i in range(5)] + [("bad", "error4xx", "spike", "0")],
        1e12,
    ),
}


@pytest.mark.parametrize("case", list(GOLDEN_CASES))
def test_golden_traces_match_jax(case, demo_traces):
    docs, now = GOLDEN_CASES[case]
    jsrc, psrc = _replays(demo_traces)
    jstore, pstore = JaxStore(), InMemoryStore()
    for spec in docs:
        jstore.create(_mk_doc(jm.Document, *spec))
        pstore.create(_mk_doc(Document, *spec))
    jw = JaxWorker(jstore, jsrc, JaxConfig(), device_mesh=None)
    pw = BrainWorker(pstore, psrc, BrainConfig(), device="cpu")
    assert pw.tick(now=now) == jw.tick(now=now) == len(docs)
    got = statuses(pstore)
    assert got == statuses(jstore)
    want_status = {
        "spike-flagged": STATUS_COMPLETED_UNHEALTH,
        "healthy-past-endtime": STATUS_COMPLETED_HEALTH,
        "recheck-until-endtime": STATUS_PREPROCESS_COMPLETED,
        "unknown-on-empty-data": STATUS_COMPLETED_UNKNOWN,
    }
    if case in want_status:
        assert [s[0] for s in got.values()] == [want_status[case]]
    else:
        assert sorted(s[0] for s in got.values()) == [STATUS_COMPLETED_HEALTH] * 5 + [STATUS_COMPLETED_UNHEALTH]
    if case == "spike-flagged":
        vals = next(iter(got.values()))[3]["values"]["error4xx"]
        assert any(v > 30 for v in vals[1::2])  # the 40.134 spike in wire pairs


def test_preprocess_failure_and_isolated_fetch_failures(demo_traces):
    """A fetch that raises marks its doc preprocess_failed; with a
    blocking source (pooled fetches) the rest of the batch still judges."""
    _, replay = _replays(demo_traces)

    class Flaky:
        def fetch(self, url):
            if "bad" in url:
                raise RuntimeError("404")
            return replay.fetch(url)

    store = InMemoryStore()
    for i in range(4):
        store.create(_mk_doc(Document, f"ok{i}", "error4xx", "normal", "100"))
    store.create(_mk_doc(Document, "bad", "error4xx", "bad"))
    worker = BrainWorker(store, Flaky(), BrainConfig(), device="cpu")
    assert worker.tick(now=1e12) == 5
    sts = {d.id: d.status for d in store._docs.values()}
    assert sts["job-bad-error4xx-bad"] == STATUS_PREPROCESS_FAILED
    assert store.get("job-bad-error4xx-bad").reason == "metric fetch failed"
    assert sum(s == STATUS_COMPLETED_HEALTH for s in sts.values()) == 4
    worker.close()


def test_two_workers_contend_without_double_processing(demo_traces):
    """Two workers ticking concurrently over one store process every job
    exactly once (the claim flips status inside the store's lock)."""
    _, replay = _replays(demo_traces)
    store = InMemoryStore()
    n_jobs = 24
    for i in range(n_jobs):
        store.create(_mk_doc(Document, f"app{i}", "error4xx", "normal", "100"))
    processed: dict[str, int] = {}
    lock = threading.Lock()

    class CountingWorker(BrainWorker):
        def _write_back(self, doc, verdicts, now):
            with lock:
                processed[doc.id] = processed.get(doc.id, 0) + 1
            return super()._write_back(doc, verdicts, now)

    workers = [
        CountingWorker(store, replay, BrainConfig(), device="cpu", worker_id=f"w{i}", claim_limit=8)
        for i in range(2)
    ]

    def run(w):
        for _ in range(6):
            w.tick(now=1e12)

    threads = [threading.Thread(target=run, args=(w,)) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(processed) == n_jobs and set(processed.values()) == {1}
    assert all(d.status == STATUS_COMPLETED_HEALTH for d in store._docs.values())


class _Counting:
    def __init__(self, inner):
        self.inner = inner
        self.urls = []
        self.concurrent_fetch = False

    def fetch(self, url):
        self.urls.append(url)
        return self.inner.fetch(url)


@pytest.mark.parametrize(
    "hist,clock,hist_fetches",
    [("hist?end=1700000000", 1_700_000_000 + 300.0, 1), ("hist", 100.0, 2)],
    ids=["settled-cached", "unsettled-refetched"],
)
def test_recheck_history_cache(demo_traces, hist, clock, hist_fetches):
    """A settled history (its `end` safely past) is fetched once and its
    fit reused; a range without a provably past `end` is refetched every
    tick — the same fetches as the JAX worker makes."""
    jsrc, psrc = (_Counting(s) for s in _replays(demo_traces))
    jstore, pstore = JaxStore(), InMemoryStore()
    jstore.create(_mk_doc(jm.Document, "demo", "error4xx", "normal", str(2**31), hist=hist))
    pstore.create(_mk_doc(Document, "demo", "error4xx", "normal", str(2**31), hist=hist))
    jw = JaxWorker(jstore, jsrc, JaxConfig(), device_mesh=None)
    pw = BrainWorker(pstore, psrc, BrainConfig(), device="cpu")
    for now in (clock, clock + 100.0):
        jw.tick(now=now)
        pw.tick(now=now)
    assert psrc.urls == jsrc.urls
    assert len([u for u in psrc.urls if "hist" in u]) == hist_fetches
    assert len([u for u in psrc.urls if "normal" in u]) == 2
    assert statuses(pstore) == statuses(jstore)


@pytest.mark.parametrize(
    "alias", ["http_error5xx_rate", "p99Latency", "tps", "cpu_usage", "MemoryRSS", "error4xx"]
)
def test_infer_metric_type_matches_jax(alias):
    assert infer_metric_type(alias, BrainConfig()) == jworker.infer_metric_type(alias, JaxConfig())


@pytest.mark.parametrize(
    "url",
    [
        "http://p/api/v1/query_range?q=x&end=1700000000",
        "http://p/api/v1/query_range?end=2023-11-14T22:13:20Z",
        "ts(x)&&1699990000&&m&&1700000000",
        "http://p/api/v1/query_range?q=x",
        "http://p/api/v1/query_range?end=garbage",
    ],
)
def test_hist_end_epoch_matches_jax(url):
    assert tworker._hist_end_epoch(url) == jworker._hist_end_epoch(url)


# ---------------------------------------------------------------------------
# construction, warmup, the loop, spans, varz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["bivariate_normal", "lstm_autoencoder", "auto"])
def test_multivariate_algorithms_raise(algorithm):
    with pytest.raises(NotImplementedError, match="joint models"):
        BrainWorker(InMemoryStore(), ReplaySource(), BrainConfig(algorithm=algorithm), device="cpu")


def test_a_claim_that_would_slice_raises(monkeypatch):
    """The JAX worker slices a sweep whose claim can exceed
    FOREMAST_SWEEP_SLICE_DOCS; the port refuses rather than running
    another path. 0 (the monolithic arm) and a limit within one slice
    construct."""
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "2048")
    with pytest.raises(NotImplementedError, match="FOREMAST_SWEEP_SLICE_DOCS"):
        BrainWorker(InMemoryStore(), ReplaySource(), device="cpu", claim_limit=4096)
    assert BrainWorker(InMemoryStore(), ReplaySource(), device="cpu", claim_limit=2048)
    monkeypatch.delenv("FOREMAST_SWEEP_SLICE_DOCS")  # the default slices at 2048 too
    with pytest.raises(NotImplementedError):
        BrainWorker(InMemoryStore(), ReplaySource(), device="cpu", claim_limit=4096)
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")
    assert BrainWorker(InMemoryStore(), ReplaySource(), device="cpu", claim_limit=4096).sweep_slice_docs == 0


def test_default_device_is_the_card():
    """The worker's judge is built on the card unless the caller asks for
    the CPU; without a card the default raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        assert BrainWorker(InMemoryStore(), ReplaySource()).judge.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BrainWorker(InMemoryStore(), ReplaySource())


def test_warmup_leaves_caches_untouched_and_ticks_after():
    store = InMemoryStore()
    src = ReplaySource()
    worker = BrainWorker(store, src, BrainConfig(season_steps=24), device="cpu", claim_limit=20)
    worker.warmup(hist_len=256, cur_len=10)  # CPU-sized shapes
    assert len(worker._fit_cache) == 0
    assert worker.judge._arenas == {}
    assert worker.judge.device_state_counters()["misses"] == 0
    assert store.list_open() == []
    nt = 1_700_000_000 + 60 * np.arange(64, dtype=np.int64)
    nv = np.ones(64, np.float32)
    src.register("replay/whist", (nt, nv))
    src.register("replay/wcur", (nt[:10], nv[:10]))
    store.create(
        Document(
            id="wjob", app_name="w", end_time="100",
            current_config="m== http://replay/wcur", historical_config="m== http://replay/whist",
        )
    )
    worker.tick(now=1e12)
    assert store.get("wjob").status == STATUS_COMPLETED_HEALTH


def test_run_polls_until_stopped(demo_traces):
    _, replay = _replays(demo_traces)
    store = InMemoryStore()
    store.create(_mk_doc(Document, "demo", "error4xx", "normal", "100"))
    worker = BrainWorker(store, replay, BrainConfig(), device="cpu")
    ticks = []
    orig = worker.tick
    worker.tick = lambda now=None: ticks.append(orig(now)) or ticks[-1]
    worker.run(poll_seconds=0.0, stop=lambda: len(ticks) >= 3)
    assert ticks == [1, 0, 0]
    assert store.get("job-demo-error4xx-normal").status == STATUS_COMPLETED_HEALTH


def test_stage_breakdown_matches_jax_tracer():
    """The port's Tracer (no registry: no histogram, no prometheus_client)
    attributes a cold and a warm tick to the same stages as the JAX
    worker's tracer."""
    jtr, ptr = JaxTracer(histogram=False), Tracer()
    (jw, _, _), (pw, _, _) = worker_pair(3, tracer=None)
    jw.tracer, pw.tracer = jtr, ptr
    stages = []
    for now in (NOW + 150, NOW + 200):
        jw.tick(now=now)
        pw.tick(now=now)
        assert set(ptr.last_stage_seconds) == set(jtr.last_stage_seconds)
        assert all(v >= 0.0 for v in ptr.last_stage_seconds.values())
        stages.append(set(ptr.last_stage_seconds))
    assert stages[0] == {"claim", "metric_fetch", "fit", "arena_assemble", "score", "decode", "decide"}
    assert stages[1] == {"claim", "metric_fetch", "arena_assemble", "score", "decode", "decide", "write_back"}
    assert stages[0] | stages[1] == set(TICK_STAGES)
    assert pw.debug_state()["trace"]["last_stage_seconds"] == ptr.last_stage_seconds


def test_json_logs_carry_the_tick_trace_and_the_ring_dumps(tmp_path):
    """A record logged inside a tick's span carries its trace and span
    IDs (observe.logs); with a trace dir the span ring dumps as JSONL
    (one Chrome trace event per span)."""
    import io
    import json
    import logging

    from foremast_tpu_torch.observe.logs import JsonFormatter, ctx_log

    tracer = Tracer(trace_dir=str(tmp_path))
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter())
    logger = logging.getLogger("foremast_tpu_torch.test_logs")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with tracer.span("worker.tick") as root:
            with tracer.span("worker.claim", stage="claim"):
                ctx_log(logger, logging.INFO, "judgment", job_id="j1")
    finally:
        logger.removeHandler(handler)
    rec = json.loads(stream.getvalue())
    assert rec["msg"] == "judgment" and rec["job_id"] == "j1"
    assert rec["trace_id"] == root.trace_id
    path = tracer.flush()
    events = [json.loads(line) for line in open(path)]
    assert [e["name"] for e in events] == ["worker.claim", "worker.tick"]
    assert events[0]["args"]["parent_id"] == events[1]["args"]["span_id"]
    assert set(tracer.last_stage_seconds) == {"claim"}


def test_debug_state_sections():
    (_, _, _), (pw, _, _) = worker_pair(2)
    pw.tick(now=NOW + 150)
    pw.tick(now=NOW + 200)
    state = pw.debug_state()
    assert state["device"] == "cpu"
    assert state["queue_depth"] == 2 and state["store_ok"]
    assert state["model_cache"]["fit_entries"] == 8
    assert state["cold_start"]["hist_reads"] == {"http": 8, "cache": 0}
    assert state["fast_path_docs"] == {"univariate": 2, "baseline": 0}
    assert state["arena"]["hit_rate"] is not None
    assert state["last_tick"]["docs"] == 2 and state["last_tick"]["fast"] == 2
    assert state["sweep"] == {"slice_docs": 0, "sliced": False}
    assert "write_behind" in state["degradation"] and "breakers" in state["degradation"]
    assert "trace" not in state  # no tracer wired
