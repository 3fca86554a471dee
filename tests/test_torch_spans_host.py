"""The port's spans of the worker's host time (`foremast_tpu_torch/observe/
spans.py` and the spans it opens in `jobs/` and `engine/`), on the CPU:

  * a warm tick and a sliced sweep carry `worker.admit` and `worker.pack`
    spans; the sliced sweep's sit on the prefetch thread, under the
    tick's trace id;
  * a columnar `worker.decide` span counts, in `verdicts`, the
    per-metric verdicts it built for the verdict hook;
  * every `_HostCopy.synchronize` under a tracer opens one
    `judge.device_wait`, nested in `fit` or `decode`;
  * a collection of generation 1 or 2 inside an open root is one
    `gc.collect` span, under the collecting thread's innermost span (the
    root when that thread has none); young collections are counted; the
    gc hook takes no lock, so a collection completes while another
    thread holds the ring's lock;
  * `pipeline.judge_stall` times what `PipelineStats.judge_stall_seconds`
    sums;
  * `span(device=True)` enters no `record_function` while no profiler
    records, and no `gc.callbacks` entry exists before a Tracer does;
  * a `trace_scoring` region with a tracer writes the spans into its
    Chrome trace, on the profiler's clock and thread rows.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.ingest import RingSource
from foremast_tpu_torch.jobs import BrainWorker
from foremast_tpu_torch.jobs.pipeline import ChunkPipeline
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.observe import spans as sp
from foremast_tpu_torch.observe.profile import CLOCK_MARK, trace_scoring
from tests.torch_workers import push_fleet

NOW = int(time.time())
SERVICES = 24


class Recording(sp.Tracer):
    """A Tracer that also keeps every finished span, in finish order."""

    def __init__(self, **kw):
        super().__init__(service="test", **kw)
        self.done: list = []

    def _finish(self, s, root: bool) -> None:
        self.done.append(s)
        super()._finish(s, root)

    def named(self, name: str) -> list:
        return [s for s in self.done if s.name == name]


def _worker(slice_docs: int, tracer=None, on_verdict=None):
    store, ring, _keys, _ht, _ct = push_fleet("port", SERVICES, t_now=NOW, open_window=True, seed=7, shards=2)
    w = BrainWorker(store, RingSource(ring, fallback=None),
                    config=BrainConfig(algorithm="moving_average_all", season_steps=24,
                                       max_cache_size=4 * SERVICES + 64),
                    device="cpu", claim_limit=SERVICES + 16, worker_id="spans", tracer=tracer,
                    on_verdict=on_verdict)
    w.sweep_slice_docs = slice_docs
    return w


@pytest.fixture
def no_auto_gc():
    """Only the test's own collections: automatic ones would add spans."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


# -- admission and packing ----------------------------------------------------


@pytest.mark.parametrize("slice_docs", [0, 8])
def test_warm_ticks_carry_admit_and_pack_spans(slice_docs):
    tracer = Recording()
    w = _worker(slice_docs, tracer)
    assert w._sweep_sliceable() is bool(slice_docs)
    for k in range(3):  # cold, first warm (fills the admission cache), second warm
        tracer.done.clear()
        assert w.tick(now=NOW + 60.0 * k) == SERVICES
    root = tracer.named("worker.tick")[0]
    admits, packs = tracer.named("worker.admit"), tracer.named("worker.pack")
    assert admits and packs
    assert all(s.stage == "admit" for s in admits) and all(s.stage == "pack" for s in packs)
    assert sum(s.attrs["docs"] for s in admits) == SERVICES
    assert sum(s.attrs["hits"] for s in admits) == SERVICES  # every doc admitted from the cache
    assert all(s.attrs["size"] == SERVICES for s in admits[-1:])
    assert sum(s.attrs["docs"] for s in packs) == SERVICES
    for s in admits + packs:
        assert s.trace_id == root.trace_id
        assert root._t0 <= s._t0 and s._t0 + s.duration <= root._t0 + root.duration
    if slice_docs:
        # one admission walk and one packing a slice, on the prefetch thread
        assert len(admits) == len(packs) == SERVICES // slice_docs
        assert {s.tid for s in admits + packs} != {root.tid}
        assert all(s.tid != root.tid for s in admits + packs)
    else:
        assert len(admits) == 1 and admits[0].tid == root.tid and admits[0].parent_id == root.span_id
    w.close()


@pytest.mark.parametrize("slice_docs", [0, 8])
@pytest.mark.parametrize("hooked", [True, False], ids=["hook", "no_hook"])
def test_decide_span_counts_the_verdicts_built_for_the_hook(slice_docs, hooked):
    """A columnar `worker.decide` span's `verdicts` is the number of
    per-metric verdicts the hook received inside it; 0 with no hook."""
    received: dict = {}

    def hook(doc, verdicts):
        sid = sp.current_span().span_id
        received[sid] = received.get(sid, 0) + len(verdicts)

    tracer = Recording()
    w = _worker(slice_docs, tracer, on_verdict=hook if hooked else None)
    for k in range(3):  # cold (object path), then two warm columnar ticks
        tracer.done.clear()
        received.clear()
        assert w.tick(now=NOW + 60.0 * k) == SERVICES
    decides = tracer.named("worker.decide")
    assert len(decides) == (SERVICES // slice_docs if slice_docs else 1)
    assert sum(s.attrs["docs"] for s in decides) == SERVICES
    for s in decides:
        assert s.attrs["verdicts"] == received.get(s.span_id, 0)
    assert sum(s.attrs["verdicts"] for s in decides) == (SERVICES if hooked else 0)  # one metric a doc
    assert set(received) <= {s.span_id for s in decides}
    w.close()


# -- the waits on the card -------------------------------------------------------


def test_each_host_copy_wait_is_one_device_wait_in_fit_or_decode(monkeypatch):
    calls = []
    orig = tj._HostCopy.synchronize

    def counted(self):
        calls.append(sp.current_span())
        return orig(self)

    monkeypatch.setattr(tj._HostCopy, "synchronize", counted)
    tracer = Recording()
    for slice_docs in (0, 8):
        w = _worker(slice_docs, tracer)
        for k in range(2):  # a cold tick (fit and decode) and a warm one (columnar decode)
            calls.clear()
            tracer.done.clear()
            w.tick(now=NOW + 60.0 * k)
            waits = tracer.named("judge.device_wait")
            assert len(waits) == len(calls) > 0
            assert all(s.stage == "device_wait" for s in waits)
            by_id = {s.span_id: s for s in tracer.done}
            assert {by_id[s.parent_id].stage for s in waits} <= {"fit", "decode"}
            assert {by_id[s.parent_id].stage for s in waits} == ({"fit", "decode"} if k == 0 else {"decode"})
            # the enclosing stage keeps the wait inside its own time
            for s in waits:
                p = by_id[s.parent_id]
                assert p._t0 <= s._t0 and s._t0 + s.duration <= p._t0 + p.duration
        w.close()


def test_columnar_decode_span_covers_the_unpack(monkeypatch):
    """`judge.decode` closes after the columnar result is unpacked: the
    unpack runs inside it."""
    seen = []
    orig = np.unpackbits

    def unpack(*a, **kw):
        seen.append(sp.current_span())
        return orig(*a, **kw)

    tracer = Recording()
    w = _worker(0, tracer)
    w.tick(now=float(NOW))
    monkeypatch.setattr(tj.np, "unpackbits", unpack)
    w.tick(now=NOW + 60.0)
    assert seen and all(s is not None and s.name == "judge.decode" for s in seen)
    w.close()


# -- the collector ----------------------------------------------------------------


def test_collections_inside_a_root_are_spans_and_young_ones_counted(no_auto_gc):
    tracer = Recording()
    before = list(tracer._gc_count)
    gc.collect(1)  # outside every root: nothing
    assert tracer._gc_count == before and not tracer.done
    other = {}

    def elsewhere():
        gc.collect(2)  # a thread with no open span: parented to the root
        other["tid"] = threading.get_native_id()

    with tracer.span("worker.tick") as root:
        with tracer.span("worker.decide", stage="decide") as decide:
            gc.collect(1)
        gc.collect(2)
        gc.collect(0)
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(10)
        assert not tracer.named("gc.collect")  # made spans when the root closes
    got = tracer.named("gc.collect")
    assert [s.attrs["generation"] for s in got] == [1, 2, 2]
    assert [s.parent_id for s in got] == [decide.span_id, root.span_id, root.span_id]
    assert all(s.stage == "gc" and s.trace_id == root.trace_id and s.duration > 0 for s in got)
    assert [s.tid for s in got] == [root.tid, root.tid, other["tid"]]
    # real start times, inside their parents
    assert decide._t0 <= got[0]._t0 and got[0]._t0 + got[0].duration <= decide._t0 + decide.duration
    assert root._t0 <= got[1]._t0 < got[2]._t0 <= root._t0 + root.duration
    assert tracer.last_stage_seconds["gc"] == pytest.approx(sum(s.duration for s in got))
    counts = tracer.debug_state()["gc"]["collections"]
    assert [c - b for c, b in zip(counts, before)] == [1, 1, 2]  # the young one counted, not spanned
    gc.collect(2)  # after the root: nothing more
    assert len(tracer.named("gc.collect")) == 3 and tracer.debug_state()["gc"]["collections"] == counts


def test_a_collection_completes_while_the_ring_lock_is_held(tmp_path, no_auto_gc):
    tracer = Recording(trace_dir=str(tmp_path))
    collected, release, closed = threading.Event(), threading.Event(), threading.Event()

    def tick():
        with tracer.span("worker.tick"):
            gc.collect(1)
            collected.set()
            release.wait(30)
        closed.set()

    with tracer.ring._lock:
        t = threading.Thread(target=tick, daemon=True)
        t.start()
        assert collected.wait(10), "the collection blocked on the ring's lock"
        assert not closed.is_set()
        release.set()
    t.join(10)
    assert closed.is_set() and not t.is_alive()
    assert [s.attrs["generation"] for s in tracer.named("gc.collect")] == [1]
    assert [e["name"] for e in tracer.ring.snapshot()] == ["gc.collect", "worker.tick"]


def test_no_gc_hook_and_no_marker_without_a_tracer():
    """A fresh process: no `gc.callbacks` entry until the first Tracer,
    one entry however many are built, and no `record_function` for a
    device span with no tracer and no profiler."""
    code = """
import gc, torch
from foremast_tpu_torch.observe import spans as sp
entered = []
torch.profiler.record_function = lambda name: entered.append(name)
with sp.span("judge.score", stage="score", device=True) as s:
    assert s is None
assert sp._gc_callback not in gc.callbacks and not entered
tracers = [sp.Tracer(), sp.Tracer()]
assert gc.callbacks.count(sp._gc_callback) == 1
with tracers[0].span("worker.tick"):
    with sp.span("judge.score", stage="score", device=True) as s:
        assert s.name == "judge.score"
assert not entered
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_device_spans_mark_the_profiler_only_while_it_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tracer = Recording()
    with sp.span("judge.fit", device=True):
        pass
    with tracer.span("worker.tick"):
        with sp.span("judge.fit", stage="fit", device=True):
            pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with sp.span("judge.fit", device=True):
            pass
        with tracer.span("worker.tick"):
            with sp.span("judge.score", stage="score", device=True):
                pass
    assert entered == ["judge.fit", "judge.score"]


# -- the pipeline's stall ---------------------------------------------------------


def test_judge_stall_spans_time_the_stats_stall():
    tracer = Recording()
    pool = ThreadPoolExecutor(1)

    def fetch(c):
        time.sleep(0.02)  # a slow prefetch: the tick thread waits for every chunk
        return c

    pipe = ChunkPipeline(sp.inherit_span(fetch), lambda c, p: p, lambda c, r: None, depth=2, prefetch_pool=pool)
    with tracer.span("worker.tick") as root:
        stats = pipe.run(list(range(6)))
    pool.shutdown(wait=True)
    stalls = tracer.named("pipeline.judge_stall")
    assert len(stalls) == 6 and all(s.stage is None and s.trace_id == root.trace_id for s in stalls)
    assert stats.judge_stall_seconds > 0.05
    assert abs(sum(s.duration for s in stalls) - stats.judge_stall_seconds) < 1e-3
    d = stats.as_dict()
    assert d["judge_stall_seconds"] == round(stats.judge_stall_seconds, 4) and "device_idle_seconds" not in d
    assert "pipeline.judge_stall" not in {s.name for s in tracer.done if s.stage}
    assert set(tracer.last_stage_seconds) <= {"gc"}  # no stage of its own


# -- one clock with the profiler's trace ------------------------------------------------


def _tasks(n=24, hist=240, cur=30):
    rng = np.random.default_rng(3)
    t0 = 1_760_000_000.0
    out = []
    for i in range(n):
        hv = (20 + rng.standard_normal(hist)).astype(np.float32)
        cv = (20 + rng.standard_normal(cur)).astype(np.float32)
        out.append(tj.MetricTask(job_id=f"j{i}", alias="latency", metric_type="latency",
                                 hist_times=t0 - 60.0 * np.arange(hist, 0, -1), hist_values=hv,
                                 cur_times=t0 + 60.0 * np.arange(cur), cur_values=cv, app=f"a{i}",
                                 fit_key=f"k{i}"))
    return out


def test_trace_scoring_holds_the_spans_on_the_profilers_clock(tmp_path):
    tracer = Recording()
    judge = tj.HealthJudge(BrainConfig(), device="cpu")
    judge.fit_cache = ModelCache(128)
    with trace_scoring(str(tmp_path), tracer=tracer) as handle:
        with tracer.span("worker.tick"):
            judge.judge(_tasks())
    events = json.load(open(handle.path))["traceEvents"]
    ours = [e for e in events if e.get("cat") == "foremast"]
    marks = [e for e in events if e.get("name", "").startswith("judge.") and e.get("cat") != "foremast"]
    assert any(e.get("name") == CLOCK_MARK for e in events)
    assert {e["name"] for e in ours} >= {"worker.tick", "judge.pack", "judge.fit", "judge.score", "judge.decode",
                                         "judge.device_wait"}
    assert len(ours) == len(tracer.done)
    marked = {e["name"] for e in marks}
    assert {"judge.fit", "judge.score", "judge.decode"} <= marked
    for e in ours:
        if e["name"] not in marked:
            continue  # a span with no device marker (pack, device_wait)
        near = min((m for m in marks if m["name"] == e["name"] and m["tid"] == e["tid"]),
                   key=lambda m: abs(float(m["ts"]) - e["ts"]), default=None)
        assert near is not None, e
        assert abs(float(near["ts"]) - e["ts"]) < 200, (e, near)
        assert e["args"]["stage"] and e["args"]["trace_id"] == tracer.done[-1].trace_id


def test_worker_sweep_trace_holds_every_threads_spans(monkeypatch, tmp_path):
    """A sliced sweep under `FOREMAST_PROFILE` with a tracer: its trace
    holds the tick's spans, the prefetch thread's on that thread's row."""
    tracer = Recording()
    w = _worker(8, tracer)
    w.tick(now=float(NOW))
    w.tick(now=NOW + 60.0)
    monkeypatch.setenv("FOREMAST_PROFILE", str(tmp_path))
    tracer.done.clear()
    w.tick(now=NOW + 120.0)
    (path,) = list(tmp_path.iterdir())
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("cat") == "foremast"]
    names = {e["name"] for e in events}
    assert {"worker.tick", "worker.admit", "worker.pack", "worker.decide", "judge.decode"} <= names
    tick = next(e for e in events if e["name"] == "worker.tick")
    admits = [e for e in events if e["name"] == "worker.admit"]
    assert all(e["tid"] != tick["tid"] for e in admits)
    for e in events:
        assert tick["ts"] - 1 <= e["ts"] and e["ts"] + e["dur"] <= tick["ts"] + tick["dur"] + 1
    w.close()
