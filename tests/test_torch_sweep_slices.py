"""Sliced, preemptible sweeps in the port (`BrainWorker._sweep_sliced`,
`_SweepPool`, `_preempt_between_slices`, the `ChunkPipeline` extensions
they ride on) against the JAX package's, after `tests/test_sweep_slices.py`.

On the same pure-push fleets (`benchmarks/latency_bench.py`'s shape,
rebuilt for each package from one seed):

  * a sliced sweep writes, cold, warm and spiked, byte for byte what the
    port's monolithic tick and the JAX worker's sliced sweep write;
  * at a slice boundary an arrival for a pooled doc PROMOTES it, one for
    a doc outside the claim runs a nested micro-tick, and a budget that
    expires mid-sweep releases the remainder in one bulk write, every
    claimed doc judged exactly once or released;
  * write-behind entries of slice writes, and of a micro-tick nested
    between slices, carry the sweep's claim stamp and replay exactly once
    across a store brownout that begins mid-sweep;
  * a judge that dies mid-sweep leaves no doc in progress.

The pipeline cases hold the port's `ChunkPipeline` to the same END,
boundary and on_drained contracts; the on_drained case waits on an event
for the prefetch it expects drained, never on timing. Every threaded case
joins with a timeout."""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from benchmarks.latency_bench import build_fleet as jax_fleet
from benchmarks.latency_bench import mk_worker as jax_worker
from foremast_tpu.reactive import DirtySet as JaxDirty
from foremast_tpu_torch.chaos.degrade import REASON_DEADLINE
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.ingest import RingSource
from foremast_tpu_torch.jobs import BrainWorker
from foremast_tpu_torch.jobs import pipeline as pl
from foremast_tpu_torch.jobs.models import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED, TERMINAL_STATUSES
from foremast_tpu_torch.reactive import DirtySet
from tests.torch_workers import push_fleet

NOW = int(time.time())
_FLEET = dict(t_now=NOW, open_window=True, expr='latency{{namespace="bench",app="app{s}"}}', seed=7, shards=8,
              budget_bytes=1 << 30, stale_seconds=3600.0)


class _CountingStore:
    """Wraps a store: counts per-doc writes, an optional one-shot claim
    hook (fires AFTER the claim: the deterministic way to land dirty marks
    mid-sweep, past the catch-all drain), and an injectable transient
    write fault."""

    def __init__(self, inner):
        self.inner = inner
        self.writes: dict[str, int] = {}
        self.on_claim = None
        self.fail_writes = False
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def claim(self, *a, **kw):
        docs = self.inner.claim(*a, **kw)
        hook, self.on_claim = self.on_claim, None
        if hook is not None:
            hook(docs)
        return docs

    def _count(self, docs):
        with self._lock:
            for d in docs:
                self.writes[d.id] = self.writes.get(d.id, 0) + 1

    def update(self, doc):
        if self.fail_writes:
            raise ConnectionError("injected store brownout")
        doc = self.inner.update(doc)
        self._count([doc])
        return doc

    def update_many(self, docs):
        if self.fail_writes:
            raise ConnectionError("injected store brownout")
        self.inner.update_many(docs)
        self._count(docs)


def _port_worker(store, ring, services, dirty=None):
    """The port's twin of `latency_bench.mk_worker`."""
    w = BrainWorker(store, RingSource(ring, fallback=None),
                    config=BrainConfig(algorithm="moving_average_all", season_steps=24,
                                       max_cache_size=services + 64),
                    device="cpu", claim_limit=services + 16, worker_id="latency-bench", dirty=dirty)
    w.microtick_seconds = 0.05
    w.microtick_docs = 512
    return w


def _sliced(pkg, services, slice_docs=8, dirty=None, claim_limit=None):
    """(worker, counting store, inner store, ring, keys, ct) of one package."""
    if pkg == "jax":
        store, ring, keys, _, ct = jax_fleet(services, NOW)
        wrapped = _CountingStore(store)
        w = jax_worker(wrapped, ring, services, dirty=dirty)
    else:
        store, ring, keys, _, ct = push_fleet("port", services, **_FLEET)
        wrapped = _CountingStore(store)
        w = _port_worker(wrapped, ring, services, dirty=dirty)
    if claim_limit is not None:
        w.claim_limit = claim_limit
    w.sweep_slice_docs = slice_docs
    return w, wrapped, store, ring, keys, ct


def _statuses(store) -> dict:
    return {d.id: (d.status, d.status_code, d.reason, d.anomaly_info) for d in store._docs.values()}


def _both(services, slice_docs=8, claim_limit=None, dirty=False):
    return [_sliced(pkg, services, slice_docs, dirty=(cls() if dirty else None), claim_limit=claim_limit)
            for pkg, cls in (("jax", JaxDirty), ("port", DirtySet))]


# -- parity ----------------------------------------------------------------


def test_sliced_vs_monolithic_byte_parity():
    """Cold + warm + spiked sweeps: the port's sliced arm writes what its
    monolithic arm and the JAX worker's sliced arm write, byte for byte."""
    mono = _sliced("port", 24, slice_docs=0)
    pair = _both(24)
    arms = [mono, *pair]
    assert not mono[0]._sweep_sliceable() and all(a[0]._sweep_sliceable() for a in pair)
    for now, spiked in ((float(NOW), False), (NOW + 60.0, True)):
        if spiked:
            for _, _, _, ring, keys, ct in arms:
                ring.push(keys[3], ct[-3:], np.full(3, 40.0, np.float32), now=float(NOW))
        for w, *_ in arms:
            assert w.tick(now=now) == 24
        assert _statuses(mono[2]) == _statuses(pair[1][2]) == _statuses(pair[0][2])
    assert _statuses(pair[1][2])["job-3"][0] == STATUS_COMPLETED_UNHEALTH
    assert pair[1][0]._last_sweep["slices"] == pair[0][0]._last_sweep["slices"] == 3
    for w, *_ in arms:
        w.close()


# -- preemption triage -----------------------------------------------------


def test_boundary_promotes_pooled_doc():
    """An arrival for a claimed-but-unfetched doc promotes its slice to
    the front: the sweep itself delivers the verdict, attributed through
    the sweep ledger, and the dirty set counts the promotion."""
    got = []
    for w, cs, store, ring, keys, ct in _both(32, dirty=True):
        assert w.tick(now=float(NOW)) == 32  # cold: fits cached

        def on_claim(_docs, ring=ring, keys=keys, ct=ct, dirty=w.dirty):
            ring.push(keys[31], ct[-3:], np.full(3, 40.0, np.float32), now=float(NOW))
            dirty.mark_series(keys[31], now=float(NOW))

        cs.on_claim = on_claim
        assert w.tick(now=NOW + 60.0) == 32
        sweep = w._last_sweep
        assert sweep["promoted"] >= 1 and sweep["preempt_microticks"] == 0, sweep
        assert w.dirty.counts()["promoted"] >= 1 and len(w.dirty) == 0
        assert store._docs["job-31"].status == STATUS_COMPLETED_UNHEALTH
        got.append((_statuses(store), {k: sweep[k] for k in ("slices", "promoted", "preempt_microticks")}))
        w.close()
    assert got[0] == got[1]


def _victim(docs, ring, keys, ct, dirty, spike=True):
    """Mark (and spike) the highest-numbered doc the claim left out."""
    claimed = {d.id for d in docs}
    s = next(s for s in range(31, -1, -1) if f"job-{s}" not in claimed)
    if spike:
        ring.push(keys[s], ct[-3:], np.full(3, 40.0, np.float32), now=float(NOW))
    dirty.mark_series(keys[s], now=float(NOW))
    return f"job-{s}"


def test_boundary_microtick_judges_unclaimed_doc():
    """An arrival for a doc OUTSIDE the sweep's claim (a bounded claim
    limit) runs a nested micro-tick between slices: the doc is judged
    during the sweep, not after it."""
    got = []
    for w, cs, store, ring, keys, ct in _both(32, claim_limit=24, dirty=True):
        assert w.tick(now=float(NOW)) == 24
        victim = {}
        cs.on_claim = lambda docs, r=ring, k=keys, c=ct, d=w.dirty: victim.setdefault("id", _victim(docs, r, k, c, d))
        assert w.tick(now=NOW + 60.0) > 0
        sweep = w._last_sweep
        assert sweep["preempt_microticks"] >= 1 and sweep["preempt_docs"] >= 1, sweep
        assert store._docs[victim["id"]].status == STATUS_COMPLETED_UNHEALTH
        got.append(_statuses(store))
        w.close()
    assert got[0] == got[1]


# -- preemption x degradation ---------------------------------------------


def test_microtick_preempts_then_budget_release():
    """A sweep whose budget expires inside its first slice: the nested
    micro-tick runs (and restores the sweep's deadline), the pooled
    remainder releases in ONE bulk write as `deadline_released`, and every
    claimed doc is judged exactly once or released, never both."""
    w, cs, store, ring, keys, ct = _sliced("port", 32, dirty=DirtySet(max_keys=64), claim_limit=24)
    assert w.tick(now=float(NOW)) == 24
    w._degrade.tick_budget_seconds = 0.05
    orig_fetch = w.source.fetch
    slept = []

    def slow_fetch(url):
        # burn the budget inside slice 1's prepare: every LATER slice's
        # prepare sees an expired deadline and drains the pool as one
        # release bundle
        if not slept:
            slept.append(1)
            time.sleep(0.12)
        return orig_fetch(url)

    w.source.fetch = slow_fetch
    cs.on_claim = lambda docs: _victim(docs, ring, keys, ct, w.dirty, spike=False)
    before = w._degrade.stats.docs_snapshot().get(REASON_DEADLINE, 0)
    n = w.tick(now=NOW + 60.0)
    released = w._degrade.stats.docs_snapshot().get(REASON_DEADLINE, 0) - before
    sweep = w._last_sweep
    assert sweep["preempt_microticks"] >= 1, sweep
    assert released > 0 and n == 24, (n, released, sweep)
    assert sum(d.status == STATUS_PREPROCESS_COMPLETED for d in store._docs.values()) >= released
    w.close()


def test_write_behind_replay_across_slice_boundary():
    """A store brownout that begins after the claim: slice writes buffer
    into write-behind stamped at the SWEEP's claim instant, and replay
    exactly once when the store heals."""
    w, cs, store, ring, keys, ct = _sliced("port", 32)
    assert w.tick(now=float(NOW)) == 32
    claim_stamp = []

    def on_claim(_docs):
        cs.fail_writes = True
        claim_stamp.append(w._tick_claim_mono)

    cs.on_claim = on_claim
    writes_before = dict(cs.writes)
    assert w.tick(now=NOW + 60.0) == 32
    buf = w._degrade.write_behind
    assert len(buf) == 32
    with buf._lock:
        stamps = [at for at, _ in buf._entries]
    assert all(at == claim_stamp[0] for at in stamps), stamps
    assert cs.writes == writes_before
    cs.fail_writes = False
    assert w.tick(now=NOW + 120.0) == 32
    assert len(buf) == 0
    assert all(cs.writes[f"job-{s}"] - writes_before.get(f"job-{s}", 0) == 2 for s in range(32)), cs.writes
    assert w._degrade.stats.docs_snapshot().get("write_replayed", 0) == 32
    w.close()


def test_nested_microtick_write_behind_keeps_the_sweeps_claim_stamp():
    """A micro-tick nested at a slice boundary during a store brownout:
    its buffered verdict is stamped at the SWEEP's claim instant like the
    slices' (a nested claim never moves the stamp forward, or a replay
    could land past the stuck-takeover window), and every buffered doc
    replays exactly once."""
    w, cs, store, ring, keys, ct = _sliced("port", 32, dirty=DirtySet(max_keys=64), claim_limit=24)
    assert w.tick(now=float(NOW)) == 24
    claim_stamp = []

    def on_claim(docs):
        cs.fail_writes = True
        claim_stamp.append(w._tick_claim_mono)
        _victim(docs, ring, keys, ct, w.dirty)

    cs.on_claim = on_claim
    assert w.tick(now=NOW + 60.0) == 24
    assert w._last_sweep["preempt_docs"] == 1, w._last_sweep
    buf = w._degrade.write_behind
    with buf._lock:
        stamps = [at for at, _ in buf._entries]
    assert len(stamps) == 25 and set(stamps) == {claim_stamp[0]}, (len(stamps), set(stamps), claim_stamp)
    cs.fail_writes = False
    assert w.tick(now=NOW + 120.0) > 0
    assert len(buf) == 0 and w._degrade.stats.docs_snapshot().get("write_replayed", 0) == 25
    w.close()


def test_chaos_store_brownout_mid_sweep_exactly_once():
    """A brownout that begins between slices (the first slice lands, the
    rest buffer): every doc's verdict is written exactly once for that
    sweep, split between direct writes and the replay."""
    w, cs, store, ring, keys, ct = _sliced("port", 32)
    assert w.tick(now=float(NOW)) == 32
    flipped = []
    orig = cs.inner.update_many

    def tripwire(docs):
        orig(docs)
        if not flipped:
            flipped.append(1)
            cs.fail_writes = True

    cs.inner.update_many = tripwire
    writes_before = dict(cs.writes)
    assert w.tick(now=NOW + 60.0) == 32
    cs.inner.update_many = orig
    buf = w._degrade.write_behind
    assert 0 < len(buf) < 32
    cs.fail_writes = False
    assert w.tick(now=NOW + 120.0) == 32
    assert len(buf) == 0
    for s in range(32):
        assert cs.writes[f"job-{s}"] - writes_before.get(f"job-{s}", 0) == 2, s
    w.close()


# -- ChunkPipeline extensions ---------------------------------------------


def _pool(n=1):
    return ThreadPoolExecutor(max_workers=n)


def test_pipeline_lazy_iterator_end_sentinel():
    """run() over an unbounded iterator stops at the first END payload
    from fetch, serial and pipelined, and counts only the real chunks."""
    for pool in (None, _pool()):
        seen = []
        budget = [4]

        def fetch(i):
            if budget[0] <= 0:
                return pl.END
            budget[0] -= 1
            return f"payload-{i}"

        pipe = pl.ChunkPipeline(fetch, lambda i, p: (i, p), lambda i, r: seen.append(r), depth=2,
                                prefetch_pool=pool)
        stats = pipe.run(itertools.count())
        assert len(seen) == 4 and stats.chunks == 4 and stats.completed, seen
        if pool is not None:
            pool.shutdown()


def test_pipeline_real_payload_queued_behind_end_still_judged():
    """With 2+ prefetch workers a prepared chunk can sit QUEUED BEHIND the
    END that raced it: END stops submission, not already-prepared work."""
    judged, drained = [], []
    payloads = {0: pl.END, 1: "prep-1"}
    pool = _pool(2)
    pipe = pl.ChunkPipeline(lambda i: payloads.get(i, pl.END), lambda i, p: p, lambda i, r: judged.append(r),
                            depth=3, prefetch_pool=pool, on_drained=lambda i, p: drained.append(p))
    stats = pipe.run(itertools.count())
    assert judged == ["prep-1"] and drained == [] and stats.completed
    pool.shutdown()


def test_pipeline_boundary_hook_runs_between_chunks():
    for pool in (None, _pool()):
        boundaries, order = [], []
        pipe = pl.ChunkPipeline(lambda c: c, lambda c, p: order.append(("judge", c)) or c, lambda c, r: None,
                                depth=2, prefetch_pool=pool, boundary=lambda: boundaries.append(len(order)))
        pipe.run([1, 2, 3])
        assert boundaries == [1, 2, 3]  # after each chunk's judgment
        if pool is not None:
            pool.shutdown()


def test_pipeline_on_drained_gets_unjudged_prefetches():
    """A judge abort drains a running-or-done prefetch through on_drained.
    The judge of chunk 1 raises only once chunk 2's fetch has STARTED (an
    event, not a sleep): a running future cannot be cancelled, so the
    drain must wait for it and hand it back."""
    drained = []
    started = threading.Event()

    def fetch(c):
        if c == 2:
            started.set()
        return f"prep-{c}"

    def judge(c, p):
        if c == 1:
            assert started.wait(30)
            raise RuntimeError("boom")
        return p

    pool = _pool()
    pipe = pl.ChunkPipeline(fetch, judge, lambda c, r: None, depth=3, prefetch_pool=pool,
                            on_drained=lambda c, p: drained.append((c, p)))
    with pytest.raises(RuntimeError):
        pipe.run([1, 2, 3])
    assert (2, "prep-2") in drained, drained
    pool.shutdown(wait=True)


def test_sweep_abort_releases_pooled_and_prepared_docs():
    """A judge-stage death mid-sweep: prepared-but-unjudged slices and the
    pool remainder release un-judged (claimable again), never parked in
    progress; the next sweep judges everything again."""
    w, cs, store, ring, keys, ct = _sliced("port", 32)
    assert w.tick(now=float(NOW)) == 32
    calls = []
    orig = w._uni.judge_columnar_async

    def dying(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device died")
        return orig(*a, **kw)

    w._uni.judge_columnar_async = dying
    with pytest.raises(RuntimeError):
        w.tick(now=NOW + 60.0)
    w._uni.judge_columnar_async = orig
    stuck = [d.id for d in store._docs.values()
             if d.status not in TERMINAL_STATUSES and d.status != STATUS_PREPROCESS_COMPLETED]
    assert stuck == [], stuck
    assert w.tick(now=NOW + 120.0) == 32
    w.close()
