"""The port's reactive plane (`foremast_tpu_torch/reactive/`, the
receiver's `dirty=` hook, `BrainWorker.micro_tick`) against the JAX
package's, after the dirty-set and micro-tick cases of
`tests/test_reactive.py` (its watch-stream cases belong to the watch
plane, ROADMAP.md Queue 1 item 8).

The same operations on both packages' dirty sets answer alike; the
receiver stamps arrivals with its own clock, whatever the codec; and on
the same pure-push fleets, a micro-tick claims just the dirty documents
and writes, cold, warm and spiked, byte for byte what a full tick and the
JAX worker's micro-tick write, through brownouts that requeue arrivals
with their original stamps. The JAX worker's mesh partition filter is
played by the port worker's plain `claim_filter`."""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest
from prometheus_client import CollectorRegistry

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs.store import InMemoryStore as JaxStore
from foremast_tpu.jobs.worker import BrainWorker as JaxWorker
from foremast_tpu.reactive import DirtySet as JaxDirty
from foremast_tpu.reactive import dirty as jdirty
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.ingest import (
    BINARY_CONTENT_TYPE,
    RingSource,
    RingStore,
    encode_frame,
    start_ingest_server,
    stop_ingest_server,
)
from foremast_tpu_torch.jobs import BrainWorker, InMemoryStore
from foremast_tpu_torch.jobs.models import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED
from foremast_tpu_torch.observe.gauges import WorkerMetrics
from foremast_tpu_torch.reactive import DirtySet
from foremast_tpu_torch.reactive import dirty as tdirty
from tests.torch_workers import NOW, push_fleet

# ---------------------------------------------------------------------------
# DirtySet semantics, each script run on both packages' sets
# ---------------------------------------------------------------------------


def _coalesce(d):
    d.mark("b", 2.0)
    d.mark("a", 5.0)
    d.mark("a", 3.0)  # coalescing keeps the EARLIEST arrival
    d.mark("a", 9.0)  # a later arrival never advances the stamp
    return [len(d), d.take(1), d.take(8), len(d)]


def _bounded(d):
    for i in range(10):
        d.mark(f"k{i}", float(i))
    return [len(d), d.take_all()]


def _route_keys(d):
    out = [d.mark_series('up{app="svc1",ns="x"}', now=1.0), d.take_all(),
           d.mark_series("sum(rate(x[5m]))", now=2.0), d.take_all()]
    d.owned.append('up{app="svc2"}')
    return out + [d.mark_series('up{app="svc2"}', now=3.0), len(d)]


def _requeue(d):
    d.mark("app", 10.0)
    (k, stamp), = d.take(1)
    d.mark(k, stamp, requeue=True)
    return [d.take_all()]


def _requeue_front(d):
    d.mark("old", 1.0)
    (k, stamp), = d.take(1)
    d.mark("fresh", 50.0)
    d.mark(k, stamp, requeue=True)
    return [d.take(1), d.take_all()]


@pytest.mark.parametrize(
    "script,kw,want",
    [
        (_coalesce, {"max_keys": 16}, [2, [("b", 2.0)], [("a", 3.0)], 0]),
        (_bounded, {"max_keys": 3}, [3, [("k7", 7.0), ("k8", 8.0), ("k9", 9.0)]]),
        (_route_keys, {}, [True, [("svc1", 1.0)], True, [("sum(rate(x[5m]))", 2.0)], False, 0]),
        (_requeue, {}, [[("app", 10.0)]]),
        (_requeue_front, {}, [[("old", 1.0)], [("fresh", 50.0)]]),
    ],
    ids=["coalesce_earliest_oldest_first", "bounded_drop_oldest", "route_keys_and_ownership",
         "requeue_keeps_stamp", "requeue_drains_first"],
)
def test_dirty_set_answers_as_jax(script, kw, want):
    """Coalescing to the earliest stamp and oldest-first takes; the cap
    drops the oldest, counted, never a leak; route keys from the `app`
    label (else the whole canonical key) and the ownership predicate's
    `foreign` count; a requeue keeps its original stamp, re-enters at the
    FRONT, and counts `requeued`, not `marked`."""
    got = []
    for cls in (DirtySet, JaxDirty):
        owned: list = []
        d = cls(owns=lambda key, _o=owned: key not in _o, **kw)
        d.owned = owned
        got.append((script(d), d.counts(), {k: v for k, v in d.debug_state().items() if k != "tenant_fair"}))
    assert got[0] == got[1]
    assert got[0][0] == want


def test_reactive_knob_parsing_tolerates_malformed_env(monkeypatch):
    """An empty or garbled knob warns and takes its default, on both."""
    monkeypatch.setenv("FOREMAST_MICROTICK_SECONDS", "")
    monkeypatch.setenv("FOREMAST_MICROTICK_DOCS", "nope")
    monkeypatch.setenv("FOREMAST_MICROTICK_DIRTY_MAX", "1e4")
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "")
    for mod in (tdirty, jdirty):
        assert mod.microtick_seconds_from_env() == 0.0
        assert mod.microtick_docs_from_env() == 256
        assert mod.sweep_slice_docs_from_env() == 2048
        assert mod.DirtySet.from_env().max_keys == 8192
    # the tenant plane replaced the old refusal: under FOREMAST_TENANTS
    # both packages' sets drain tenant-fair with the same weights, and a
    # malformed envelope fails loudly on both
    from foremast_tpu.tenant import registry as jreg
    from foremast_tpu_torch.tenant import registry as treg

    monkeypatch.setenv("FOREMAST_TENANTS", '{"a": {}, "b": {"weight": 2}}')
    for reg_mod, mod in ((treg, tdirty), (jreg, jdirty)):
        monkeypatch.setattr(reg_mod, "_GLOBAL", None)
        monkeypatch.setattr(reg_mod, "_GLOBAL_SET", False)
        d = mod.DirtySet.from_env()
        assert d.tenancy.weights() == {"a": 1.0, "b": 2.0}
        assert d.debug_state()["tenant_fair"] is True
    monkeypatch.setenv("FOREMAST_TENANTS", "a,b")
    for reg_mod, mod in ((treg, tdirty), (jreg, jdirty)):
        monkeypatch.setattr(reg_mod, "_GLOBAL_SET", False)
        with pytest.raises(ValueError):
            mod.DirtySet.from_env()


def test_dirty_set_loses_no_arrival_under_concurrent_marks_and_takes():
    """Receiver threads mark while the tick thread takes: with more
    marking threads than cores and a tiny switch interval, every
    insertion (`marked`: a key not pending when it arrived) is taken
    exactly once, every other mark coalesced, and no key is lost."""
    import os
    import sys
    import threading

    n_threads, per_thread = 2 * (os.cpu_count() or 4) + 2, 400
    d = DirtySet(max_keys=n_threads * per_thread)
    taken: list = []
    done = threading.Event()

    def marker(t):
        for i in range(per_thread):
            d.mark(f"k{t}-{i}", float(i))
            d.mark(f"k{t}-{i}", float(i) + 1.0)  # coalesces

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
    c = d.counts()
    assert len(set(keys)) == n_threads * per_thread and c["dropped"] == 0
    assert len(keys) == c["marked"] and c["marked"] + c["coalesced"] == 2 * n_threads * per_thread


# ---------------------------------------------------------------------------
# the receiver's arrival clock
# ---------------------------------------------------------------------------


def _post(port: int, body: bytes, ctype: str) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/write", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("codec", ["json", "fmw1"])
def test_receiver_stamps_arrival_with_its_own_clock_not_the_pushers(codec):
    """Samples decades in the past (a skewed or replaying pusher) are
    stamped with the receiver's wall clock; a re-push of the same stamps
    (a last-write-wins revision) marks again and coalesces."""
    ring = RingStore(shards=1)
    dirty = DirtySet()
    srv, _ = start_ingest_server(0, ring, host="127.0.0.1", dirty=dirty)

    def body(values):
        t = np.array([1_000_000_000, 1_000_000_060], np.int64)
        v = np.array(values, np.float32)
        if codec == "fmw1":
            return encode_frame([('m{app="skewed"}', t, v, None)]), BINARY_CONTENT_TYPE
        return json.dumps({"timeseries": [{"alias": 'm{app="skewed"}', "times": t.tolist(),
                                           "values": v.tolist()}]}).encode(), "application/json"

    try:
        port = srv.server_address[1]
        before = time.time()
        assert _post(port, *body([1.0, 2.0]))["accepted_samples"] == 2
        (key, stamp), = dirty.take_all()
        assert key == "skewed" and before - 1.0 <= stamp <= time.time() + 1.0
        assert _post(port, *body([1.0, 9.0]))["accepted_samples"] == 2
        assert len(dirty) == 1 and dirty.counts()["marked"] == 2
    finally:
        stop_ingest_server(srv)


# ---------------------------------------------------------------------------
# micro-ticks
# ---------------------------------------------------------------------------


def _worker(pkg, store, ring, services, **kw):
    if pkg == "jax":
        from foremast_tpu import ingest as J

        return JaxWorker(store, J.RingSource(ring, fallback=None),
                         config=JaxConfig(algorithm="moving_average_all", season_steps=24,
                                          max_cache_size=services + 16),
                         claim_limit=max(services, 4), worker_id="reactive-w", device_mesh=None, **kw)
    return BrainWorker(store, RingSource(ring, fallback=None),
                       config=BrainConfig(algorithm="moving_average_all", season_steps=24,
                                          max_cache_size=services + 16),
                       device="cpu", claim_limit=max(services, 4), worker_id="reactive-w", **kw)


def _statuses(store) -> dict:
    return {d.id: (d.status, d.status_code, d.reason, d.anomaly_info) for d in store._docs.values()}


def _reactive_pair(services, **kw):
    """[(worker, store, ring, keys, dirty)] for the JAX and the port
    package over the same pure-push fleet, each with its own dirty set."""
    out = []
    for pkg, cls in (("jax", JaxDirty), ("port", DirtySet)):
        store, ring, keys, _, ct = push_fleet(pkg, services)
        dirty = cls()
        out.append((_worker(pkg, store, ring, services, dirty=dirty, **kw), store, ring, keys, dirty))
    return out, ct


def test_micro_tick_claims_only_dirty_docs():
    pair, _ = _reactive_pair(3)
    for w, store, _, keys, dirty in pair:
        assert w.micro_tick(now=NOW + 150) == 0  # nothing dirty, no claim
        dirty.mark_series(keys[1], now=NOW)
        assert w.micro_tick(now=NOW + 150) == 1
        sts = {d.id: d.status for d in store._docs.values()}
        assert sts == {"job-0": "initial", "job-1": STATUS_PREPROCESS_COMPLETED, "job-2": "initial"}
        assert len(dirty) == 0 and dirty.counts()["unattributed"] == 0
    assert _statuses(pair[1][1]) == _statuses(pair[0][1])


def test_micro_tick_status_byte_identical_to_full_tick():
    """The tick-path parity pin: the same docs judged by a port
    micro-tick, a port full tick and a JAX micro-tick write the same
    statuses, reasons and anomaly payloads: a cold first judgment, then a
    spiked warm re-check of one doc."""
    pair, ct = _reactive_pair(3)
    tick_store, tick_ring, tick_keys, _, _ = push_fleet("port", 3)
    ticked = _worker("port", tick_store, tick_ring, 3)
    assert ticked.tick(now=NOW + 150) == 3
    for w, _, _, keys, dirty in pair:
        for k in keys:
            dirty.mark_series(k, now=NOW)
        assert w.micro_tick(now=NOW + 150) == 3
    assert _statuses(pair[1][1]) == _statuses(tick_store) == _statuses(pair[0][1])

    spike = np.full(3, 40.0, np.float32)
    for ring, keys in ((tick_ring, tick_keys), (pair[0][2], pair[0][3]), (pair[1][2], pair[1][3])):
        ring.push(keys[1], ct[-3:], spike, now=NOW)
    assert ticked.tick(now=NOW + 300) == 3
    for w, _, _, keys, dirty in pair:
        dirty.mark_series(keys[1], now=NOW)
        assert w.micro_tick(now=NOW + 300) == 1
    want = _statuses(tick_store)["job-1"]
    assert want[0] == STATUS_COMPLETED_UNHEALTH
    assert _statuses(pair[1][1])["job-1"] == want == _statuses(pair[0][1])["job-1"]


class _StubMesh:
    """The JAX worker's mesh surface: a claim filter rejecting an app set."""

    handoff = None
    draining = False

    def __init__(self, rejected):
        self.rejected = set(rejected)

    def on_tick(self):
        pass

    def claim_filter(self, doc) -> bool:
        return doc.app_name not in self.rejected

    def debug_state(self):
        return {"stub": True}


def test_micro_tick_composes_with_a_base_claim_filter():
    """A dirty key whose doc the base claim filter rejects is never
    claimed, and its arrival is dropped as unattributed, not leaked: the
    port's plain `claim_filter` composes as the JAX worker's mesh
    partition filter does."""
    got = []
    for pkg, cls in (("jax", JaxDirty), ("port", DirtySet)):
        store, ring, keys, _, _ = push_fleet(pkg, 2)
        dirty = cls()
        if pkg == "jax":
            w = _worker(pkg, store, ring, 2, dirty=dirty, mesh=_StubMesh({"app0"}))
        else:
            w = _worker(pkg, store, ring, 2, dirty=dirty)
            w.claim_filter = lambda d: d.app_name != "app0"  # the mesh's filter, once item 7 sets it
        dirty.mark_series(keys[0], now=NOW)
        dirty.mark_series(keys[1], now=NOW)
        assert w.micro_tick(now=NOW + 150) == 1
        assert {d.id: d.status for d in store._docs.values()} == {"job-0": "initial",
                                                                   "job-1": STATUS_PREPROCESS_COMPLETED}
        assert dirty.counts()["unattributed"] == 1
        got.append(_statuses(store))
    assert got[0] == got[1]


def _brownout(base):
    class Brownout(base):
        """The first claim fails transiently (a store brownout)."""

        fail_claims = 1

        def claim(self, *a, **kw):
            if self.fail_claims > 0:
                self.fail_claims -= 1
                raise ConnectionError("injected store brownout")
            return super().claim(*a, **kw)

    return Brownout()


def test_micro_tick_claim_brownout_requeues_arrivals_unspent():
    """A store brownout mid-micro-tick loses no arrival: the pending key
    goes back with its ORIGINAL stamp, and the next cycle judges it."""
    for pkg, cls, base in (("jax", JaxDirty, JaxStore), ("port", DirtySet, InMemoryStore)):
        store, ring, keys, _, _ = push_fleet(pkg, 1)
        brown = _brownout(base)
        for d in list(store._docs.values()):
            brown.create(d)
        dirty = cls()
        w = _worker(pkg, brown, ring, 1, dirty=dirty)
        dirty.mark_series(keys[0], now=NOW)
        assert w.micro_tick(now=NOW + 150) == 0  # degraded to an empty tick
        assert dirty.counts()["requeued"] == 1
        assert dirty.take_all() == [("app0", NOW)]  # the original stamp
        dirty.mark("app0", NOW, requeue=True)
        assert w.micro_tick(now=NOW + 150) == 1  # healed: judged
        assert brown._docs["job-0"].status == STATUS_PREPROCESS_COMPLETED


class _FlakySource:
    """Delegates to a RingSource but fails the first fetch transiently."""

    concurrent_fetch = False

    def __init__(self, inner, fail_fetches: int):
        self.inner = inner
        self.fail_fetches = fail_fetches

    def fetch(self, url):
        if self.fail_fetches > 0:
            self.fail_fetches -= 1
            raise ConnectionError("injected fetch outage")
        return self.inner.fetch(url)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_micro_tick_fetch_outage_releases_docs_and_requeues_arrival():
    """A dependency outage during a micro-tick RELEASES the dirty doc
    un-judged (claimable, no verdict, counted `fetch_released`) and gives
    the arrival back with its original stamp; the healed micro-tick
    judges it, as the JAX worker does."""
    got = []
    for pkg, cls in (("jax", JaxDirty), ("port", DirtySet)):
        store, ring, keys, _, _ = push_fleet(pkg, 1)
        dirty = cls()
        w = _worker(pkg, store, ring, 1, dirty=dirty)
        w.source = _FlakySource(w.source, fail_fetches=1)
        w._ring_hist = w.source.hist_columns
        dirty.mark_series(keys[0], now=NOW)
        w.micro_tick(now=NOW + 150)
        doc = store._docs["job-0"]
        assert doc.status == STATUS_PREPROCESS_COMPLETED and doc.anomaly_info is None
        assert w._degrade.stats.docs_snapshot().get("fetch_released") == 1
        assert dirty.take_all() == [("app0", NOW)]
        dirty.mark("app0", NOW, requeue=True)
        assert w.micro_tick(now=NOW + 150) == 1
        got.append(_statuses(store))
    assert got[0] == got[1]


def _sample(registry, name, labels):
    for metric in registry.collect():
        for s in metric.samples:
            if s.name == name and all(s.labels.get(k) == v for k, v in labels.items()):
                return s.value
    return None


def test_verdict_latency_histogram_micro_and_sweep_paths():
    """A micro-tick's verdict observes path="micro", the full sweep's
    catch-all path="sweep", both from the receiver's stamp on the real
    clock and with tenant="default"; the micro-tick doc counter counts
    the micro-judged doc."""
    registry = CollectorRegistry()
    store, ring, _, _, _ = push_fleet("port", 2)
    dirty = DirtySet()
    w = _worker("port", store, ring, 2, dirty=dirty, metrics=WorkerMetrics(registry=registry))
    dirty.mark("app0", time.time() - 1.2)
    assert w.micro_tick(now=NOW + 150) == 1
    n = _sample(registry, "foremast_verdict_latency_seconds_count", {"path": "micro", "tenant": "default"})
    total = _sample(registry, "foremast_verdict_latency_seconds_sum", {"path": "micro"})
    assert n == 1 and 1.0 <= total <= 30.0
    dirty.mark("app1", time.time() - 0.5)
    assert w.tick(now=NOW + 150) >= 1
    assert _sample(registry, "foremast_verdict_latency_seconds_count", {"path": "sweep", "tenant": "default"}) == 1
    assert _sample(registry, "foremast_microtick_docs_total", {}) == 1
    state = w.debug_state()["reactive"]
    assert state["last_micro"]["runs"] == 1 and state["dirty"]["marked"] == 2 and state["dirty"]["pending"] == 0


def test_run_loop_micro_drains_between_sweeps():
    """`run` in reactive mode: between sweeps (poll far longer than the
    test), the micro drain judges a pushed doc within a few micro-tick
    periods, and the loop stops on request."""
    import threading

    # anchored to the real clock, the windows open: the docs stay open re-checks
    store, ring, keys, _, _ = push_fleet("port", 2, t_now=time.time(), open_window=True)
    dirty = DirtySet()
    w = _worker("port", store, ring, 2, dirty=dirty)
    w.microtick_seconds = 0.01
    stop = threading.Event()
    swept = threading.Event()
    thread = threading.Thread(target=w.run, kwargs=dict(poll_seconds=60.0, stop=stop.is_set,
                                                        after_tick=lambda n: swept.set()))
    thread.start()
    try:
        assert swept.wait(30)  # the first sweep judged both docs cold
        runs = w._last_micro["runs"]
        dirty.mark_series(keys[1])
        deadline = time.monotonic() + 30
        while w._last_micro["runs"] == runs and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w._last_micro["runs"] == runs + 1 and w._last_micro["docs"] == 1
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
