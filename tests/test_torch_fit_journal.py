"""Fit persistence of the port (`models/cache.py` `FitJournal`,
`ingest/snapshot.py`'s record framing, `BrainWorker.enable_fit_persistence`)
against the JAX package's.

A journal the JAX worker wrote restores in the port; a JAX worker and a
port worker, each restarted on its journal, take no history fetch and
write the same statuses; a torn tail or a bad crc degrades to cold fits
of the entries it lost, counted, never a crash."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest

from foremast_tpu.ingest import snapshot as jsnap
from foremast_tpu.models.cache import FitJournal as JaxJournal
from foremast_tpu.models.cache import ModelCache as JaxCache
from foremast_tpu_torch.ingest import snapshot as tsnap
from foremast_tpu_torch.models.cache import FitJournal, ModelCache
from tests.torch_workers import NOW, spike, statuses, worker_pair

SERVICES = 6


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _entries(rng, n):
    return {
        ("moving_average_all", 24, f"app{i}|latency|http://p/h{i}"): (
            float(rng.normal()), 0.0, rng.normal(size=1 + i % 3).astype(np.float32), i % 2,
            float(rng.random()), int(rng.integers(0, 10_080)),
        )
        for i in range(n)
    }


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_crosses_packages(tmp_path, writer):
    """Puts, a delete, a pad key (never journaled), a compaction, then
    more puts: the other package's journal restores the same dict."""
    rng = np.random.default_rng(1)
    entries = _entries(rng, 12)
    Journal, Cache = (JaxJournal, JaxCache) if writer == "jax" else (FitJournal, ModelCache)
    base = str(tmp_path / "fit-fits")
    j = Journal(base)
    cache = Cache(64)
    j.attach(cache)
    items = list(entries.items())
    cache.put_many(items[:6])
    cache.put(("moving_average_all", 24, "__pad__"), items[0][1])
    cache.pop(items[1][0])
    assert j.compact() == 5
    cache.put_many(items[6:])
    j.close()
    want = JaxJournal(base).restore()
    got = FitJournal(base).restore()
    _same(got, want)
    assert len(got) == 11 and items[1][0] not in got
    # the log frames are byte-identical between the packages
    payload = b"\x80\x05record"
    a, b = io.BytesIO(), io.BytesIO()
    assert jsnap.append_record(a, payload) == tsnap.append_record(b, payload)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("damage", ["torn_tail", "bad_crc", "bad_snap"])
def test_damage_degrades_to_cold_fits(tmp_path, damage):
    rng = np.random.default_rng(2)
    items = list(_entries(rng, 8).items())
    base = str(tmp_path / "fit-fits")
    j = FitJournal(base)
    cache = ModelCache(64)
    j.attach(cache)
    if damage == "bad_snap":
        cache.put_many(items[:4])
        j.compact()
        with open(j.snap_path, "r+b") as fh:
            fh.truncate(10)
    for k, v in items[4:]:
        cache.put(k, v)
    j.close()
    size = os.path.getsize(j.log_path)
    if damage == "torn_tail":
        with open(j.log_path, "r+b") as fh:
            fh.truncate(size - 3)
    elif damage == "bad_crc":
        with open(j.log_path, "r+b") as fh:
            fh.seek(size - 1)
            last = fh.read(1)
            fh.seek(size - 1)
            fh.write(bytes([last[0] ^ 0xFF]))
    got, want = FitJournal(base), JaxJournal(base)
    restored = got.restore()
    _same(restored, want.restore())
    if damage == "bad_snap":
        assert list(restored) == [k for k, _ in items[4:]]
        assert got.stats()["discards"] == {"fit_unreadable": 1, "fit_torn": 0}
    else:
        assert list(restored) == [k for k, _ in items[4:7]]  # the last record is lost
        assert got.stats()["discards"] == {"fit_unreadable": 0, "fit_torn": 1}


def _count_hist(worker):
    counts = {"hist": 0}
    orig = worker.source.fetch

    def fetch(url):
        if "hist" in url:
            counts["hist"] += 1
        return orig(url)

    worker.source.fetch = fetch
    return counts


def _restart(jw, pw, jstore, pstore, jsrc, psrc, jdir, pdir):
    """Fresh workers over the same stores and sources, on the journals."""
    (jw2, *_), (pw2, *_) = worker_pair(SERVICES)
    for w, store, src in ((jw2, jstore, jsrc), (pw2, pstore, psrc)):
        w.store, w.source = store, src
    return jw2, pw2, jw2.enable_fit_persistence(jdir), pw2.enable_fit_persistence(pdir)


@pytest.mark.parametrize("journal_of", ["own", "jax"])
def test_restarted_workers_write_the_same_statuses(tmp_path, journal_of):
    """Cold tick on journals, then restarted workers re-check with no
    history fetch and no fit, each on its own journal, or the port on
    the JAX worker's; a spike after the restart flags the same doc."""
    (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(SERVICES)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert not any(jw.enable_fit_persistence(jdir).values())
    assert not any(pw.enable_fit_persistence(pdir).values())
    assert jw.tick(now=NOW + 150) == pw.tick(now=NOW + 150) == SERVICES
    assert statuses(pstore) == statuses(jstore)
    jw.close()
    pw.close()
    jw2, pw2, jrest, prest = _restart(
        jw, pw, jstore, pstore, jsrc, psrc, jdir, jdir if journal_of == "jax" else pdir
    )
    assert prest == jrest  # the refine book's journal too
    assert prest["fits"] == 4 * SERVICES
    jcount, pcount = _count_hist(jw2), _count_hist(pw2)
    assert jw2.tick(now=NOW + 200) == pw2.tick(now=NOW + 200) == SERVICES
    assert jcount["hist"] == pcount["hist"] == 0
    assert pw2._fast_kinds["univariate"] == SERVICES and len(pw2._fit_journals) == 5  # fits, gaps, refine, joint, jmeta
    assert pw2._fit_journals["fits"].stats()["appended_entries"] == 0  # no fit
    assert statuses(pstore) == statuses(jstore)
    spike((jsrc, psrc), "http://prom/cur", "latency:app3")
    jw2.tick(now=NOW + 250)
    pw2.tick(now=NOW + 250)
    assert statuses(pstore) == statuses(jstore)
    assert [k for k, v in statuses(pstore).items() if v[0] == "completed_unhealth"] == ["job-3"]
    jw2.close()
    pw2.close()


def test_run_loop_calls_after_tick_and_stops(tmp_path):
    (_, _, _), (pw, _, _) = worker_pair(2)
    seen = []

    def after(n):
        seen.append(n)
        if len(seen) == 2:
            raise RuntimeError("a failing hook is logged, not raised")

    pw.run(poll_seconds=0.01, stop=lambda: len(seen) >= 3, after_tick=after)
    assert seen[0] == 2 and len(seen) == 3


def test_restarted_joint_worker_takes_the_columnar_path(tmp_path):
    """A mixed fleet under `auto` (job-0 bivariate, job-1 LSTM hybrid,
    ten single-alias docs): the port worker judges it cold on journals,
    then a fresh port worker restarted on that directory restores the
    joint entries and their warm metadata, re-checks every doc on the
    columnar path with no history fetch and no new joint entry, and
    writes the JAX worker's statuses; a spike on the LSTM doc after the
    restart flags it in both."""
    import dataclasses

    import jax

    from benchmarks.worker_bench import build_mixed_fleet
    from foremast_tpu.config import BrainConfig as JaxConfig
    from foremast_tpu.jobs import BrainWorker as JaxWorker
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.interop import joint_entry_from_numpy
    from foremast_tpu_torch.jobs import BrainWorker
    from tests.torch_workers import PortArraySource, port_store

    services, steps = 12, 10

    def cfg(cls):
        c = cls(algorithm="auto", season_steps=24, max_cache_size=4 * services + 64)
        return dataclasses.replace(c, anomaly=dataclasses.replace(c.anomaly, threshold=4.0))

    store, source, _ = build_mixed_fleet(services, 256, 30, NOW, joint_frac=0.17)
    pstore, psrc = port_store(store), PortArraySource(source.data)
    kw = dict(claim_limit=2 * services, worker_id="joint-w")
    jw = JaxWorker(store, source, config=cfg(JaxConfig), device_mesh=None, **kw)

    def port_worker():
        w = BrainWorker(pstore, psrc, config=cfg(BrainConfig), device="cpu", **kw)
        w.judge.lstm_steps = steps
        return w

    jw.judge.lstm_steps = steps
    pw = port_worker()
    pdir = str(tmp_path / "port")
    assert not any(pw.enable_fit_persistence(pdir).values())
    assert jw.tick(now=NOW + 150) == services
    # two trainings never give the same weights: the JAX worker's LSTM
    # entry is carried into the port's cache, and so into its journal
    for key, entry in jw._mvj.cache.snapshot().items():
        if key[0] == "lstm":
            pw._mvj.cache.put(key, joint_entry_from_numpy(jax.tree.map(np.asarray, entry)))
    assert pw.tick(now=NOW + 150) == services
    assert statuses(pstore) == statuses(store)
    first = statuses(pstore)
    pw.close()

    pw2 = port_worker()
    restored = pw2.enable_fit_persistence(pdir)
    assert restored["joint"] >= 2 and restored["jmeta"] >= 2 and restored["fits"] > 0
    count = _count_hist(pw2)
    assert jw.tick(now=NOW + 200) == pw2.tick(now=NOW + 200) == services
    assert count["hist"] == 0
    assert pw2._fast_kinds["bivariate"] == 1 and pw2._fast_kinds["lstm"] == 1
    assert pw2._fit_journals["joint"].stats()["appended_entries"] == 0  # no joint fit
    assert statuses(pstore) == statuses(store) == first
    for src in (source, psrc):  # the LSTM doc's every metric up ~8 sigmas
        for m in range(4):
            url = f"http://prom/cur?q=m{m}:app1&step=60"
            t, v = src.data[url]
            v = v.copy()
            v[-3:] += 0.6
            src.data[url] = (t, v)
    jw.tick(now=NOW + 250)
    pw2.tick(now=NOW + 250)
    assert statuses(pstore) == statuses(store)
    assert statuses(pstore)["job-1"][0] == "completed_unhealth"
    jw.close()
    pw2.close()
