"""The port's ring durability (`foremast_tpu_torch/ingest/snapshot.py`)
against the JAX package's: a snapshot directory written by either
package's `RingSnapshotter` restores in the other with equal ring
contents; restores from snapshot plus log, log alone, rotated
generations, and damaged files degrade per series or shard with the
discard counts JAX gives; the snapshot cadence, the directory lock, the
fit journals' restores and the `foremast_snapshot_*` families behave
alike. JAX's lock-witness
fixture over its snapshot suite is not ported (ROADMAP.md Queue 1
item 8)."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
from prometheus_client import CollectorRegistry

from foremast_tpu import ingest as J
from foremast_tpu.ingest import snapshot as jsnap
from foremast_tpu_torch import ingest as T
from foremast_tpu_torch.ingest import snapshot as tsnap

NOW = 1_760_000_000.0
PKGS = {"port": T, "jax": J}


def _fill(store, n=10, now=NOW, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(now) - 600, int(now), 60, np.int64)
    for i in range(n):
        store.push(f'm{{app="a{i}"}}', t, rng.normal(1.0, 0.2, len(t)).astype(np.float32), start=float(t[0]),
                   now=now)
    return t


def _contents(store) -> dict:
    """key -> (times, values, coverage spans) of every resident series."""
    out = {}
    for i in range(store.shard_count):
        for key, t, v, cf, ct, extras in store.shard_state(i):
            out[key] = (t, v, [tuple(iv) for iv in extras] + [(cf, ct)])
    return out


def _same_contents(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, (t, v, cov) in want.items():
        gt, gv, gcov = got[key]
        assert np.array_equal(gt, t) and np.array_equal(gv.view(np.uint32), v.view(np.uint32)), key
        assert gcov == cov, key


def _write(m, directory, seed, snapshot: bool, shards=4):
    """Journal pushes (a historical backfill beside a live stream, plus
    revisions), snapshot them if asked, then push more into the log."""
    rng = np.random.default_rng(seed)
    store = m.RingStore(shards=shards, stale_seconds=300.0)
    snap = m.RingSnapshotter(store, directory, clock=lambda: NOW)
    snap.restore()
    snap.attach()
    t = _fill(store, n=12, seed=seed)
    old = np.arange(int(NOW) - 50_000, int(NOW) - 48_200, 60, np.int64)
    store.push('m{app="a3"}', old, np.ones(len(old), np.float32), start=float(old[0]), end=float(old[-1]),
               record_lag=False)
    store.push("empty", (), (), start=NOW - 900.0, end=NOW - 600.0, record_lag=False)
    if snapshot:
        snap.snapshot()
    t2 = np.arange(int(NOW), int(NOW) + 180, 60, np.int64)
    store.push('m{app="a0"}', t2, rng.normal(5, 1, len(t2)).astype(np.float32), now=NOW)
    store.push('m{app="a1"}', t[-3:], np.full(3, 9.0, np.float32), now=NOW)  # a revision
    snap.close()
    return store


@pytest.mark.parametrize("snapshot", [True, False], ids=["snapshot_and_log", "log_only"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_a_directory_restores_across_packages(tmp_path, writer, reader, seed, snapshot):
    written = _write(PKGS[writer], str(tmp_path), seed, snapshot)
    m = PKGS[reader]
    store = m.RingStore(shards=2, stale_seconds=300.0)  # another shard count than the writer's
    stats = m.RingSnapshotter(store, str(tmp_path), clock=lambda: NOW + 60).restore()
    assert not any(stats["discards"].values()) and stats["restored_series"] == 13
    _same_contents(_contents(store), _contents(written))
    # and the restored store answers as the written one does
    for key in ('m{app="a0"}', 'm{app="a3"}', "empty"):
        for t0, t1 in ((NOW - 600, NOW + 120), (NOW - 50_000, NOW - 48_260), (NOW - 900, NOW - 600)):
            a = store.query(key, t0, t1, NOW + 60)
            b = written.query(key, t0, t1, NOW + 60)
            assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def test_both_packages_restore_the_same_stats_from_one_directory(tmp_path):
    _write(J, str(tmp_path), 3, snapshot=True)
    stats, stores = {}, {}
    for name, m in PKGS.items():
        stores[name] = m.RingStore(shards=4, stale_seconds=300.0)
        stats[name] = m.RingSnapshotter(stores[name], str(tmp_path), clock=lambda: NOW + 60).restore()
    assert stats["port"] == stats["jax"]
    _same_contents(_contents(stores["port"]), _contents(stores["jax"]))


def test_snapshot_files_are_byte_identical_to_jax(tmp_path):
    dirs = {name: str(tmp_path / name) for name in PKGS}
    for name, m in PKGS.items():
        store = m.RingStore(shards=2, stale_seconds=300.0)
        snap = m.RingSnapshotter(store, dirs[name], clock=lambda: NOW)
        snap.attach()
        _fill(store, n=6, seed=4)
        log_bytes = {f: open(os.path.join(dirs[name], f), "rb").read() for f in os.listdir(dirs[name])
                     if f.endswith(".log")}
        snap.snapshot()
        snap.close()
        dirs[name] = (log_bytes, {f: np.load(os.path.join(dirs[name], f)) for f in os.listdir(dirs[name])
                                  if f.endswith(".npz")})
    (tlog, tnpz), (jlog, jnpz) = dirs["port"], dirs["jax"]
    assert tlog == jlog and set(tnpz) == set(jnpz)
    for f in tnpz:
        assert tnpz[f].files == jnpz[f].files
        for k in tnpz[f].files:
            assert np.array_equal(tnpz[f][k], jnpz[f][k], equal_nan=tnpz[f][k].dtype.kind == "f")


# ---------------------------------------------------------------------------
# restores that crashes and damage leave behind
# ---------------------------------------------------------------------------


def _store(shards=4):
    return T.RingStore(shards=shards, stale_seconds=300.0)


def _restore(directory, shards=4, **kw):
    """(port store, port stats, jax stats) of restoring `directory`."""
    out = []
    for m in (T, J):
        store = m.RingStore(shards=shards, stale_seconds=300.0)
        out.append((store, m.RingSnapshotter(store, directory, **kw).restore()))
    assert out[0][1] == out[1][1]
    _same_contents(_contents(out[0][0]), _contents(out[1][0]))
    return out[0][0], out[0][1]


def test_restore_replays_rotated_log_after_crash_mid_snapshot(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    snap1.attach()
    t = _fill(s1, n=3)
    rotated = snap1._logs[0].rotate()  # the crash window: rotated, no snapshot written
    assert rotated and os.path.exists(rotated)
    snap1.close()
    s2, stats = _restore(str(tmp_path), shards=1, clock=lambda: NOW + 30)
    assert stats["restored_samples"] == 30
    assert s2.query('m{app="a2"}', float(t[0]), float(t[-1]), NOW + 30)[0] == "hit"


def test_repeated_crash_mid_snapshot_never_clobbers_earlier_rotation(tmp_path):
    t = np.arange(int(NOW) - 600, int(NOW), 60, np.int64)
    for k, app in enumerate(("first", "second")):
        s = _store(shards=1)
        snap = T.RingSnapshotter(s, str(tmp_path), clock=lambda: NOW + 30 * k)
        assert snap.restore()["restored_series"] == k
        snap.attach()
        s.push(f'm{{app="{app}"}}', t, np.ones(len(t), np.float32), now=NOW)
        snap._logs[0].rotate()
        snap.close()
    base = os.path.join(str(tmp_path), "ring-0.log")
    assert len(tsnap.rotated_logs(base)) == 2 and tsnap.rotated_logs(base) == jsnap.rotated_logs(base)
    s3, stats = _restore(str(tmp_path), shards=1, clock=lambda: NOW + 60)
    assert stats["restored_series"] == 2
    snap3 = T.RingSnapshotter(s3, str(tmp_path), clock=lambda: NOW + 60)
    snap3.snapshot()  # a completed pass clears the generations
    assert tsnap.rotated_logs(base) == []
    snap3.close()


def _snap_files(tmp_path):
    return sorted(str(p) for p in tmp_path.iterdir() if p.name.endswith(".snap.npz"))


def test_truncated_snapshot_file_degrades_that_shard_only(tmp_path):
    s1 = _store(shards=2)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    snap1.attach()
    _fill(s1, n=12)
    snap1.snapshot()
    snap1.close()
    path = _snap_files(tmp_path)[0]
    raw = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    _, stats = _restore(str(tmp_path), shards=2, clock=lambda: NOW + 30)
    assert stats["discards"]["unreadable"] == 1 and 0 < stats["restored_series"] < 12


def test_version_mismatched_snapshot_header_is_discarded(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    _fill(s1, n=3)
    snap1.snapshot()
    snap1.close()
    path = _snap_files(tmp_path)[0]
    with np.load(path, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    arrays["version"] = np.asarray([999], np.int64)
    np.savez(path.replace(".npz", ""), **arrays)
    _, stats = _restore(str(tmp_path), shards=1, clock=lambda: NOW + 30)
    assert stats["discards"]["version"] == 1 and stats["restored_series"] == 0


def test_torn_append_log_tail_replays_healthy_prefix(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    snap1.attach()
    t = _fill(s1, n=5)
    snap1.close()
    log_path = os.path.join(str(tmp_path), "ring-0.log")
    raw = open(log_path, "rb").read()
    with open(log_path, "wb") as fh:
        fh.write(raw[:-7])  # cut mid-record
    s2, stats = _restore(str(tmp_path), shards=1, clock=lambda: NOW + 30)
    assert stats["discards"]["torn_log"] == 1 and stats["restored_series"] == 4
    assert s2.query('m{app="a0"}', float(t[0]), float(t[-1]), NOW + 30)[0] == "hit"
    assert s2.query('m{app="a4"}', float(t[0]), float(t[-1]), NOW + 30)[0] == "miss"


def test_mid_record_garbage_does_not_resync_later_frames(tmp_path):
    path = os.path.join(str(tmp_path), "x.log")
    with open(path, "wb") as fh:
        tsnap.append_record(fh, b"good-1")
        fh.write(tsnap._LOG_HEADER.pack(tsnap._LOG_MAGIC, 10_000_000, 0))
        fh.write(b"\x00" * 64)
        tsnap.append_record(fh, b"good-2-unreachable")
    got = list(tsnap.read_records(path))
    assert got == [(b"good-1", None), (None, "torn_log")] == list(jsnap.read_records(path))


def test_snapshot_mid_eviction_broken_series_degrades_per_series(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    t = _fill(s1, n=4)
    snap1.snapshot()
    snap1.close()
    path = _snap_files(tmp_path)[0]
    with np.load(path, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    del arrays["v1"]
    arrays["t2"] = arrays["t2"][:-3]
    np.savez(path.replace(".npz", ""), **arrays)
    s2, stats = _restore(str(tmp_path), shards=1, clock=lambda: NOW + 30)
    assert stats["discards"]["series"] == 2 and stats["restored_series"] == 2
    assert s2.query('m{app="a0"}', float(t[0]), float(t[-1]), NOW + 30)[0] == "hit"
    assert s2.query('m{app="a1"}', float(t[0]), float(t[-1]), NOW + 30)[0] == "miss"


def test_log_replay_applies_the_age_cutoff_too(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    snap1.attach()
    old_t = np.arange(int(NOW) - 9 * 86_400, int(NOW) - 9 * 86_400 + 300, 60, np.int64)
    s1.push('m{app="ancient"}', old_t, np.ones(len(old_t), np.float32), now=NOW, record_lag=False)
    fresh_t = _fill(s1, n=1)
    snap1.close()
    s2, stats = _restore(str(tmp_path), shards=1, max_age_seconds=86_400.0, clock=lambda: NOW + 60)
    assert stats["restored_series"] == 1 and stats["discards"]["stale"] == 1
    assert s2.query('m{app="a0"}', float(fresh_t[0]), float(fresh_t[-1]), NOW + 60)[0] == "hit"
    assert s2.query('m{app="ancient"}', None, None, NOW + 60)[0] == "miss"


def test_restore_age_cutoff_discards_ancient_series(tmp_path):
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    _fill(s1, n=2)
    snap1.snapshot()
    snap1.close()
    _, stats = _restore(str(tmp_path), shards=1, max_age_seconds=86_400.0, clock=lambda: NOW + 7 * 86_400)
    assert stats["restored_series"] == 0 and stats["discards"]["stale"] == 2


def test_restore_across_a_shard_count_change(tmp_path):
    s1 = _store(shards=4)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    snap1.attach()
    t = _fill(s1, n=12)
    snap1.snapshot()
    t2 = np.arange(int(NOW), int(NOW) + 120, 60, np.int64)
    s1.push('m{app="a7"}', t2, np.full(len(t2), 9.0, np.float32), now=NOW)
    snap1.close()
    s2, stats = _restore(str(tmp_path), shards=2, clock=lambda: NOW + 30)
    assert stats["restored_series"] == 12 and not any(stats["discards"].values())
    st, _, vv = s2.query('m{app="a7"}', float(t[0]), NOW + 120, NOW + 30)
    assert st == "hit" and vv[-1] == 9.0


def test_restore_into_smaller_ring_clamps_older_spans(tmp_path):
    base = int(NOW)
    s1 = _store(shards=1)
    snap1 = T.RingSnapshotter(s1, str(tmp_path), clock=lambda: NOW)
    h0, h1 = base - 50_000, base - 48_200
    old_t = np.arange(h0, h1, 60, np.int64)
    s1.push("m", old_t, np.ones(len(old_t), np.float32), start=float(h0), end=float(h1))
    live_t = np.arange(base - 64 * 60, base, 60, np.int64)
    s1.push("m", live_t, np.ones(len(live_t), np.float32))
    snap1.snapshot()
    snap1.close()
    states = []
    for m in (T, J):
        s2 = m.RingStore(shards=1, stale_seconds=300.0, max_points=64)
        assert m.RingSnapshotter(s2, str(tmp_path), clock=lambda: NOW + 30).restore()["restored_series"] == 1
        states.append((s2.hist_query("m", float(h0), float(h1), now=NOW + 30)[0],
                       s2.query("m", float(base - 64 * 60), None, now=NOW + 30)[0]))
    assert states[0] == states[1] and states[0][0] != "full" and states[0][1] == "hit"


# ---------------------------------------------------------------------------
# cadence, lock, exposition
# ---------------------------------------------------------------------------


def test_maybe_snapshot_cadence_interval_and_log_budget(tmp_path):
    s1 = _store(shards=1)
    clock = [NOW]
    snap1 = T.RingSnapshotter(s1, str(tmp_path), interval_seconds=60.0, log_max_bytes=200, clock=lambda: clock[0])
    snap1.restore()
    snap1.attach()
    assert snap1.maybe_snapshot()  # the first call: due since the epoch
    assert not snap1.maybe_snapshot()
    clock[0] = NOW + 61
    assert snap1.maybe_snapshot()
    clock[0] = NOW + 62
    _fill(s1, n=4)  # past the 200-byte log budget
    assert snap1.maybe_snapshot()
    assert snap1.counters["snapshots"] == 3
    snap1.close()


def test_snapshot_dir_exclusivity_flock(tmp_path):
    first = T.lock_snapshot_dir(str(tmp_path))
    assert first is not None
    assert T.lock_snapshot_dir(str(tmp_path)) is None
    assert J.lock_snapshot_dir(str(tmp_path)) is None  # one lock file for both packages
    first.close()
    again = T.lock_snapshot_dir(str(tmp_path))
    assert again is not None
    again.close()


def test_from_env_reads_the_snapshot_knobs(tmp_path):
    snap = T.RingSnapshotter.from_env(_store(), str(tmp_path), {
        "FOREMAST_SNAPSHOT_INTERVAL_SECONDS": "7", "FOREMAST_SNAPSHOT_MAX_AGE_SECONDS": "99",
        "FOREMAST_SNAPSHOT_LOG_MAX_BYTES": "1234"})
    assert (snap.interval_seconds, snap.max_age_seconds, snap.log_max_bytes) == (7.0, 99.0, 1234)
    snap.close()


def test_snapshot_collector_families_equal_jax(tmp_path):
    from foremast_tpu.models.cache import FitJournal as JaxFitJournal
    from foremast_tpu.models.cache import ModelCache as JaxCache
    from foremast_tpu_torch.models.cache import FitJournal, ModelCache

    regs = {}
    for name, m, journal, cache in (("port", T, FitJournal, ModelCache), ("jax", J, JaxFitJournal, JaxCache)):
        d = tmp_path / name
        s1 = m.RingStore(shards=1, stale_seconds=300.0)
        snap1 = m.RingSnapshotter(s1, str(d), clock=lambda: NOW)
        snap1.restore()
        snap1.attach()
        _fill(s1, n=2)
        snap1.snapshot()
        c = cache(max_size=8)
        j = journal(str(d / "fit-z"))
        c.restore_lazy(j.restore())
        j.attach(c)
        c.put("k", 1)
        reg = CollectorRegistry()
        reg.register(m.SnapshotCollector(snap1, journals=[j]))
        regs[name] = {(s.name, tuple(sorted(s.labels.items()))): (fam.type, s.value)
                      for fam in reg.collect() for s in fam.samples if s.name != "foremast_snapshot_age_seconds"}
        assert reg.get_sample_value("foremast_snapshot_age_seconds") >= 0.0
        snap1.close()
        j.close()
    assert regs["port"] == regs["jax"]
    assert regs["port"][("foremast_snapshot_writes_total", ())] == ("counter", 1.0)


def test_worker_debug_state_durability_section(tmp_path, monkeypatch):
    from foremast_tpu_torch.jobs import BrainWorker, InMemoryStore
    from foremast_tpu_torch.metrics.source import MetricSource

    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")
    worker = BrainWorker(InMemoryStore(), MetricSource(), device="cpu", worker_id="dbg")
    assert worker.debug_state()["durability"] is None
    worker.enable_fit_persistence(str(tmp_path))
    snap = T.RingSnapshotter(_store(shards=1), str(tmp_path), clock=lambda: NOW)
    worker.attach_ring_snapshotter(snap)
    state = worker.debug_state()["durability"]
    assert set(state["fit_journals"]) >= {"fits", "gaps"}
    assert state["ring"]["directory"] == str(tmp_path)
    worker._maybe_persist()  # the tick loop's cadence: the first pass is due
    assert snap.counters["snapshots"] == 1
    worker.close()
    snap.close()


def test_read_record_stream_is_the_shared_frame_decoder():
    buf = io.BytesIO()
    for payload in (b"alpha", b"beta", b"gamma"):
        tsnap.append_record(buf, payload)
    assert list(tsnap.read_record_stream(io.BytesIO(buf.getvalue()))) == [
        (b"alpha", None), (b"beta", None), (b"gamma", None)]
    torn = list(tsnap.read_record_stream(io.BytesIO(buf.getvalue()[:-3])))
    assert torn[:2] == [(b"alpha", None), (b"beta", None)] and torn[-1] == (None, "torn_log")
    raw = bytearray(buf.getvalue())
    raw[len(raw) // 2] ^= 0xFF
    got = list(tsnap.read_record_stream(io.BytesIO(bytes(raw))))
    assert (None, "torn_log") in got and len(got) <= 3
    assert got == list(jsnap.read_record_stream(io.BytesIO(bytes(raw))))


# ---------------------------------------------------------------------------
# fit journals and the lazy cache overlay (the durability plane's other half)
# ---------------------------------------------------------------------------


def _cache_pkgs():
    from foremast_tpu.models import cache as jcache
    from foremast_tpu_torch.models import cache as tcache

    return {"port": tcache, "jax": jcache}


def test_fit_journal_write_through_restore_and_lazy_rehydrate(tmp_path):
    season = np.arange(5, dtype=np.float32)
    got = {}
    for name, m in _cache_pkgs().items():
        cache = m.ModelCache(max_size=8)
        j = m.FitJournal(str(tmp_path / name / "fit-uni"))
        cache.restore_lazy(j.restore())
        j.attach(cache)
        cache.put(("ma", 24, "k1"), (1.0, 0.0, season, 0, 0.1, 100))
        cache.put_many([(("ma", 24, f"k{i}"), (float(i), 0.0, season, 0, 0.1, 100)) for i in range(2, 5)])
        cache.pop(("ma", 24, "k2"))  # the tombstone survives a restart
        j.close()
        cache2 = m.ModelCache(max_size=8)
        j2 = m.FitJournal(str(tmp_path / name / "fit-uni"))
        items = j2.restore()
        assert {k[2] for k in items} == {"k1", "k3", "k4"}
        assert cache2.restore_lazy(items) == 3
        j2.attach(cache2)
        assert len(cache2) == 0  # nothing resident until a lookup
        v0 = cache2.version
        entry = cache2.peek(("ma", 24, "k1"))  # rehydrates and bumps the version
        assert entry is not None and entry[0] == 1.0 and np.array_equal(entry[2], season)
        assert cache2.version > v0 and len(cache2) == 1 and cache2.restored_pending() == 2
        assert cache2.peek(("ma", 24, "k1")) is entry
        assert cache2.get(("ma", 24, "k2")) is None
        j2.close()
        got[name] = sorted(items)
    assert got["port"] == got["jax"]


def test_fit_journal_torn_tail_and_unreadable_snap_degrade(tmp_path):
    got = {}
    for name, m in _cache_pkgs().items():
        cache = m.ModelCache(max_size=8)
        j = m.FitJournal(str(tmp_path / name / "fit-x"))
        j.attach(cache)
        cache.put("a", 1)
        cache.put("b", 2)
        j.compact()  # the snap holds {a, b}; a fresh log
        cache.put("c", 3)
        j.close()
        raw = open(j.log_path, "rb").read()
        with open(j.log_path, "wb") as fh:
            fh.write(raw[:-3])  # c is lost; a and b survive through the snap
        j2 = m.FitJournal(str(tmp_path / name / "fit-x"))
        items = j2.restore()
        torn = j2.counters["discards"]["fit_torn"]
        with open(j2.snap_path, "wb") as fh:
            fh.write(b"\x80\x04notpickle")
        j3 = m.FitJournal(str(tmp_path / name / "fit-x"))
        got[name] = (items, torn, j3.restore(), j3.counters["discards"]["fit_unreadable"])
    assert got["port"] == got["jax"] == ({"a": 1, "b": 2}, 1, {}, 1)


def test_fit_journal_compaction_preserves_unclaimed_restored_entries(tmp_path):
    got = {}
    for name, m in _cache_pkgs().items():
        cache = m.ModelCache(max_size=8)
        j = m.FitJournal(str(tmp_path / name / "fit-y"))
        j.attach(cache)
        cache.put_many([("a", 1), ("b", 2)])
        j.close()
        cache2 = m.ModelCache(max_size=8)
        j2 = m.FitJournal(str(tmp_path / name / "fit-y"))
        cache2.restore_lazy(j2.restore())
        j2.attach(cache2)
        assert cache2.get("a") == 1  # a claimed; b stays staged
        n = j2.compact()
        j2.close()
        got[name] = (n, m.FitJournal(str(tmp_path / name / "fit-y")).restore())
    assert got["port"] == got["jax"] == (2, {"a": 1, "b": 2})


def test_model_cache_lazy_overlay_respects_puts_and_capacity():
    for m in _cache_pkgs().values():
        cache = m.ModelCache(max_size=2)
        assert cache.restore_lazy({"a": 1, "b": 2, "c": 3, "d": 4}) == 4
        cache.put("a", 99)  # a fresh fit shadows its restored version
        assert cache.get("a") == 99
        assert cache.get("b") == 2 and cache.get("c") == 3 and cache.get("d") == 4
        assert len(cache) == 2  # rehydration keeps the LRU bound
        cache2 = m.ModelCache(max_size=8)
        cache2.restore_lazy({"x": 7})
        assert cache2.get_many(["x", "y", None]) == [7, None, None]
