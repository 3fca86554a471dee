"""Short-history admission and refinement in the port
(`foremast_tpu_torch/jobs/refine.py`, the worker's `_fetch_hist`,
`_refine_provisional` and `_invalidate_provisional`) against the JAX
package's, after `tests/test_ingest.py`'s admission and refinement cases.

A newcomer pushed into a pure-push ring with an admission floor is judged
on its first tick from a PROVISIONAL fit; as the ring grows, refinement
invalidates the fit and the next claim refits it through the slow path,
until the window closes. Both packages take the same pushes and ticks;
their statuses, refine books and read counts are equal, the port's
refined fit equals a fresh port worker's from-scratch fit bit for bit,
and JAX's fit within the band tolerances (1e-4 f32, 1e-5 bf16-delta)."""

from __future__ import annotations

import numpy as np
import pytest

from foremast_tpu import ingest as J
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import scoring as jscoring
from foremast_tpu.engine.scoring import HEALTHY, UNKNOWN
from foremast_tpu.jobs.store import InMemoryStore as JaxStore
from foremast_tpu.jobs.worker import BrainWorker as JaxWorker
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.ingest import RingSource, RingStore, canonical_series
from foremast_tpu_torch.jobs import BrainWorker, InMemoryStore
from foremast_tpu_torch.jobs.refine import GROWTH_FACTOR, RefineBook
from tests.torch_fleet import BAND_TOL
from tests.torch_workers import NOW, newcomer_fleet, statuses

BASE = int(NOW)
T1 = BASE - 1000
PUSH0 = BASE - 8200
PUSH_END = BASE - 1200
KEY = 'namespace_app_per_pod:latency{namespace="ns",app="new0"}'


def _pair(floor=3600.0, algorithm="moving_average_all", hooks=(None, None), **fleet_kw):
    """(JAX worker, store, ring), (port worker, store, ring) over the same
    newcomer fleet."""
    out = []
    for pkg, hook in zip(("jax", "port"), hooks):
        store, ring, source = newcomer_fleet(pkg, PUSH0, PUSH_END, T1, floor, **fleet_kw)
        if pkg == "jax":
            w = JaxWorker(store, source, config=JaxConfig(algorithm=algorithm), claim_limit=4,
                          worker_id="refine-w", on_verdict=hook, device_mesh=None)
        else:
            w = BrainWorker(store, source, config=BrainConfig(algorithm=algorithm), device="cpu", claim_limit=4,
                            worker_id="refine-w", on_verdict=hook)
        out.append((w, store, ring))
    return out


def _push(rings, times, seed):
    """The same samples of the newcomer's series into both rings."""
    vals = np.random.default_rng(seed).normal(1.0, 0.1, len(times)).astype(np.float32)
    (jring, ring) = rings
    jring.push(J.canonical_series(KEY), times, vals, now=NOW)
    ring.push(canonical_series(KEY), times, vals, now=NOW)


def _ticks_equal(jw, jstore, pw, pstore, now) -> None:
    assert jw.tick(now=now) == pw.tick(now=now) == 1
    assert statuses(pstore) == statuses(jstore)
    assert pw._refine_book.debug_state() == jw._refine_book.debug_state()


def test_short_history_admission_first_tick_verdict():
    """A newcomer with enough fresh coverage gets a verdict-capable
    PROVISIONAL fit on its first tick; below the floor it stays UNKNOWN
    (pure push: "unserved", never "http"), and a gap-sensitive fit that
    re-reads the empty history keeps counting "unserved", never "cache"."""
    verdicts = ([], [])
    (jw, jstore, _), (pw, pstore, _) = _pair(hooks=(lambda d, vs: verdicts[0].extend(vs),
                                                    lambda d, vs: verdicts[1].extend(vs)))
    _ticks_equal(jw, jstore, pw, pstore, NOW + 150)
    assert verdicts[1] and all(v.verdict == HEALTHY for v in verdicts[1])
    assert [v.verdict for v in verdicts[1]] == [v.verdict for v in verdicts[0]]
    assert len(pw._refine_book) == 1
    cs, jcs = pw.debug_state()["cold_start"], jw.debug_state()["cold_start"]
    assert cs["hist_reads"]["ring_partial"] == 1 and cs["refine"]["pending"] == 1
    assert {k: cs[k] for k in jcs if k in cs} == jcs

    verdicts = ([], [])
    (jw, jstore, _), (pw, pstore, _) = _pair(floor=30_000.0, hooks=(lambda d, vs: verdicts[0].extend(vs),
                                                                    lambda d, vs: verdicts[1].extend(vs)))
    _ticks_equal(jw, jstore, pw, pstore, NOW + 150)
    assert verdicts[1] and all(v.verdict == UNKNOWN for v in verdicts[1])
    assert len(pw._refine_book) == 0
    reads = pw.debug_state()["cold_start"]["hist_reads"]
    assert reads["unserved"] == 1 and reads["http"] == 0
    assert reads == jw.debug_state()["cold_start"]["hist_reads"]

    (jw, jstore, _), (pw, pstore, _) = _pair(floor=30_000.0, algorithm="phase_means")
    for now in (NOW + 150, NOW + 250):
        _ticks_equal(jw, jstore, pw, pstore, now)
    reads = pw.debug_state()["cold_start"]["hist_reads"]
    assert reads["unserved"] == 2 and reads["cache"] == 0
    assert reads == jw.debug_state()["cold_start"]["hist_reads"]


def _fits(worker) -> dict:
    return {k: v for k, v in worker._fit_cache._d.items() if k[2] and "new0" in str(k[2])}


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16_delta", "f32"])
def test_refinement_converges_to_from_scratch_fit(bf16):
    """Growth-paced refits upgrade the provisional fit as ring coverage
    grows, the record finalizes when the window closes, and the refined
    fit equals a from-scratch fit on the same final columns: bit for bit
    against a fresh port worker, and against JAX's within the band
    tolerance, with the statuses and refine books of both packages equal
    at every step."""
    scoring.set_bf16_delta(bf16)
    jscoring.set_bf16_delta(bf16)
    try:
        (jw, jstore, jring), (pw, pstore, ring) = _pair()
        rings = (jring, ring)
        _ticks_equal(jw, jstore, pw, pstore, NOW + 150)  # provisional fit admitted
        book = pw._refine_book
        n0 = next(iter(book._recs.values()))["points"]
        # a backward bulk-load (a pusher catching up on history): coverage
        # grows 4x inside the window but the window head stays uncovered
        _push(rings, np.arange(BASE - 30_000, PUSH0, 60, dtype=np.int64), seed=8)
        _ticks_equal(jw, jstore, pw, pstore, NOW + 160)  # all-warm -> refinement invalidates
        assert book.debug_state()["refit"] == 1
        _ticks_equal(jw, jstore, pw, pstore, NOW + 170)  # the refit lands on the slow path
        assert len(book) == 1
        n1 = next(iter(book._recs.values()))["points"]
        assert n1 > n0 and n1 >= int(n0 * GROWTH_FACTOR)
        # the window head fills in: coverage closes the window
        _push(rings, np.arange(PUSH_END + 60, T1 + 120, 60, dtype=np.int64), seed=9)
        _ticks_equal(jw, jstore, pw, pstore, NOW + 180)  # terminal refit queued
        assert book.debug_state()["finalized"] == 1 and len(book) == 0
        _ticks_equal(jw, jstore, pw, pstore, NOW + 190)  # the terminal refit lands

        # band parity: a FRESH port worker fitting from scratch off the same ring
        fresh_store, _, _ = newcomer_fleet("port", PUSH0, PUSH_END, T1, 3600.0)
        fresh = BrainWorker(fresh_store, pw.source, config=BrainConfig(algorithm="moving_average_all"),
                            device="cpu", claim_limit=4, worker_id="scratch-w")
        assert fresh.tick(now=NOW + 190) == 1
        assert statuses(fresh_store) == statuses(pstore)
        got, want, jax = _fits(pw), _fits(fresh), _fits(jw)
        assert got and set(got) == set(want) == set(jax)
        tol = BAND_TOL[bf16]
        for k, entry in got.items():
            for a, b in zip(entry, want[k]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), k
            level, trend, season, phase, scale, n = entry
            jl, jt, js, jp, jsc, jn = jax[k]
            assert (phase, n) == (int(jp), int(jn))
            np.testing.assert_allclose([level, trend, scale], [float(jl), float(jt), float(jsc)], rtol=tol, atol=tol)
            np.testing.assert_allclose(np.asarray(season), np.asarray(js), rtol=tol, atol=tol)
    finally:
        scoring.set_bf16_delta(None)
        jscoring.set_bf16_delta(None)


def test_joint_invalidation_without_fast_admission_pops_by_app():
    """A joint doc's provisional fit is invalidated even when the doc
    never warmed into the fast-path admission cache: the joint judge's
    slow-path cache keys carry no history content, so the invalidation
    pops by app, and leaves sibling apps alone, as JAX's does."""
    kept_fit = ("lstm", "other", ("a",), 1, 16, 4)
    kept_meta = ("jmeta", "lstm", "other", ("a",), ("h",))
    popped_fit = ("lstm", "appx", ("a", "b"), 2, 16, 4)
    popped_meta = ("jmeta", "lstm", "appx", ("a", "b"), ("h",))
    left = []
    for w in (
        JaxWorker(JaxStore(), J.RingSource(J.RingStore(shards=1), fallback=None),
                  config=JaxConfig(algorithm="lstm"), claim_limit=1, device_mesh=None),
        BrainWorker(InMemoryStore(), RingSource(RingStore(shards=1), fallback=None),
                    config=BrainConfig(algorithm="lstm_autoencoder"), device="cpu", claim_limit=1),
    ):
        mvj = w._mvj
        mvj.cache.put(popped_fit, {"w": 1})
        mvj.cache.put(kept_fit, {"w": 2})
        mvj.joint_meta.put(popped_meta, (1,))
        mvj.joint_meta.put(kept_meta, (2,))
        w._refine_book.note_joint("doc-1", "appx", ("u1", "u2"), 40)
        (bkey, rec), = w._refine_book.take(1)
        assert "doc-1" not in w._jadmit  # never fast-path-admitted
        w._invalidate_provisional(bkey, rec)
        left.append([mvj.cache.peek(k) is not None for k in (popped_fit, kept_fit)]
                    + [mvj.joint_meta.peek(k) is not None for k in (popped_meta, kept_meta)])
    assert left[1] == left[0] == [False, True, False, True]


def test_refine_book_survives_restart(tmp_path):
    """The fit journals restore a provisional FIT warm, so the refine book
    persists beside the fits; a port worker restores the book it wrote,
    and the one the JAX worker wrote, record for record."""
    (jw, _, _), (pw, _, _) = _pair()
    jw.enable_fit_persistence(str(tmp_path / "jax"))
    pw.enable_fit_persistence(str(tmp_path / "port"))
    assert jw.tick(now=NOW + 150) == pw.tick(now=NOW + 150) == 1
    rec0 = next(iter(pw._refine_book._recs.values()))
    assert next(iter(jw._refine_book._recs.values())) == rec0
    jw.close()
    pw.close()
    for name in ("port", "jax"):
        store, _, source = newcomer_fleet("port", PUSH0, PUSH_END, T1, 3600.0)
        w2 = BrainWorker(store, source, config=BrainConfig(algorithm="moving_average_all"), device="cpu",
                         claim_limit=4, worker_id="persist-w2")
        restored = w2.enable_fit_persistence(str(tmp_path / name))
        assert restored["refine"] == 1, name
        assert list(w2._refine_book._recs.values()) == [rec0]
        w2.close()


def test_refinement_settles_without_growth():
    """A provisional record whose window closes with no new in-window
    data settles WITHOUT a terminal refit: "settled", never "finalized",
    and the admitted fit entries stay untouched."""
    (jw, jstore, jring), (pw, pstore, ring) = _pair()
    _ticks_equal(jw, jstore, pw, pstore, NOW + 150)
    fits_before = dict(pw._fit_cache._d)
    # one sample just past the window head (within the merge slack)
    # extends the live span beyond t1 without adding in-window points
    _push((jring, ring), np.array([T1 + 60], dtype=np.int64), seed=10)
    _ticks_equal(jw, jstore, pw, pstore, NOW + 160)
    st = pw._refine_book.debug_state()
    assert st["settled"] == 1 and st["finalized"] == 0 and st["pending"] == 0, st
    assert dict(pw._fit_cache._d) == fits_before


def _lose_series(ring, key) -> None:
    """The ring loses one series, as a rebalance or budget eviction drops
    it (`RingStore.evict_unowned` in both packages, the mesh's rebalance
    hook)."""
    shard = ring._shard(key)
    with shard._lock:
        old = shard._series.pop(key)
        shard._bytes -= old.nbytes


def test_refinement_record_survives_transient_ring_loss():
    """A refinement pass while the ring cannot serve a provisional fit's
    series KEEPS the record (the fit is still warm; no cold claim would
    re-note it); once the series comes back and closes the window, the
    same record pays its terminal refit."""
    (jw, jstore, jring), (pw, pstore, ring) = _pair()
    _ticks_equal(jw, jstore, pw, pstore, NOW + 150)
    assert jring.evict_unowned(lambda k: False) == 1
    _lose_series(ring, canonical_series(KEY))
    assert pw._refine_provisional(NOW + 160) == jw._refine_provisional(NOW + 160) == 0
    st = pw._refine_book.debug_state()
    assert st["pending"] == 1 and st["dropped"] == 0, st
    _push((jring, ring), np.arange(PUSH0, T1 + 120, 60, dtype=np.int64), seed=9)
    assert pw._refine_provisional(NOW + 170) == jw._refine_provisional(NOW + 170) == 1
    st = pw._refine_book.debug_state()
    assert st["finalized"] == 1 and st["dropped"] == 0 and st["pending"] == 0, st
    assert st == jw._refine_book.debug_state()


def test_refine_book_pacing_round_robin_and_cap():
    """The book's own contracts, as JAX's: geometric pacing, round-robin
    `take`, re-noting keeps the position, drop-oldest past the cap, pad
    fit keys never noted, and the journal hook sees puts and deletes."""
    from foremast_tpu.jobs.refine import RefineBook as JaxBook

    seen = []
    books = (RefineBook(cap=3), JaxBook(cap=3))
    for book in books:
        book.journal = lambda items, deleted=False, _b=book: seen.append((type(_b).__module__, deleted, len(items)))
        for i in range(4):
            book.note_uni(("ma", 24, f"k{i}"), f"k{i}", f"u{i}", 10 * (i + 1))
        book.note_uni(("ma", 24, "__pad__col__"), "__pad__col__", "u", 5)
        book.note_uni(("ma", 24, "k2"), "k2", "u2b", 99)  # re-note: position kept
        assert [r["points"] for _, r in book.take(2)] == [20, 99]
        assert [r["points"] for _, r in book.take(3)] == [40, 20, 99]
        book.refit(("uni", ("ma", 24, "k3")), 60)
        book.drop(("uni", ("ma", 24, "k1")), "settled")
    assert books[0].debug_state() == books[1].debug_state()
    assert books[0].persistable_snapshot() == books[1].persistable_snapshot()
    port_journal = [s[1:] for s in seen if "torch" in s[0]]
    assert port_journal == [s[1:] for s in seen if "torch" not in s[0]]
    for then, now in ((10, 14), (10, 15), (1, 1), (1, 2), (0, 1)):
        assert RefineBook.due(then, now) == JaxBook.due(then, now)
