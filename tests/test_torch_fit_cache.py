"""The port's fit-cache path on the CPU against the JAX package's: the
cold fit (bf16-delta or f32), the fit cache, the device state arena and
`score_from_arena`, task for task and arena row for arena row.

Verdicts, anomaly pairs and `dist_differs` match exactly; bands within
1e-5 on the bf16-delta fit (the same one-pass algebra on both sides,
summed in another order) and 1e-4 on the f32 fit (two-pass moments here,
shifted one-pass in the JAX program); p-values within 1e-5. Arena
counters and row maps are equal, because the port keeps the JAX arena's
host bookkeeping unchanged."""

import numpy as np
import pytest
import torch

from foremast_tpu.engine import judge as jj
from foremast_tpu.engine.arena import StateArena as JaxArena
from foremast_tpu.engine.arena import _row_bytes
from foremast_tpu.models import cache as jcache
from foremast_tpu_torch import interop
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.engine import scoring as ts
from foremast_tpu_torch.engine.arena import StateArena
from foremast_tpu_torch.models import cache as tcache
from tests.torch_fleet import (
    BAND_TOL,
    arena_budget,
    assert_far_from_band_edges,
    assert_same_device_state,
    assert_same_verdicts,
    bf16_gate,
    fleet_kwargs,
    judges,
    run_both,
    seasonal_kwargs,
)


@pytest.mark.parametrize("band_mode", ["full", "last"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_cold_warm_rewarm_match_jax(bf16, band_mode):
    """Cold tick (every row fitted and scattered), warm tick (pure
    gathers), re-warm with new job ids: the same verdicts as the JAX
    judge at every tick, the same fit-cache keys and entries, and the
    same arena rows and counters."""
    kws = fleet_kwargs(37, seed=1)  # 37 tasks: two buckets, pad rows
    jax_judge, port = judges(band_mode)
    with bf16_gate(bf16):
        for tick in range(3):
            if tick == 2:
                for k in kws:
                    k["job_id"] += "-recheck"
            got, want = run_both(jax_judge, port, kws)
            assert_same_verdicts(got, want, BAND_TOL[bf16])
            assert_same_device_state(jax_judge, port)
            c = port.device_state_counters()
            # one scatter per fit key (pad key included), cold tick only
            assert c["misses"] == len(port.fit_cache) and c["evictions"] == 0
    want_cache = jax_judge.fit_cache.snapshot()
    got_cache = port.fit_cache.snapshot()
    assert list(got_cache) == list(want_cache)
    for key, g in got_cache.items():
        w = want_cache[key]
        assert (g[1], g[3], g[5]) == (float(w[1]), int(w[3]), int(w[5]))
        np.testing.assert_allclose([g[0], g[4]], [w[0], w[4]], rtol=BAND_TOL[bf16], atol=BAND_TOL[bf16])
        np.testing.assert_array_equal(g[2], np.asarray(w[2]))
    assert {v.verdict for v in got} == {0, 1, 2}


def test_evicted_entry_rescatters_exactly_one_row():
    """A fit-cache miss (an evicted entry) refits that row and scatters it
    over the stale device row; every other row stays a warm gather."""
    kws = fleet_kwargs(12, seed=9)
    jax_judge, port = judges()
    ref, _ = run_both(jax_judge, port, kws)
    scattered = port.device_state_counters()["misses"]
    hits = port.device_state_counters()["hits"]
    key = ("moving_average_all", port.config.season_steps, kws[1]["fit_key"])
    jax_judge.fit_cache.pop(key)
    port.fit_cache.pop(key)
    got, want = run_both(jax_judge, port, kws)
    assert_same_verdicts(got, want, BAND_TOL[True])
    assert_same_device_state(jax_judge, port)
    assert port.device_state_counters()["misses"] == scattered + 1
    assert port.device_state_counters()["hits"] > hits
    assert [v.verdict for v in got] == [v.verdict for v in ref]


def test_churn_rescatters_only_changed_rows():
    """10 % churn (one job leaves, one arrives, order shuffled) uploads
    only the newcomer's row; re-claiming the departed job is a gather."""
    rng = np.random.default_rng(11)
    kws = fleet_kwargs(10, seed=11)
    newcomer = fleet_kwargs(11, seed=12, key_prefix="new")[10]
    jax_judge, port = judges()
    run_both(jax_judge, port, kws)
    base = port.device_state_counters()["misses"]
    churned = kws[1:] + [newcomer]
    churned = [churned[i] for i in rng.permutation(len(churned))]
    got, want = run_both(jax_judge, port, churned)
    assert_same_verdicts(got, want, BAND_TOL[True])
    assert_same_device_state(jax_judge, port)
    assert port.device_state_counters()["misses"] == base + 1
    before = port.device_state_counters()["misses"]
    got, want = run_both(jax_judge, port, kws)
    assert_same_verdicts(got, want, BAND_TOL[True])
    assert_same_device_state(jax_judge, port)
    assert port.device_state_counters()["misses"] == before


def test_arena_auto_grows_past_soft_budget_and_refuses_past_hard_cap():
    """Past the soft budget the arena grows toward the hard cap; past the
    hard cap it refuses up front with no partial row mutation — as the
    JAX arena does, row for row."""
    with arena_budget(8 * _row_bytes(24), 32 * _row_bytes(24)):
        ref, port = JaxArena(24), StateArena(24, device="cpu")
        assert (port.max_rows, port.hard_rows) == (ref.max_rows, ref.hard_rows) == (8, 32)
        keys = [f"k{i}" for i in range(16)]
        want, got = ref.assign(keys, range(16)), port.assign(keys, range(16))
        assert got is not None, "must auto-grow, not refuse"
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and port.max_rows == ref.max_rows == 16
        rows_before = dict(port.rows)
        wide = [f"x{i}" for i in range(64)]
        assert port.assign(wide, range(64)) is None and ref.assign(wide, range(64)) is None
        assert port.rows == rows_before == ref.rows
        assert port.counters() == ref.counters()


def test_stacked_fallback_is_counted_and_verdicts_survive():
    """A batch over even the hard cap falls back to a one-off stacked
    score: the same verdicts, and the fallback counted."""
    kws = fleet_kwargs(12, seed=13)  # 12 tasks -> a 16-row bucket
    with arena_budget(8 * _row_bytes(1), 8 * _row_bytes(1)):
        jax_judge, port = judges()
        for _ in range(2):
            got, want = run_both(jax_judge, port, kws)
            assert_same_verdicts(got, want, BAND_TOL[True])
            assert_same_device_state(jax_judge, port)
    assert port.device_state_counters()["fallbacks"] == 2


@pytest.mark.parametrize("n_buckets,size", [(2, 32), (5, 16)], ids=["cross-bucket", "many-bucket"])
def test_arena_grows_for_the_working_set(n_buckets, size):
    """A warm tick split across sibling calls (the baseline-less and
    canary columnar buckets, slow-path buckets) grows the arena to the
    cross-call working set instead of evicting a sibling's rows."""
    ref = JaxArena(1, max_bytes=4096 * _row_bytes(1))
    port = StateArena(1, max_bytes=4096 * _row_bytes(1), device="cpu")
    buckets = [[f"{c}{i}" for i in range(size)] for c in "abcde"[:n_buckets]]
    for bucket in buckets:
        got, want = port.assign(bucket, range(size)), ref.assign(bucket, range(size))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == list(range(size))
    for _ in range(3):
        for bucket in buckets:
            got, want = port.assign(bucket, ()), ref.assign(bucket, ())
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] == []
    assert port.evictions == ref.evictions == 0
    assert port.cap == ref.cap >= n_buckets * size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arena_assign_matches_jax_on_a_random_key_sequence(seed):
    """Row-for-row parity of `assign` under pressure: random key sets
    drawn from a pool larger than the budget (evictions, the free list,
    the argsort order), forced rows, unkeyed transients, duplicate keys
    and pad positions."""
    rng = np.random.default_rng(seed)
    with arena_budget(64 * _row_bytes(1), 128 * _row_bytes(1)):
        ref, port = JaxArena(1), StateArena(1, device="cpu")
        pool = [f"k{i}" for i in range(300)]
        for _ in range(40):
            n = int(rng.integers(1, 100))
            keys = [pool[j] if rng.random() > 0.05 else None for j in rng.integers(0, len(pool), n)]
            n_real = int(rng.integers(0, n + 1))
            keys[n_real:] = ["__pad__col__"] * (n - n_real)
            force = sorted(set(rng.integers(0, n, int(rng.integers(0, 4))).tolist()))
            want, got = ref.assign(keys, force, n_real), port.assign(keys, force, n_real)
            if want is None:
                assert got is None
                continue
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            assert port.rows == ref.rows and port.row_key == ref.row_key
            assert port.free == ref.free
            np.testing.assert_array_equal(port.stamp, ref.stamp)
            assert port.counters() == ref.counters()
        assert ref.evictions > 0


def test_scatter_and_gather_reproduce_the_entries():
    """`scatter` lands each entry in its row (season tiled to the arena
    width); `score_from_arena` gathers exactly those rows."""
    arena = StateArena(4, device="cpu")
    keys = ["a", "b", "c"]
    entries = [
        (1.5, 0.25, np.arange(4, dtype=np.float32), 3, 0.5, 7),
        (2.0, 0.0, np.zeros(1, np.float32), 0, 0.125, 0),
        (-1.0, -0.5, np.asarray([1.0, -1.0], np.float32), 1, 2.0, 99),
    ]
    rows, scatter = arena.assign(keys, ())
    arena.scatter(rows, scatter, entries)
    level, trend, season, phase, scale, nh = arena.state
    for r, e in zip(rows, entries):
        assert (level[r].item(), trend[r].item(), phase[r].item(), scale[r].item(), nh[r].item()) == (
            e[0], e[1], e[3], e[4], e[5],
        )
        np.testing.assert_array_equal(season[r].numpy(), ts.tile_season(e[2], 4))
    assert arena.device_bytes() == arena.cap * _row_bytes(4)


@pytest.mark.parametrize(
    "lens,length",
    [([400, 17, 0, 1, 400], 512), ([600, 3], 512), ([5, 0], 8), ([0, 0], 0)],
    ids=["ragged", "truncated", "short", "empty"],
)
def test_pack_hist_bf16_host_is_bit_equal_to_jax(lens, length):
    """Anchor, lens and the bf16 deltas (bits, including +0.0 padding)
    equal the JAX package's packing."""
    rng = np.random.default_rng(3)
    series = []
    for n in lens:
        v = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        if n:
            v[::7] = v[0]  # exact-zero deltas
        series.append((np.arange(n, dtype=np.int64), v))
    a_j, d_j, l_j = jj._pack_hist_bf16_host(series, length)
    a_t, d_t, l_t = tj._pack_hist_bf16_host(series, length)
    assert d_t.dtype == torch.bfloat16 and d_t.shape == d_j.shape
    np.testing.assert_array_equal(a_t.view(np.int32), np.asarray(a_j, np.float32).view(np.int32))
    np.testing.assert_array_equal(l_t, l_j)
    np.testing.assert_array_equal(d_t.view(torch.int16).numpy(), np.asarray(d_j).view(np.int16))


def test_jax_fitted_cache_carried_across():
    """A JAX-fitted fit cache, carried across as a snapshot, gives the
    port judge a warm tick with no fit at all and the JAX judge's
    warm-tick verdicts."""
    kws = fleet_kwargs(20, seed=5)
    jax_judge, port = judges()
    jax_judge.judge([jj.MetricTask(**k) for k in kws])
    snap = jax_judge.fit_cache.snapshot()
    port.fit_cache = interop.model_cache_from_snapshot(snap)
    assert list(port.fit_cache.snapshot()) == list(snap)
    calls = []
    fit = port._fit_miss_rows
    port._fit_miss_rows = lambda miss, *a: calls.append(len(miss)) or fit(miss, *a)
    got = port.judge([tj.MetricTask(**k) for k in kws])
    want = jax_judge.judge([jj.MetricTask(**k) for k in kws])
    assert calls and set(calls) == {0}  # no cache miss in any bucket
    assert_same_verdicts(got, want, 1e-6)
    for key, entry in port.fit_cache.snapshot().items():
        w = snap[key]
        assert entry[0] == float(w[0]) and entry[4] == float(w[4]) and entry[5] == int(w[5])


def test_non_ma_bf16_cold_fit_is_not_ported():
    """The bf16-delta cold fit of the other algorithms is ported now
    (`fit_forecast_bf16_delta`): a Holt-Winters fleet's cold tick through
    it, and through the f32 route with the gate off, caches the JAX
    judge's entries and writes its verdicts."""
    kws = seasonal_kwargs(9, 24, 400, seed=4)
    for bf16 in (True, False):
        jax_judge, port = judges(algorithm="holt_winters", season_steps=24)
        with bf16_gate(bf16):
            got, want = run_both(jax_judge, port, kws)
        assert_far_from_band_edges(want, kws)
        assert_same_verdicts(got, want, 2e-4)
        assert_same_device_state(jax_judge, port)
        want_cache = jax_judge.fit_cache.snapshot()
        for key, g in port.fit_cache.snapshot().items():
            w = want_cache[key]
            assert (g[3], g[5]) == (int(w[3]), int(w[5]))
            np.testing.assert_allclose([g[0], g[1], g[4]], [w[0], w[1], w[4]], rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(g[2], np.asarray(w[2]), rtol=2e-4, atol=2e-4)


def test_device_state_counters_monotone_across_clear():
    kws = fleet_kwargs(8, seed=17)
    jax_judge, port = judges()
    for _ in range(2):
        run_both(jax_judge, port, kws)
    before = port.device_state_counters()
    jax_judge.clear_device_state()
    port.clear_device_state()
    assert port.device_state_counters() == jax_judge.device_state_counters()
    assert port.device_state_counters()["rows_live"] == 0
    assert {k: before[k] for k in ("hits", "misses")} == {
        k: port.device_state_counters()[k] for k in ("hits", "misses")
    }
    got, want = run_both(jax_judge, port, kws)
    assert_same_verdicts(got, want, BAND_TOL[True])
    assert_same_device_state(jax_judge, port)
    assert port.device_state_counters()["misses"] > before["misses"]


def test_model_cache_matches_jax_semantics(tmp_path):
    """LRU order, batched get/put, pop_where, the lazy restore overlay,
    the journal hook and the version counter behave as the JAX cache's;
    both checkpoints round-trip."""
    ops = [
        ("put", ("a", 1)), ("put", ("b", 2)), ("put", ("c", 3)), ("get", "a"),
        ("put", ("d", 4)), ("put_many", [("e", 5), ("a", 6)]), ("pop", "d"),
        ("restore_lazy", {"r1": 7, "r2": 8, "a": 9}), ("get_many", ["r1", "zz", None, "e"]),
        ("peek", "r2"), ("pop_where", lambda k: k.startswith("r")), ("put", ("f", 10)),
    ]
    caches = []
    for mod in (jcache, tcache):
        c, log = mod.ModelCache(3), []
        c.journal = lambda items, **kw: log.append((list(items), kw))
        results = [getattr(c, name)(arg) if name not in ("put", "put_many") else (
            c.put(*arg) if name == "put" else c.put_many(arg)) for name, arg in ops]
        caches.append((c, log, results))
    (jc, jlog, jres), (tc, tlog, tres) = caches
    assert tres == jres and tlog == jlog
    assert list(tc.snapshot().items()) == list(jc.snapshot().items())
    assert tc.version == jc.version and len(tc) == len(jc)
    assert tc.persistable_snapshot() == jc.persistable_snapshot()
    for key in ["__pad__", "__pad__col__", "__pad__@3", ("ma", 24, "__pad__"), "app|m", ("ma", 24, "x"), 7]:
        assert tcache.is_pad_fit_key(key) == jcache.is_pad_fit_key(key)
    assert tcache.PAD_FIT_MARKERS == jcache.PAD_FIT_MARKERS

    entry = (1.5, 0.0, np.arange(3, dtype=np.float32), 2, 0.25, 40)
    src = tcache.ModelCache(8)
    src.put_many([(("moving_average_all", 24, "k1"), entry), (("moving_average_all", 24, "k2"), entry)])
    src.save(str(tmp_path / "ckpt.pt"))
    back = tcache.ModelCache(8)
    assert back.load(str(tmp_path / "ckpt.pt")) == 2
    restored = back.get("('moving_average_all', 24, 'k1')")
    assert restored[:2] == entry[:2] and restored[3:] == entry[3:]
    np.testing.assert_array_equal(restored[2], entry[2])
    src.save_local(str(tmp_path / "local" / "cache.pkl"))
    local = tcache.ModelCache(8)
    assert local.load_local(str(tmp_path / "local" / "cache.pkl")) == 2
    assert list(local.snapshot()) == list(src.snapshot())


def test_arena_without_device_needs_cuda():
    """The arena, like the judge, defaults to the card and refuses to
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        StateArena(1)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        StateArena(1, shards=2, device="cpu")
