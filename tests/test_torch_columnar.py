"""The port's columnar warm path on the CPU against the JAX package's:
`judge_columnar` / `judge_columnar_async` on arena-resident fits, both
pairwise variants, both band modes, with and without bands; the
`_compact_*` decoders and `packbits` byte for byte.

Verdicts, unpacked flags, packed bytes and `differs` are equal; bands
within 1e-5 (the fits come from the bf16-delta cold fit, the same
one-pass algebra on both sides); p-values within 1e-5."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.engine import judge as jj
from foremast_tpu_torch import interop
from foremast_tpu_torch.engine import judge as tj
from tests.torch_fleet import (
    BAND_TOL,
    assert_far_from_band_edges,
    assert_same_device_state,
    assert_same_verdicts,
    bf16_gate,
    columnar_inputs,
    fleet_kwargs,
    judges,
    run_both,
    seasonal_kwargs,
)

TCS = [1, 7, 8, 30, 33]


def _warm_pair(band_mode: str, n: int = 45):
    kws = fleet_kwargs(n, seed=21)
    jax_judge, port = judges(band_mode)
    got, want = run_both(jax_judge, port, kws)  # cold: fits cached
    assert_same_verdicts(got, want, BAND_TOL[True])
    return kws, jax_judge, port


def _assert_same_columnar(got, want, tc: int, tol: float = 1e-5) -> None:
    v8, anoms, ub, lb, ps, differs = got
    w8, wanoms, wub, wlb, wps, wdiffers = want
    assert v8.dtype == np.int8
    np.testing.assert_array_equal(v8, np.asarray(w8))
    assert anoms.shape == np.asarray(wanoms).shape and anoms.shape[1] == tc
    np.testing.assert_array_equal(anoms, np.asarray(wanoms))
    for g, w in ((ub, wub), (lb, wlb), (ps, wps)):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == np.asarray(w).shape
            np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)
    assert (differs is None) == (wdiffers is None)
    if differs is not None:
        np.testing.assert_array_equal(differs, np.asarray(wdiffers))


@pytest.mark.parametrize("with_bands", [True, False], ids=["bands", "no-bands"])
@pytest.mark.parametrize("band_mode", ["last", "full"])
@pytest.mark.parametrize("canary", [False, True], ids=["baseline-less", "canary"])
def test_judge_columnar_matches_jax(canary, band_mode, with_bands):
    """A warm columnar bucket (padded to a power of two) on both judges:
    the same compact results, the same arena rows and counters, zero
    scatters; twice, so the pad key's row is reused too."""
    kws, jax_judge, port = _warm_pair(band_mode)
    for _ in range(2):
        args_j, kw_j = columnar_inputs(jax_judge, kws, canary)
        args_t, kw_t = columnar_inputs(port, kws, canary)
        misses = port.device_state_counters()["misses"]
        want = jax_judge.judge_columnar(*args_j, with_bands=with_bands, **kw_j)
        got = port.judge_columnar(*args_t, with_bands=with_bands, **kw_t)
        _assert_same_columnar(got, want, args_t[0].shape[1])
        assert_same_device_state(jax_judge, port)
        assert port.device_state_counters()["misses"] <= misses + 1  # the pad row only
    assert (port.pad_rows_total, port.batch_rows_total) == (jax_judge.pad_rows_total, jax_judge.batch_rows_total)
    assert port.pad_rows_total > 0
    v8 = got[0]
    assert set(v8.tolist()) == {0, 1, 2}
    if canary:
        assert got[5].any() and not got[5].all()  # real rank tests ran


def test_columnar_equals_the_object_path():
    """The columnar warm tick gives the object path's warm verdicts,
    flags and last-point bands (band_mode="last")."""
    kws, _, port = _warm_pair("last")
    objects = {v.job_id: v for v in port.judge([tj.MetricTask(**k) for k in kws])}
    for canary in (False, True):
        args, kw = columnar_inputs(port, kws, canary)
        v8, anoms, ub, lb, ps, differs = port.judge_columnar(*args, **kw)
        rows = [k for k in kws if ("base_values" in k) == canary]
        for i, k in enumerate(rows):
            obj = objects[k["job_id"]]
            assert v8[i] == obj.verdict
            cols = np.flatnonzero(anoms[i])
            assert obj.anomaly_pairs[0::2] == k["cur_times"][cols].astype(np.float64).tolist()
            assert ub[i] == obj.upper[-1] and lb[i] == obj.lower[-1]
            if canary:
                assert ps[i] == np.float32(obj.p_value) and bool(differs[i]) == obj.dist_differs


def test_async_wait_on_another_thread():
    """The dispatch half returns a pending result; `wait()` on a second
    thread gives what the blocking call gives."""
    kws, _, port = _warm_pair("last")
    args, kw = columnar_inputs(port, kws, True)
    pending = port.judge_columnar_async(*args, **kw)
    assert isinstance(pending, tj.ColumnarPending)
    box = []
    t = threading.Thread(target=lambda: box.append(pending.wait()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(box) == 1
    _assert_same_columnar(box[0], port.judge_columnar(*args, **kw), args[0].shape[1])


@pytest.mark.parametrize(
    "algorithm,m,th,n,tol",
    [("holt_winters", 24, 512, 11, 2e-4), ("auto_univariate", 1440, 10080, 5, 1e-3)],
    ids=["holt_winters-24", "auto_univariate-1440"],
)
def test_seasonal_cold_warm_columnar_match_jax(algorithm, m, th, n, tol):
    """A seasonal algorithm through the fit-cache path: the cold tick
    (bf16-delta cold fit of the seasonal model, [m]-wide entries, arena
    scatter), the warm object tick and both columnar buckets, with
    histories whose current window starts 7 steps late on every third
    task (the phase advances over the gap), and two 30-point histories
    whose bucket is under two cycles: their mean-model entries carry a
    [1] season that the arena tiles to m. Verdicts, flags and differs
    equal the JAX judge's; bands within the model's tolerance (2e-4 for
    the Holt-Winters recurrence, 1e-3 for auto's seasonal candidates)."""
    short = seasonal_kwargs(2, m, 30, seed=50, key_prefix="short")
    for k in short:
        k["job_id"] = "short-" + k["job_id"]
    kws = seasonal_kwargs(n, m, th) + short
    jax_judge, port = judges("full", algorithm=algorithm, season_steps=m)
    with bf16_gate(True):
        for tick in range(2):
            if tick:
                for k in kws:
                    k["job_id"] += "-recheck"
            got, want = run_both(jax_judge, port, kws)
            assert_far_from_band_edges(want, kws)
            assert_same_verdicts(got, want, tol)
            assert_same_device_state(jax_judge, port)
    gaps = tj._gap_steps([tj.MetricTask(**k) for k in kws])
    assert set(gaps.tolist()) == {0, 7}
    entries = [port.fit_cache.peek((algorithm, m, k["fit_key"])) for k in kws]
    assert {len(e[2]) for e in entries} == {1, m}  # full-season and tiled mean-model entries
    assert any(e[1] != 0.0 for e in entries)  # trended fits
    for canary in (False, True):
        args_j, kw_j = columnar_inputs(jax_judge, kws, canary)
        args_t, kw_t = columnar_inputs(port, kws, canary)
        assert kw_t["gap_steps"].any()
        want = jax_judge.judge_columnar(*args_j, **kw_j)
        got = port.judge_columnar(*args_t, **kw_t)
        _assert_same_columnar(got, want, args_t[0].shape[1], tol)
        assert_same_device_state(jax_judge, port)
    assert set(got[0].tolist()) >= {1}


def test_jax_seasonal_snapshot_judged_warm():
    """A JAX fit cache of Holt-Winters state ([m] seasons, trends,
    phases), carried across with `interop.model_cache_from_snapshot`,
    judges warm in the port with no fit and the JAX judge's verdicts; the
    columnar bucket advances the same gaps."""
    kws = seasonal_kwargs(10, 24, 512, seed=3)
    jax_judge, port = judges("full", algorithm="holt_winters", season_steps=24)
    jax_judge.judge([jj.MetricTask(**k) for k in kws])
    snap = jax_judge.fit_cache.snapshot()
    port.fit_cache = interop.model_cache_from_snapshot(snap)
    calls = []
    fit = port._fit_miss_rows
    port._fit_miss_rows = lambda miss, *a: calls.append(len(miss)) or fit(miss, *a)
    got = port.judge([tj.MetricTask(**k) for k in kws])
    want = jax_judge.judge([jj.MetricTask(**k) for k in kws])
    assert calls and set(calls) == {0}
    assert_same_verdicts(got, want, 1e-6)
    args_j, kw_j = columnar_inputs(jax_judge, kws, False)
    args_t, kw_t = columnar_inputs(port, kws, False)
    _assert_same_columnar(port.judge_columnar(*args_t, **kw_t), jax_judge.judge_columnar(*args_j, **kw_j),
                          args_t[0].shape[1], 1e-6)


@pytest.mark.parametrize("tc", TCS)
def test_packbits_matches_numpy_and_jax(tc):
    rng = np.random.default_rng(tc)
    flags = rng.random((6, tc)) > 0.6
    got = tj.packbits(torch.from_numpy(flags))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (6, (tc + 7) // 8)
    np.testing.assert_array_equal(got.numpy(), np.packbits(flags, axis=1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.packbits(jnp.asarray(flags), axis=1)))


_VARIANTS = {
    "min": lambda r: (r["v"], r["a"]),
    "full_nopair": lambda r: (r["v"], r["a"], r["u"], r["l"]),
    "min_pair": lambda r: (r["v"], r["a"], r["p"], r["d"]),
    "full_pair": lambda r: (r["v"], r["a"], r["u"], r["l"], r["p"], r["d"]),
    "result_nopair": lambda r: (r["v"], r["a"], r["u"], r["l"], r["n"]),
    "result": lambda r: (r["v"], r["a"], r["u"], r["l"], r["p"], r["d"], r["n"]),
}


@pytest.mark.parametrize("tc", TCS)
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_compact_variants_match_jax(variant, tc):
    """Each `_compact_*` decoder equals the JAX one on the same inputs:
    int8 verdicts, packed flag bytes, the band gather, p and differs."""
    rng = np.random.default_rng(7 * tc)
    b = 9
    r = {
        "v": rng.integers(0, 3, b).astype(np.int32),
        "a": rng.random((b, tc)) > 0.7,
        "u": rng.normal(size=(b, tc)).astype(np.float32),
        "l": rng.normal(size=(b, tc)).astype(np.float32),
        "p": rng.random(b).astype(np.float32),
        "d": rng.random(b) > 0.5,
        "n": rng.integers(0, tc, b).astype(np.int32),
    }
    args = _VARIANTS[variant](r)
    want = getattr(jj, f"_compact_{variant}")(*(jnp.asarray(x) for x in args))
    got = getattr(tj, f"_compact_{variant}")(*(torch.from_numpy(x) for x in args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_host_copy_round_trips_every_dtype():
    """`_HostCopy` packs result tensors bytewise into one buffer and
    unpacks the same arrays, dtypes and shapes."""
    rng = np.random.default_rng(0)
    arrays = [
        rng.random(5) > 0.5,
        rng.integers(-3, 3, 5).astype(np.int8),
        rng.integers(0, 255, (5, 3)).astype(np.uint8),
        rng.integers(-9, 9, 5).astype(np.int32),
        rng.integers(0, 2**40, 5).astype(np.int64),
        rng.normal(size=(5, 7)).astype(np.float32),
        np.zeros((5, 0), np.uint8),
    ]
    back = tj._HostCopy([torch.from_numpy(a) for a in arrays]).wait()
    for a, g in zip(arrays, back):
        assert g.dtype == a.dtype and g.shape == a.shape
        np.testing.assert_array_equal(g, a)
