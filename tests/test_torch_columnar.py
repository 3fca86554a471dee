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
from foremast_tpu_torch.engine import judge as tj
from tests.torch_fleet import (
    BAND_TOL,
    assert_same_device_state,
    assert_same_verdicts,
    fleet_kwargs,
    judges,
    run_both,
)

TCS = [1, 7, 8, 30, 33]


def _columnar_inputs(judge, kws, canary: bool):
    """The columnar call's arguments, packed as the worker packs a warm
    bucket: keys and entries from `fit_cache.peek`, nidx = len - 1,
    per-row thr/bound/mlb from the metric-type table; the canary bucket
    with its baseline buffer pair."""
    cfg = judge.config
    rows = [k for k in kws if ("base_values" in k) == canary]
    keys = [(cfg.algorithm, cfg.season_steps, k["fit_key"]) for k in rows]
    entries = [judge.fit_cache.peek(key) for key in keys]
    lens = np.asarray([len(k["cur_values"]) for k in rows])
    n_max = max(lens.max(), max((len(k["base_values"]) for k in rows), default=1) if canary else 1)
    tc = jj.bucket_length(int(n_max))
    values = np.zeros((len(rows), tc), np.float32)
    mask = np.zeros((len(rows), tc), bool)
    for i, k in enumerate(rows):
        values[i, : lens[i]] = k["cur_values"]
        mask[i, : lens[i]] = True
    thr, bnd, mlb = cfg.anomaly.gather([k["metric_type"] for k in rows])
    kw = {}
    if canary:
        kw["base_values"] = np.zeros_like(values)
        kw["base_mask"] = np.zeros_like(mask)
        for i, k in enumerate(rows):
            kw["base_values"][i, : len(k["base_values"])] = k["base_values"]
            kw["base_mask"][i, : len(k["base_values"])] = True
    nidx = np.maximum(lens - 1, 0).astype(np.int32)
    return (values, mask, keys, entries, nidx, thr, bnd, mlb), kw


def _warm_pair(band_mode: str, n: int = 45):
    kws = fleet_kwargs(n, seed=21)
    jax_judge, port = judges(band_mode)
    got, want = run_both(jax_judge, port, kws)  # cold: fits cached
    assert_same_verdicts(got, want, BAND_TOL[True])
    return kws, jax_judge, port


def _assert_same_columnar(got, want, tc: int) -> None:
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
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
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
        args_j, kw_j = _columnar_inputs(jax_judge, kws, canary)
        args_t, kw_t = _columnar_inputs(port, kws, canary)
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
        args, kw = _columnar_inputs(port, kws, canary)
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
    args, kw = _columnar_inputs(port, kws, True)
    pending = port.judge_columnar_async(*args, **kw)
    assert isinstance(pending, tj.ColumnarPending)
    box = []
    t = threading.Thread(target=lambda: box.append(pending.wait()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(box) == 1
    _assert_same_columnar(box[0], port.judge_columnar(*args, **kw), args[0].shape[1])


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
