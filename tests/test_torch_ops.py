"""The port's array primitives on the CPU against the JAX package's:
window packing, masked moments, bounds, bound-selector flags, `horizon`
and `moving_average_all`.

Same numpy inputs to both. Packing, counts and flags must match exactly.
Moments and bands are the same f32 algebra summed in another order, so
they match to 1e-5 (rtol and atol); `moving_average_all`'s scale to
1e-4, the band tolerance the JAX kernel tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.ops import anomaly as ja
from foremast_tpu.ops import forecasters as jf
from foremast_tpu.ops import windows as jw
from foremast_tpu_torch.ops import anomaly as ta
from foremast_tpu_torch.ops import forecasters as tf
from foremast_tpu_torch.ops import windows as tw


def _rand_batch(rng, b=5, t=300):
    vals = rng.normal(2.0, 1.5, size=(b, t)).astype(np.float32)
    mask = rng.random((b, t)) > 0.2
    mask[0] = False  # one fully-masked series
    mask[1, 5:] = False  # one nearly-empty series
    return vals, mask


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_from_ragged_matches_jax_packing():
    rng = np.random.default_rng(0)
    series = []
    for n in (0, 1, 7, 12, 20):  # empty, short, exact, truncated rows
        t = 1_700_000_000 + 60 * np.arange(n, dtype=np.int64)
        series.append((t, rng.normal(size=n).astype(np.float32)))
    want = jw.MetricWindows.from_ragged(series, 12)
    got = tw.MetricWindows.from_ragged(series, 12, device="cpu")
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    assert got.times.dtype == torch.int32 and got.length == 12
    np.testing.assert_array_equal(got.count().numpy(), [0, 1, 7, 12, 12])
    assert tw.MetricWindows.from_ragged(series, 12, "cpu", device_times=False).times is None


def test_from_ragged_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.MetricWindows.from_ragged([(np.zeros(1), np.zeros(1))], 8)


def test_masked_moments_and_two_pass_forms_match_jax():
    rng = np.random.default_rng(1)
    vals, mask = _rand_batch(rng)
    v, m = torch.from_numpy(vals), torch.from_numpy(mask)
    jv, jm = jnp.asarray(vals), jnp.asarray(mask)
    for got, want in zip(tw.masked_moments(v, m), jw.masked_moments(jv, jm)):
        _close(got, want, 1e-5)
    _close(tw.masked_mean(v, m), jw.masked_mean(jv, jm), 1e-5)
    for ddof in (0, 1):
        _close(tw.masked_var(v, m, ddof=ddof), jw.masked_var(jv, jm, ddof=ddof), 1e-5)
        _close(tw.masked_std(v, m, ddof=ddof), jw.masked_std(jv, jm, ddof=ddof), 1e-5)


def test_bounds_and_flags_match_jax_for_every_selector():
    rng = np.random.default_rng(2)
    b, t = 6, 20
    pred = rng.normal(1.0, 0.2, (b, t)).astype(np.float32)
    scale = rng.uniform(0.1, 0.5, b).astype(np.float32)
    thr = rng.uniform(1.0, 3.0, b).astype(np.float32)
    mlb = np.array([0.0, 0.5, 0.9, 0.0, 0.5, 0.9], np.float32)
    cur = rng.normal(1.0, 1.0, (b, t)).astype(np.float32)
    cmask = rng.random((b, t)) > 0.1
    args_t = [torch.from_numpy(x) for x in (pred, scale, thr, mlb)]
    up, lo = ta.compute_bounds(*args_t)
    jup, jlo = ja.compute_bounds(*map(jnp.asarray, (pred, scale, thr, mlb)))
    _close(up, jup, 1e-6)
    _close(lo, jlo, 1e-6)
    # scalar threshold / floor broadcast like the JAX version
    up_s, lo_s = ta.compute_bounds(args_t[0], args_t[1], 2.0, 0.25)
    jup_s, jlo_s = ja.compute_bounds(jnp.asarray(pred), jnp.asarray(scale), 2.0, 0.25)
    _close(up_s, jup_s, 1e-6)
    _close(lo_s, jlo_s, 1e-6)
    per_row = np.array([1, 2, 3, 1, 2, 3], np.int32)
    for bound in (ta.BOUND_UPPER, ta.BOUND_LOWER, ta.BOUND_BOTH, per_row):
        got = ta.detect_anomalies(
            torch.from_numpy(cur), torch.from_numpy(cmask), up, lo,
            torch.from_numpy(bound) if isinstance(bound, np.ndarray) else bound,
        )
        want = ja.detect_anomalies(
            jnp.asarray(cur), jnp.asarray(cmask), jup, jlo, jnp.asarray(bound)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


def test_horizon_matches_jax_with_trend_and_season():
    rng = np.random.default_rng(3)
    b, m, h = 4, 5, 12
    parts = dict(
        pred=np.zeros((b, 0), np.float32),
        scale=rng.uniform(0.1, 1.0, b).astype(np.float32),
        level=rng.normal(size=b).astype(np.float32),
        trend=rng.normal(0, 0.1, b).astype(np.float32),
        season=rng.normal(size=(b, m)).astype(np.float32),
        season_phase=np.array([0, 1, 4, 3], np.int32),
    )
    got = tf.horizon(tf.Forecast(**{k: torch.from_numpy(v) for k, v in parts.items()}), h)
    want = jf.horizon(jf.Forecast(**{k: jnp.asarray(v) for k, v in parts.items()}), h)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("t", [300, 0])
def test_moving_average_all_matches_jax(t):
    rng = np.random.default_rng(4)
    vals, mask = _rand_batch(rng, t=max(t, 6))
    vals, mask = vals[:, :t], mask[:, :t]
    got = tf.moving_average_all(torch.from_numpy(vals), torch.from_numpy(mask))
    want = jf.moving_average_all(jnp.asarray(vals), jnp.asarray(mask))
    _close(got.level, want.level, 1e-5)
    _close(got.scale, want.scale, 1e-4)
    _close(got.pred, want.pred, 1e-5)
    for name in ("trend", "season", "season_phase"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
