"""The port's univariate forecasters on the CPU against the JAX package's.

The same numpy inputs, made from a seed, go through the jitted JAX
function and its port (the kernels' plain versions: `holt_winters_scan`
and `holt_scan` loop over time with the kernels' arithmetic). Tolerances,
with their reasons:

  * recurrence state and predictions (Holt, Holt-Winters): rtol = atol =
    2e-4, as `tests/test_forecasters.py` allows Holt-Winters — XLA may
    contract the scan body into fused multiply-adds, the port rounds
    every operation;
  * EWMA: rtol 1e-4, atol 1e-5 — JAX's associative scan composes in
    another order than the port's Hillis-Steele passes;
  * rolling mean on random data 1e-4 (prefix sums summed in another
    order, then subtracted); on a dyadic grid every partial sum is exact
    in f32, so predictions and levels are equal;
  * phase means: 1e-4 (both sides reduce in f32, in different orders);
  * seasonal and auto: 1e-3;
  * grid choices, phases and model routes: exact.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.quality import gen
from foremast_tpu.ops import forecasters as jf
from foremast_tpu.ops.windows import masked_std as jax_masked_std
from foremast_tpu_torch.ops import forecasters as tf
from foremast_tpu_torch.ops import kernels as K
from foremast_tpu_torch.ops.windows import masked_std

FIELDS = ("pred", "scale", "level", "trend", "season", "season_phase")
KINDS = ("flat", "seasonal", "sharp-seasonal", "trend", "shift")


def _assert_forecast(got, want, rtol, atol=None, valid=None):
    """Every leaf of two Forecasts; `valid` limits pred to those points."""
    atol = rtol if atol is None else atol
    for name in FIELDS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name == "season_phase":
            np.testing.assert_array_equal(g, w)
        elif name == "pred" and valid is not None:
            np.testing.assert_allclose(g[valid], w[valid], rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def _quality_batch(per_kind: int, t_len: int, period: int, seed: int = 1):
    """Rows of every quality-generator kind, with gaps: a truncated row,
    leading masked steps, an interior gap and a too-short history."""
    v = np.concatenate([gen(k, per_kind, t_len, 30, seed=seed + i, period=period)[0]
                        for i, k in enumerate(KINDS)])
    mk = np.ones(v.shape, bool)
    mk[1, (4 * t_len) // 5:] = False
    mk[2, : period + 3] = False
    mk[3, t_len // 3 : t_len // 3 + period // 2 + 1] = False
    mk[4, 2 * period - 1:] = False  # under two cycles of real points
    v[~mk] = 0.0
    return v, mk


def _both(v, mk):
    return (torch.from_numpy(v), torch.from_numpy(mk)), (jnp.asarray(v), jnp.asarray(mk))


def test_masked_std_matches_jax_on_residuals():
    """`_finalize`'s scale: masked_std(values - pred, mask, ddof=0)."""
    rng = np.random.default_rng(0)
    r = rng.normal(0.0, 0.3, (6, 200)).astype(np.float32)
    mk = rng.random((6, 200)) > 0.3
    mk[0] = False
    mk[1, 1:] = False
    for ddof in (0, 1):
        got = masked_std(torch.from_numpy(r), torch.from_numpy(mk), ddof=ddof).numpy()
        want = np.asarray(jax_masked_std(jnp.asarray(r), jnp.asarray(mk), ddof=ddof))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_moving_average_is_exact_on_a_dyadic_grid():
    """Multiples of 1/64 with |x| <= 100 at T <= 2048: every prefix sum is
    exact in f32, so predictions and levels equal JAX's bit for bit."""
    rng = np.random.default_rng(1)
    t_len = 2048
    v = (rng.integers(-6400, 6401, (5, t_len)) / 64).astype(np.float32)
    mk = rng.random((5, t_len)) > 0.2
    mk[1, :700] = False
    mk[2, 5:] = False
    (tv, tm), (jv, jm) = _both(v, mk)
    got, want = tf.moving_average(tv, tm), jf.moving_average(jv, jm)
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(want.level))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [1, 10, 5000])
def test_moving_average_matches_jax(window):
    v, mk = _quality_batch(2, 512, 24)
    (tv, tm), (jv, jm) = _both(v, mk)
    _assert_forecast(tf.moving_average(tv, tm, window), jf.moving_average(jv, jm, window), 1e-4)


@pytest.mark.parametrize("per_series", [False, True], ids=["scalar", "per-series"])
def test_ewma_matches_jax(per_series):
    v, mk = _quality_batch(1, 300, 24)
    alpha = np.linspace(0.05, 0.9, v.shape[0]).astype(np.float32) if per_series else 0.3
    (tv, tm), (jv, jm) = _both(v, mk)
    got = tf.ewma(tv, tm, torch.from_numpy(alpha) if per_series else alpha)
    want = jf.ewma(jv, jm, jnp.asarray(alpha) if per_series else alpha)
    _assert_forecast(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("per_series", [False, True], ids=["scalar", "per-series"])
def test_double_exponential_matches_jax(per_series):
    v, mk = _quality_batch(2, 300, 24)
    b = v.shape[0]
    if per_series:
        a = np.linspace(0.1, 0.8, b).astype(np.float32)
        bt = np.linspace(0.01, 0.3, b).astype(np.float32)
        got = tf.double_exponential(*_both(v, mk)[0], torch.from_numpy(a), torch.from_numpy(bt))
        want = jf.double_exponential(*_both(v, mk)[1], jnp.asarray(a), jnp.asarray(bt))
    else:
        got = tf.double_exponential(*_both(v, mk)[0])
        want = jf.double_exponential(*_both(v, mk)[1])
    _assert_forecast(got, want, 2e-4)


@pytest.mark.parametrize("m_len", [1, 7, 24])
def test_holt_winters_matches_jax(m_len):
    """m <= 64 runs JAX's season-blocked body (phases unrolled); the port
    has one recurrence for every m."""
    v, mk = _quality_batch(2, 6 * m_len + 5, m_len)
    (tv, tm), (jv, jm) = _both(v, mk)
    _assert_forecast(tf.holt_winters(tv, tm, m_len), jf.holt_winters(jv, jm, m_len), 2e-4)


def test_holt_winters_rolled_body_matches_jax():
    """m = 100 > 64 takes JAX's rolled per-step body."""
    v, mk = _quality_batch(1, 450, 100)
    (tv, tm), (jv, jm) = _both(v, mk)
    _assert_forecast(tf.holt_winters(tv, tm, 100), jf.holt_winters(jv, jm, 100), 2e-4)


def test_holt_winters_per_series_params_match_jax():
    m_len = 12
    v, mk = _quality_batch(2, 150, m_len)
    b = v.shape[0]
    grid = np.asarray(tf._HW_GRID, np.float32)
    p = grid[np.arange(b) % len(grid)]
    got = tf.holt_winters(*_both(v, mk)[0], m_len, *(torch.from_numpy(p[:, j].copy()) for j in range(3)))
    want = jf.holt_winters(*_both(v, mk)[1], m_len, *(jnp.asarray(p[:, j]) for j in range(3)))
    _assert_forecast(got, want, 2e-4)


@pytest.mark.parametrize("t_len", [0, 1, 5, 11, 12, 13, 31])
def test_holt_winters_scan_edge_lengths_match_jax(t_len):
    """T in {0, 1, m-1, 2m-1, 2m, 2m+1, odd} at m = 6 with an all-masked
    row, a single valid point, leading masked steps and an interior gap:
    the scan's state and predictions against JAX's `holt_winters`."""
    m_len = 6
    rng = np.random.default_rng(t_len)
    v = (2.0 + np.sin(np.arange(t_len) / 3.0)[None, :] + rng.normal(0, 0.1, (5, t_len))).astype(np.float32)
    mk = np.ones((5, t_len), bool)
    mk[0] = False
    mk[1] = False
    mk[1, t_len // 2 : t_len // 2 + 1] = True
    mk[2, : t_len // 3] = False
    mk[3, t_len // 4 : t_len // 2] = False
    (tv, tm), (jv, jm) = _both(v, mk)
    init_level, init_season = tf._hw_init(tv, tm, m_len)
    level, trend, season, sse, pred = K.holt_winters_scan(
        tv, tm, init_level, init_season, torch.tensor([[0.3, 0.05, 0.1]]).expand(5, 3).contiguous(),
        per_series=True, want_pred=True,
    )
    assert pred.shape == (5, t_len) and season.shape == (1, 5, m_len) and sse.dtype == torch.float64
    if t_len == 0:
        np.testing.assert_array_equal(season[0].numpy(), init_season.numpy())
        return
    want = jf.holt_winters(jv, jm, m_len)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want.pred), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(level[0].numpy(), np.asarray(want.level), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(trend[0].numpy(), np.asarray(want.trend), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(season[0].numpy(), np.asarray(want.season), rtol=2e-4, atol=2e-4)
    r = (v - np.asarray(want.pred)) * mk
    np.testing.assert_allclose(sse[0].numpy(), (r.astype(np.float64) ** 2).sum(-1), rtol=1e-4, atol=1e-6)


@partial(jax.jit, static_argnums=2)
def _jax_grid_sse(jv, jm, m_len):
    """JAX's per-grid-point masked SSE, [G, B], as `fit_holt_winters`'s
    vmapped `run` computes it."""

    def run(p):
        fc = jf.holt_winters(jv, jm, m_len, p[0], p[1], p[2])
        r = (jv - fc.pred) * jm
        return jnp.sum(r * r, axis=-1)

    return jax.vmap(run)(jnp.asarray(tf._HW_GRID, jnp.float32))


@pytest.mark.parametrize("m_len,t_len", [(24, 512), (1440, 3000)], ids=["blocked", "rolled"])
def test_fit_holt_winters_matches_jax(m_len, t_len):
    """The grid choice is exact (the data keep every row's best SSE well
    apart from its runner-up), and the fitted state within 2e-4."""
    per_kind = 2 if m_len == 24 else 1
    v, mk = _quality_batch(per_kind, t_len, m_len)
    (tv, tm), (jv, jm) = _both(v, mk)
    sse = tf.hw_grid_sse(tv, tm, m_len).numpy()
    want_sse = np.asarray(_jax_grid_sse(jv, jm, m_len))
    np.testing.assert_allclose(sse, want_sse, rtol=1e-4)
    srt = np.sort(want_sse, axis=0)
    assert ((srt[1] - srt[0]) > 1e-3 * srt[0]).all(), "a near tie: pick other data"
    np.testing.assert_array_equal(sse.argmin(axis=0), want_sse.argmin(axis=0))
    got = tf.fit_holt_winters(tv, tm, m_len)
    _assert_forecast(got, jf.fit_holt_winters(jv, jm, m_len), 2e-4)
    # the under-two-cycles row keeps the mean model's zero season
    assert float(got.season[4].abs().max()) == 0.0 and float(got.trend[4]) == 0.0


@pytest.mark.parametrize("m_len,t_len,per_kind", [(24, 1008, 32), (1440, 10080, 4)], ids=["m24", "m1440"])
def test_hw_grid_choice_near_ties_on_quality_fleets(m_len, t_len, per_kind):
    """The two sides sum the grid's SSEs differently (JAX in f32 in XLA's
    order, the port in f64 in time order), so a near tie could choose
    another (alpha, beta, gamma). Counted on the quality generator's five
    kinds at the full size of benchmarks/quality.py (32 rows a kind at
    m = 24, Th = 1,008; 4 at m = 1440, Th = 10,080): every runner-up
    lies more than 1e-3 relative away, no row chooses differently, and
    no verdict or flag of `scoring.score` differs."""
    from benchmarks.quality import make_batch
    from foremast_tpu.engine import scoring as js
    from foremast_tpu_torch.engine import scoring as ts
    from foremast_tpu_torch.interop import score_batch_from_numpy

    parts = [gen(k, per_kind, t_len, 30, seed=i, period=m_len) for i, k in enumerate(KINDS)]
    h = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    (tv, tm), (jv, jm) = _both(h, np.ones(h.shape, bool))
    want = np.asarray(_jax_grid_sse(jv, jm, m_len))
    got = tf.hw_grid_sse(tv, tm, m_len).numpy()
    srt = np.sort(want, axis=0)
    assert ((srt[1] - srt[0]) / srt[0]).min() > 1e-3
    assert int((got.argmin(axis=0) != want.argmin(axis=0)).sum()) == 0
    batch = make_batch(h, c)
    jr = js.score(batch, algorithm="holt_winters", season_length=m_len)
    pr = ts.score(
        score_batch_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, batch)), device="cpu"),
        algorithm="holt_winters",
        season_length=m_len,
    )
    np.testing.assert_array_equal(pr.verdict.numpy(), np.asarray(jr.verdict))
    np.testing.assert_array_equal(pr.anomalies.numpy(), np.asarray(jr.anomalies))
    assert bool(pr.anomalies.any())  # the spikes flag


def test_holt_winters_scan_grid_equals_per_series_runs():
    """A grid launch's state for triple g equals a per-series launch with
    every row on triple g, bit for bit (the fit's second launch relies on
    it)."""
    v, mk = _quality_batch(1, 120, 12)
    tv, tm = torch.from_numpy(v), torch.from_numpy(mk)
    il, isn = tf._hw_init(tv, tm, 12)
    grid = torch.tensor(tf._HW_GRID, dtype=torch.float32)
    lv, tr, se, sse, _ = K.holt_winters_scan(tv, tm, il, isn, grid)
    for g in (0, 5):
        p = grid[g].expand(v.shape[0], 3).contiguous()
        l1, t1, s1, e1, pred = K.holt_winters_scan(tv, tm, il, isn, p, per_series=True, want_pred=True)
        assert torch.equal(l1[0], lv[g]) and torch.equal(t1[0], tr[g])
        assert torch.equal(s1[0], se[g]) and torch.equal(e1[0], sse[g])
    with pytest.raises(ValueError, match="per-series"):
        K.holt_winters_scan(tv, tm, il, isn, grid, want_pred=True)


@pytest.mark.parametrize("m_len,t_len", [(24, 512), (1440, 10080)], ids=["m24", "m1440"])
def test_fit_phase_means_matches_jax(m_len, t_len):
    v, mk = _quality_batch(1, t_len, m_len)
    (tv, tm), (jv, jm) = _both(v, mk)
    _assert_forecast(tf.fit_phase_means(tv, tm, m_len), jf.fit_phase_means(jv, jm, m_len), 1e-4)


@pytest.mark.parametrize("m_len,t_len", [(24, 512), (1440, 16384)], ids=["m24", "m1440"])
def test_fit_auto_univariate_matches_jax(m_len, t_len):
    """Per-series routes (mean model, structured, which structured) equal
    JAX's on the quality generator's kinds; state within 1e-3. At m = 1440
    the history is a bucket-padded 7-day window."""
    v, mk = _quality_batch(1, min(t_len, 10080), m_len)
    if t_len > v.shape[1]:
        pad = t_len - v.shape[1]
        v = np.pad(v, ((0, 0), (0, pad)))
        mk = np.pad(mk, ((0, 0), (0, pad)))
    (tv, tm), (jv, jm) = _both(v, mk)
    got = tf.fit_auto_univariate(tv, tm, m_len)
    want = jf.fit_auto_univariate(jv, jm, m_len)
    _assert_forecast(got, want, 1e-3, valid=mk)
    flat = np.asarray(want.season)[0]
    assert np.abs(flat).max() == 0.0  # the flat row kept the mean model
    assert np.abs(np.asarray(want.season)[1]).max() > 0.2  # the seasonal row did not


def test_auto_short_batch_keeps_the_mean_model():
    v, mk = _quality_batch(1, 40, 24)
    (tv, tm), (jv, jm) = _both(v, mk)
    got = tf.fit_auto_univariate(tv, tm, 24)
    assert got.season.shape == (5, 1)
    _assert_forecast(got, jf.fit_auto_univariate(jv, jm, 24), 1e-5)


@pytest.mark.parametrize("m_len", [24, 60, 1440])
def test_z_threshold_matches_scipy(m_len):
    from scipy import stats

    assert tf._z_threshold(m_len) == pytest.approx(float(stats.norm.ppf(1.0 - 1e-3 / m_len)), rel=1e-12)


def test_horizon_phase_ignores_bucket_padding():
    """A 288-point series in a 512 bucket forecasts the exact-length
    series' seasonal continuation (phase from the last valid index)."""
    m_len = 24
    t = np.arange(288, dtype=np.float32)
    x = (5 + 2 * np.sin(2 * np.pi * t / m_len)).astype(np.float32)

    def padded(n):
        v = np.zeros((1, n), np.float32)
        v[0, :288] = x
        mk = np.zeros((1, n), bool)
        mk[0, :288] = True
        return torch.from_numpy(v), torch.from_numpy(mk)

    exact = tf.holt_winters(*padded(288), season_length=m_len)
    pad = tf.holt_winters(*padded(512), season_length=m_len)
    np.testing.assert_allclose(tf.horizon(pad, m_len).numpy(), tf.horizon(exact, m_len).numpy(), rtol=1e-5, atol=1e-5)
    assert int(pad.season_phase[0]) == 288 % m_len


def test_jax_forecasters_ran_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
