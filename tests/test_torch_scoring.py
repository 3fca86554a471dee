"""The port's scoring programs on the CPU against the JAX package's.

Same numpy batch to both (the port's copy through
`interop.score_batch_from_numpy`). Verdicts, anomaly flags and the
pairwise `dist_differs` bit must match exactly; `p_value` to 1e-5 (the
same f32 rank-test formulas, erfc/gammaincc from two libraries).

Bands: the port's `score` runs `ma_judgment`'s two-pass moments where the
JAX XLA program runs shifted one-pass moments, so f32 bands match to
1e-4. The bf16-delta path is the same one-pass algebra on both sides,
summed in another order: 1e-5. The data keep current points well away
from band edges, so neither difference can flip a flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.engine import scoring as js
from foremast_tpu.ops.windows import MetricWindows as JaxWindows
from foremast_tpu_torch import interop
from foremast_tpu_torch.engine import scoring as ts

B, TH, TC = 8, 200, 30


def _numpy_batch(seed=0, with_baseline=True):
    rng = np.random.default_rng(seed)
    hv = rng.normal(1.0, 0.1, (B, TH)).astype(np.float32)
    hm = np.ones((B, TH), bool)
    hm[0] = False  # no history: unknown
    hm[1, 5:] = False  # too short a history: unknown
    hm[4, 150:] = False
    cv = rng.normal(1.0, 0.05, (B, TC)).astype(np.float32)
    cv[2, 7] = 40.0  # upper breach
    cv[5, 3] = -5.0  # lower breach (row 5 judges both sides)
    cm = np.ones((B, TC), bool)
    cm[6] = False  # no current data: unknown
    # baselines sit a fixed shift below the current window, so every live
    # rank statistic is far from 0: near 0, a chi-square p-value moves
    # faster than f32 rounding of the statistic allows a 1e-5 match
    # (ROADMAP.md, Queue 3). Row 3 is a clearly shifted canary.
    shift = np.full((B, 1), 0.03, np.float32)
    shift[3] = 0.12
    bv = cv - shift
    bm = np.ones((B, TC), bool) if with_baseline else np.zeros((B, TC), bool)
    bm[7, 10:] = False
    times = np.zeros((B, TC), np.int32)
    return {
        "historical": {"values": hv, "mask": hm, "times": None},
        "current": {"values": cv, "mask": cm, "times": times},
        "baseline": {"values": bv, "mask": bm, "times": times},
        "threshold": np.array([2, 3, 2, 2, 5, 3, 2, 2], np.float32),
        "bound": np.array([1, 1, 1, 1, 2, 3, 1, 3], np.int32),
        "min_lower_bound": np.zeros(B, np.float32),
        "min_points": np.full(B, 10, np.int32),
    }


def _jax_batch(d):
    def win(w):
        t = w["times"]
        return JaxWindows(
            values=jnp.asarray(w["values"]),
            mask=jnp.asarray(w["mask"]),
            times=None if t is None else jnp.asarray(t),
        )

    return js.ScoreBatch(
        historical=win(d["historical"]),
        current=win(d["current"]),
        baseline=win(d["baseline"]),
        **{k: jnp.asarray(d[k]) for k in ("threshold", "bound", "min_lower_bound", "min_points")},
    )


def _assert_result(got, want, band_tol):
    np.testing.assert_array_equal(got.verdict.numpy(), np.asarray(want.verdict))
    np.testing.assert_array_equal(got.anomalies.numpy(), np.asarray(want.anomalies))
    np.testing.assert_array_equal(got.dist_differs.numpy(), np.asarray(want.dist_differs))
    np.testing.assert_allclose(got.p_value.numpy(), np.asarray(want.p_value), rtol=1e-5, atol=1e-5)
    for name in ("upper", "lower"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=band_tol, atol=band_tol,
        )


@pytest.mark.parametrize(
    "with_baseline,pairwise",
    [(False, "ALL"), (True, "ALL"), (True, "ANY"), (True, ts.PAIRWISE_NONE)],
)
def test_score_matches_jax(with_baseline, pairwise):
    d = _numpy_batch(with_baseline=with_baseline)
    got = ts.score(interop.score_batch_from_numpy(d, device="cpu"), pairwise_algorithm=pairwise)
    want = js.score(_jax_batch(d), pairwise_algorithm=pairwise)
    _assert_result(got, want, 1e-4)
    v = got.verdict.numpy()
    assert v[0] == v[1] == v[6] == ts.UNKNOWN
    assert v[2] == v[5] == ts.UNHEALTHY
    if pairwise == ts.PAIRWISE_NONE or not with_baseline:
        assert not got.dist_differs.any() and (got.p_value == 1.0).all()
    else:
        assert got.dist_differs[3]  # the shifted canary row
        assert not got.dist_differs.all()


def test_pack_and_score_bf16_delta_match_jax():
    d = _numpy_batch(seed=1)
    jb = _jax_batch(d)
    tb = interop.score_batch_from_numpy(d, device="cpu")
    j_slim, j_anchor, j_delta = js.make_bf16_delta_batch(jb)
    t_slim, t_anchor, t_delta = ts.make_bf16_delta_batch(tb)
    # the packing is exact: same anchor, bit-equal bf16 deltas
    np.testing.assert_array_equal(t_anchor.numpy(), np.asarray(j_anchor))
    np.testing.assert_array_equal(
        t_delta.view(torch.int16).numpy(),
        np.asarray(j_delta).view(np.int16),
    )
    assert t_slim.historical.values.shape == (B, 0)
    got = ts.score_bf16_delta(t_slim, t_anchor, t_delta)
    want = js.score_bf16_delta(j_slim, j_anchor, j_delta)
    _assert_result(got, want, 1e-5)


def test_fit_ma_from_bf16_delta_matches_jax():
    d = _numpy_batch(seed=2)
    _, j_anchor, j_delta = js.make_bf16_delta_batch(_jax_batch(d))
    _, t_anchor, t_delta = ts.make_bf16_delta_batch(interop.score_batch_from_numpy(d, device="cpu"))
    lens = d["historical"]["mask"].sum(axis=1).astype(np.int32)
    got = ts.fit_ma_from_bf16_delta(t_anchor, t_delta, torch.from_numpy(lens))
    want = js.fit_ma_from_bf16_delta(j_anchor, j_delta, jnp.asarray(lens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_fit_then_score_from_state_equals_fresh_score():
    """The fit-cache path: fit once, judge from the terminal state."""
    d = _numpy_batch(seed=3)
    tb = interop.score_batch_from_numpy(d, device="cpu")
    fc = ts.fit_forecast(tb.historical.values, tb.historical.mask)
    n_hist = tb.historical.count().to(torch.int32)
    cached = ts.score_from_state(
        tb, fc.level, fc.trend, fc.season, fc.season_phase, fc.scale, n_hist
    )
    fresh = ts.score(tb)
    for name in ("verdict", "anomalies", "dist_differs", "p_value"):
        assert torch.equal(getattr(cached, name), getattr(fresh, name)), name
    for name in ("upper", "lower"):
        # one-pass fit moments against the kernel's two-pass ones
        np.testing.assert_allclose(
            getattr(cached, name).numpy(), getattr(fresh, name).numpy(), rtol=1e-4, atol=1e-4
        )


def test_score_from_jax_fit_state_matches_jax():
    """A JAX fit-cache state, carried across as numpy, judges the same in
    the port — including a trended, seasonal state advanced over a gap."""
    d = _numpy_batch(seed=4)
    jb = _jax_batch(d)
    rng = np.random.default_rng(5)
    state = dict(
        level=rng.normal(1.0, 0.05, B).astype(np.float32),
        trend=rng.normal(0.0, 1e-4, B).astype(np.float32),
        season=rng.normal(0.0, 0.02, (B, 6)).astype(np.float32),
        season_phase=rng.integers(0, 6, B).astype(np.int32),
        scale=rng.uniform(0.05, 0.1, B).astype(np.float32),
        n_hist=np.full(B, 500, np.int32),
    )
    gap = np.array([0, 1, 5, 7, 3000, 2, 0, 9], np.int32)
    got = ts.score_from_state(
        interop.score_batch_from_numpy(d, device="cpu"),
        *interop.forecast_from_numpy(**state, device="cpu"),
        gap_steps=torch.from_numpy(gap),
    )
    want = js.score_from_state(
        jb, *(jnp.asarray(state[k]) for k in state), gap_steps=jnp.asarray(gap)
    )
    _assert_result(got, want, 1e-5)


def test_interop_takes_a_jax_batch_as_its_numpy_leaves():
    jb = _jax_batch(_numpy_batch(seed=6))
    leaves = jax.tree_util.tree_map(np.asarray, dataclasses.asdict(jb))
    tb = interop.score_batch_from_numpy(leaves, device="cpu")
    assert tb.historical.times is None and tb.current.times.dtype == torch.int32
    np.testing.assert_array_equal(tb.historical.mask.numpy(), np.asarray(jb.historical.mask))
    assert tb.bound.dtype == torch.int32 and tb.threshold.dtype == torch.float32


def test_unported_algorithm_raises():
    """Every univariate algorithm is ported; a name outside the registry
    (the joint models are judged elsewhere, by a later slice) raises as
    the JAX engine's lookup does."""
    tb = interop.score_batch_from_numpy(_numpy_batch(), device="cpu")
    for name in ("bivariate_normal", "lstm_autoencoder", "no_such_model"):
        with pytest.raises(KeyError):
            ts.score(tb, algorithm=name)
        with pytest.raises(KeyError):
            ts.fit_forecast(tb.historical.values, tb.historical.mask, algorithm=name)
        with pytest.raises(KeyError):
            js.fit_forecast(tb.historical.values.numpy(), tb.historical.mask.numpy(), algorithm=name)


# Every univariate algorithm of the JAX registry (AI_MODEL plus the three
# models/ registers), at a short season so the JAX programs compile fast.
ALGORITHMS = (
    "moving_average_all", "moving_average", "ewma", "exponential_smoothing",
    "double_exponential_smoothing", "holtwinters", "holt_winters", "phase_means",
    "auto_univariate", "seasonal", "prophet", "seasonal_hourly",
)
M, TS = 12, 128  # season length, history length (two periods of the hourly model)


def _seasonal_batch(seed=7):
    """Histories of the quality generator's kinds (period M) with gaps and a
    short history; currents that continue each signal, with 8-sigma
    spikes; canary baselines a fixed shift below; thresholds of 4 keep the
    unspiked points far from every band edge."""
    from benchmarks.quality import gen

    hv, cv = [], []
    for i, kind in enumerate(("flat", "seasonal", "sharp-seasonal", "trend", "shift")):
        h, c, _ = gen(kind, 2, TS, TC, seed=seed + i, period=M)
        hv.append(h)
        cv.append(c)
    hv, cv = np.concatenate(hv), np.concatenate(cv)
    b = hv.shape[0]
    hm = np.ones((b, TS), bool)
    hm[1, 100:] = False
    hm[3, :10] = False
    hm[5, 40:47] = False
    hm[7, 2 * M - 1 :] = False  # under two cycles: the mean model
    hm[9] = False  # no history: unknown
    hv[~hm] = 0.0
    cm = np.ones((b, TC), bool)
    cm[8, 20:] = False
    times = np.zeros((b, TC), np.int32)
    return {
        "historical": {"values": hv, "mask": hm, "times": None},
        "current": {"values": cv, "mask": cm, "times": times},
        "baseline": {"values": cv - 0.5, "mask": np.arange(b)[:, None] % 2 == np.zeros((b, TC), int), "times": times},
        "threshold": np.full(b, 4.0, np.float32),
        "bound": (np.arange(b) % 3 + 1).astype(np.int32),
        "min_lower_bound": np.zeros(b, np.float32),
        "min_points": np.full(b, 10, np.int32),
    }


def _assert_far_from_band_edges(want, d, margin=1e-4):
    """The data keep every judged current point `margin` away from JAX's
    band edges, so f32 differences in the fit cannot move a flag."""
    cur = d["current"]["values"]
    judged = d["current"]["mask"] & (np.asarray(want.verdict) != js.UNKNOWN)[:, None]
    for edge in (np.asarray(want.upper), np.asarray(want.lower)):
        gap = (np.abs(cur - edge) / (1 + np.abs(edge)))[judged]
        assert gap.min() > margin, f"a point sits {gap.min():.2e} from a band edge: pick other data"


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_score_and_fits_match_jax_for_every_algorithm(algorithm):
    """`score` (with a hist->cur gap advance), `fit_forecast` and
    `fit_forecast_bf16_delta` against the JAX programs: verdicts, flags
    and differs exact; bands and fitted state within 1e-3 (the seasonal
    and auto tolerance; the recurrences agree within 2e-4)."""
    d = _seasonal_batch()
    b = d["threshold"].shape[0]
    gap = np.arange(b, dtype=np.int32) * 5
    tb = interop.score_batch_from_numpy(d, device="cpu")
    jb = _jax_batch(d)
    got = ts.score(tb, gap_steps=torch.from_numpy(gap), algorithm=algorithm, season_length=M)
    want = js.score(jb, gap_steps=jnp.asarray(gap), algorithm=algorithm, season_length=M)
    _assert_far_from_band_edges(want, d)
    _assert_result(got, want, 1e-3)
    assert set(got.verdict.tolist()) >= {ts.UNKNOWN, ts.HEALTHY}

    hv, hm = d["historical"]["values"], d["historical"]["mask"]
    fields = ("level", "trend", "season", "season_phase", "scale")
    fc = ts.fit_forecast(torch.from_numpy(hv), torch.from_numpy(hm), algorithm=algorithm, season_length=M)
    want_fc = js.fit_forecast(jnp.asarray(hv), jnp.asarray(hm), algorithm=algorithm, season_length=M)
    for name in fields:
        np.testing.assert_allclose(
            getattr(fc, name).numpy(), np.asarray(getattr(want_fc, name)), rtol=1e-3, atol=1e-3, err_msg=name
        )
    # the bf16-delta upload: left-packed rows, the mask rebuilt from lens
    lens = hm.sum(axis=1).astype(np.int32)
    packed = np.zeros_like(hv)
    for i in range(b):
        packed[i, : lens[i]] = hv[i][hm[i]]
    anchor = np.where(lens > 0, packed[:, 0], 0.0).astype(np.float32)
    delta = np.where(np.arange(TS)[None, :] < lens[:, None], packed - anchor[:, None], 0.0).astype(np.float32)
    t_delta = torch.from_numpy(delta).to(torch.bfloat16)
    fc16 = ts.fit_forecast_bf16_delta(
        torch.from_numpy(anchor), t_delta, torch.from_numpy(lens), algorithm=algorithm, season_length=M
    )
    want16 = js.fit_forecast_bf16_delta(
        jnp.asarray(anchor), jnp.asarray(t_delta.float().numpy()).astype(jnp.bfloat16), jnp.asarray(lens),
        algorithm=algorithm, season_length=M,
    )
    for name in fields:
        np.testing.assert_allclose(
            getattr(fc16, name).numpy(), np.asarray(getattr(want16, name)), rtol=1e-3, atol=1e-3, err_msg=name
        )


def test_fit_forecast_bf16_delta_masks_with_a_select():
    """Masked slots reconstruct as +0.0 even under a negative anchor (a
    product with the mask would give -0.0)."""
    v, m = ts.bf16_delta_values(
        torch.tensor([-2.0]), torch.zeros((1, 4), dtype=torch.bfloat16), torch.tensor([2], dtype=torch.int32)
    )
    assert v[0, :2].tolist() == [-2.0, -2.0] and m[0].tolist() == [True, True, False, False]
    assert torch.equal(torch.signbit(v[0, 2:]), torch.tensor([False, False]))
