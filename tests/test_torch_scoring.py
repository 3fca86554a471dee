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
    tb = interop.score_batch_from_numpy(_numpy_batch(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.score(tb, algorithm="holtwinters")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.fit_forecast(tb.historical.values, tb.historical.mask, algorithm="ewma")
