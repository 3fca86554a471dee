"""The port's seasonal model (the Prophet substitute) and its registry
entries on the CPU against the JAX package's `models/seasonal.py`.

The design matrix is built with the same f32 operations (sin/cos from two
libraries: 1e-6). The fit's normal equations are ill-conditioned, and the
port accumulates them in float64 where JAX uses f32 at
`Precision.HIGHEST`: fitted state agrees within 1e-3, the tolerance
`tests/test_forecasters.py` allows this model, and so do predictions on
valid points up to T = 512; phases exactly. At T = 10,080 JAX's f32 fit
itself is up to 1e-2 off the exact fit in its in-sample predictions
(ROADMAP.md Queue 3), so there the port's predictions are held to a
float64 fit (1e-5) and to JAX's within 1.5e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.quality import gen
from foremast_tpu.engine import scoring as js
from foremast_tpu.models import seasonal as jseas
from foremast_tpu_torch.engine import scoring as ts
from foremast_tpu_torch.models import seasonal as tseas
from foremast_tpu_torch.ops.forecasters import horizon

FIELDS = ("pred", "scale", "level", "trend", "season", "season_phase")


def _batch(period: int, t_len: int, seed: int = 3):
    v = np.concatenate([gen(k, 1, t_len, 30, seed=seed + i, period=period)[0]
                        for i, k in enumerate(("flat", "seasonal", "trend", "shift"))])
    mk = np.ones(v.shape, bool)
    mk[1, : period // 2] = False
    mk[2, t_len // 2 : t_len // 2 + 7] = False
    mk[3, (3 * t_len) // 4 :] = False
    v[~mk] = 0.0
    return v, mk


def _assert_forecast(got, want, mk, tol=1e-3, pred_tol=1e-3):
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name == "season_phase":
            np.testing.assert_array_equal(g, w)
        elif name == "pred":
            np.testing.assert_allclose(g[mk], w[mk], rtol=pred_tol, atol=pred_tol)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("t_len,n_cp", [(4, 8), (100, 8), (1000, 0), (16384, 8)])
def test_knots_and_design_match_jax(t_len, n_cp):
    knots = tseas._knots(t_len, n_cp)
    assert knots == jseas._knots(t_len, n_cp)
    got = tseas._design(torch.arange(t_len), 1440, 3, torch.float32, knots, float(t_len))
    want = jseas._design(jnp.arange(t_len), 1440, 3, jnp.float32, knots, float(t_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "period,order,t_len", [(24, 3, 512), (60, 2, 400), (1440, 3, 10080)],
    ids=["daily-24", "hourly", "daily-1440"],
)
def test_fit_seasonal_matches_jax(period, order, t_len):
    v, mk = _batch(period, t_len)
    got = tseas.fit_seasonal(torch.from_numpy(v), torch.from_numpy(mk), period=period, order=order)
    want = jseas.fit_seasonal(jnp.asarray(v), jnp.asarray(mk), period=period, order=order)
    long = t_len > 512
    _assert_forecast(got, want, mk, pred_tol=1.5e-2 if long else 1e-3)
    exact = tseas.fit_seasonal(torch.from_numpy(v).double(), torch.from_numpy(mk), period=period, order=order)
    np.testing.assert_allclose(got.pred.numpy()[mk], exact.pred.numpy()[mk], rtol=1e-5, atol=1e-5)
    assert np.abs(got.season[1].numpy()).max() > 0.2  # the seasonal row's cycle


def test_fit_seasonal_guards_short_histories():
    """A batch under two periods is the mean model outright ([B, 1]
    season); inside a long batch, a short real history is selected back
    to the mean model per series."""
    v, mk = _batch(24, 40)
    short = tseas.fit_seasonal(torch.from_numpy(v), torch.from_numpy(mk), period=24)
    assert short.season.shape == (4, 1)
    v, mk = _batch(24, 512)
    mk[0, 47:] = False
    got = tseas.fit_seasonal(torch.from_numpy(v), torch.from_numpy(mk), period=24)
    assert float(got.season[0].abs().max()) == 0.0 and float(got.trend[0]) == 0.0
    want = jseas.fit_seasonal(jnp.asarray(v), jnp.asarray(mk), period=24)
    _assert_forecast(got, want, mk)


def test_seasonal_horizon_phase_ignores_bucket_padding():
    period = 24
    t = np.arange(288, dtype=np.float32)
    x = (5 + 2 * np.sin(2 * np.pi * t / period)).astype(np.float32)

    def padded(n):
        v = np.zeros((1, n), np.float32)
        v[0, :288] = x
        mk = np.zeros((1, n), bool)
        mk[0, :288] = True
        return torch.from_numpy(v), torch.from_numpy(mk)

    exact = tseas.fit_seasonal(*padded(288), period=period, order=2)
    pad = tseas.fit_seasonal(*padded(512), period=period, order=2)
    np.testing.assert_allclose(horizon(pad, period).numpy(), horizon(exact, period).numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("algorithm", ["seasonal", "prophet", "seasonal_hourly"])
def test_registry_resolves_the_seasonal_models_as_jax(algorithm):
    """`models/` registers seasonal, prophet (period = the configured
    season) and seasonal_hourly (period 60, order 2; the configured season
    is not passed), resolved from `_fit_model` as in the JAX engine."""
    v, mk = _batch(24, 512)
    got = ts.fit_forecast(torch.from_numpy(v), torch.from_numpy(mk), algorithm=algorithm, season_length=24)
    want = js.fit_forecast(jnp.asarray(v), jnp.asarray(mk), algorithm=algorithm, season_length=24)
    _assert_forecast(got, want, mk)
    assert got.season.shape[1] == (60 if algorithm == "seasonal_hourly" else 24)
    assert ts.AI_MODEL[algorithm] is not None
