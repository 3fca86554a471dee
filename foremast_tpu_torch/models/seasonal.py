"""Seasonal trend model — the Prophet substitute.

The port of `foremast_tpu/models/seasonal.py`: a piecewise-linear trend
(hinges at evenly spaced interior knots, Prophet's changepoints) plus a
Fourier seasonality, fitted per series as a masked ridge regression in
closed form:

    y(t) ~ w0 + w1*t + sum_j d_j * max(t - c_j, 0)
                + sum_k [a_k sin(2 pi k t / P) + b_k cos(2 pi k t / P)]

The design matrix X [T, K] is shared by the batch. The per-series masked
Gram matrices are one [B, T] x [T, K*K] product (mask times the outer
products of the design rows; the masked design [B, T, K] is never
materialised), the right-hand sides one [B, T] x [T, K] product, and the
[B, K, K] systems one batched solve. The normal equations are
ill-conditioned, so the Gram, the right-hand sides and the solve run in
float64 and only the weights come back to f32: summed in f32, the fit
loses digits with the history's length (the JAX program's f32 fit is more
than 1e-3 off the exact one on 7-day histories,
`tests/test_torch_seasonal.py`). Float64 products never round through
TF32; the f32 products that remain (predictions, the cycle) are as exact
as `torch.backends.cuda.matmul.allow_tf32` allows, which is off by
default and must stay off.

Returns the standard `Forecast`: one full fitted cycle in `season`, so
`horizon` extrapolates trend + repeating seasonality.
"""

from __future__ import annotations

import math

import torch

from foremast_tpu_torch.ops.forecasters import (
    Forecast,
    _guard_unidentifiable,
    _last_valid,
    moving_average_all,
)
from foremast_tpu_torch.ops.windows import masked_std


def _knots(t_len: int, n_changepoints: int) -> list[float]:
    """Evenly spaced interior changepoint positions over the first 90% of
    the history."""
    if n_changepoints <= 0 or t_len < 4:
        return []
    hi = 0.9 * (t_len - 1)
    return [hi * (j + 1) / (n_changepoints + 1) for j in range(n_changepoints)]


def _design(
    t_idx: torch.Tensor,
    period: int,
    order: int,
    dtype,
    knots: list[float] = (),
    t_scale: float = 1.0,
) -> torch.Tensor:
    """Feature matrix [len(t_idx), 2 + len(knots) + 2*order]:
    [1, t/t_scale, hinge((t - c_j)/t_scale)..., sin/cos harmonics...];
    `t_scale` keeps the trend and hinge columns O(1)."""
    t = t_idx.to(dtype) / float(t_scale)
    cols = [torch.ones_like(t), t]
    for c in knots:
        cols.append((t - float(c / t_scale)).clamp_min(0.0))
    for k in range(1, order + 1):
        w = 2.0 * math.pi * k / (period / float(t_scale))
        cols.append(torch.sin(w * t))
        cols.append(torch.cos(w * t))
    return torch.stack(cols, dim=-1)


def fit_seasonal(
    values: torch.Tensor,
    mask: torch.Tensor,
    period: int = 1440,
    order: int = 3,
    ridge: float = 1e-3,
    n_changepoints: int = 8,
    cp_ridge: float = 1.0,
) -> Forecast:
    """Fit the piecewise-trend + Fourier model per series, values/mask
    [B, T]. `period` in time steps (1440 = daily at the 60 s step);
    `order` harmonics; `n_changepoints` hinge knots; `cp_ridge` scales the
    hinge columns' ridge. The terminal trend is the LAST segment's slope,
    so the horizon extrapolates the post-shift regime.

    Histories shorter than two periods keep the global-mean model: a
    static early-out on the batch length plus a per-series select."""
    b, t_len = values.shape
    if t_len < 2 * int(period):
        return moving_average_all(values, mask)
    dtype = values.dtype
    dev = values.device
    knots = _knots(t_len, n_changepoints)
    n_cp = len(knots)
    t_scale = float(t_len)
    x = _design(torch.arange(t_len, device=dev), period, order, dtype, knots, t_scale)
    k = x.shape[-1]
    m = mask.to(dtype)
    f64 = torch.float64
    outer = (x[:, :, None] * x[:, None, :]).reshape(t_len, k * k)
    gram = (m.to(f64) @ outer.to(f64)).view(b, k, k)
    rhs = (m * values).to(f64) @ x.to(f64)
    # per-column ridge: the hinge columns carry cp_ridge (Prophet's
    # changepoint prior as a diagonal Tikhonov term)
    ridge_diag = torch.tensor(
        [ridge, ridge] + [ridge * cp_ridge] * n_cp + [ridge] * (2 * order), dtype=f64
    ).to(dev)
    system = gram + torch.diag(ridge_diag)[None]
    w = torch.linalg.solve_ex(system, rhs[..., None])[0][..., 0].to(dtype)

    pred = w @ x.t()
    scale = masked_std((values - pred) * m, mask)

    # one full cycle over ABSOLUTE phases, so the horizon resumes right
    # after each series' last VALID step, not the bucket-padded end
    xf = _design(torch.arange(period, device=dev), period, order, dtype, t_scale=t_scale)
    last_valid = _last_valid(mask)
    lv = last_valid.to(dtype) / t_scale
    level = w[:, 0] + w[:, 1] * lv
    trend = w[:, 1] / t_scale
    for j, c in enumerate(knots):
        d_j = w[:, 2 + j]
        cn = c / t_scale
        level = level + d_j * (lv - cn).clamp_min(0.0)
        trend = trend + d_j * (lv > cn).to(dtype) / t_scale
    seas_f = w[:, 2 + n_cp :] @ xf[:, 2:].t()
    fc = Forecast(
        pred=pred,
        scale=scale,
        level=level,
        trend=trend,
        season=seas_f,
        season_phase=((last_valid + 1) % period).to(torch.int32),
    )
    return _guard_unidentifiable(fc, values, mask, int(period))
