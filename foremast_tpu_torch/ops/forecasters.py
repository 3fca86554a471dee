"""Batched masked forecasters: the deployed default `moving_average_all`.

A `Forecast` carries in-sample predictions, the residual scale and the
terminal state (level/trend/season) that `horizon` extrapolates, as in
`foremast_tpu/ops/forecasters.py`. The other forecasters of the JAX
package are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from foremast_tpu_torch.ops import kernels
from foremast_tpu_torch.ops.windows import masked_moments


@dataclasses.dataclass(frozen=True)
class Forecast:
    """Fitted forecaster state for a batch of series.

    pred:   [B, T] one-step-ahead in-sample predictions
    scale:  [B]    residual standard deviation (deviation unit for bounds)
    level:  [B]    terminal level
    trend:  [B]    terminal per-step trend (0 for trendless models)
    season: [B, m] terminal seasonal offsets (m=1 zeros when non-seasonal)
    season_phase: [B] int32 — season index of the first forecast step
    """

    pred: torch.Tensor
    scale: torch.Tensor
    level: torch.Tensor
    trend: torch.Tensor
    season: torch.Tensor
    season_phase: torch.Tensor


def _finalize(pred, level, trend, scale) -> Forecast:
    """A trendless or trended, non-seasonal forecast: m=1 zero season."""
    b = level.shape[0]
    return Forecast(
        pred=pred,
        scale=scale,
        level=level,
        trend=trend,
        season=torch.zeros((b, 1), dtype=level.dtype, device=level.device),
        season_phase=torch.zeros((b,), dtype=torch.int32, device=level.device),
    )


def horizon(fc: Forecast, h: int) -> torch.Tensor:
    """Extrapolate h future points from terminal state -> [B, h]."""
    dev = fc.level.device
    steps = torch.arange(1, h + 1, dtype=fc.level.dtype, device=dev)
    base = fc.level[:, None] + fc.trend[:, None] * steps[None, :]
    m = fc.season.shape[-1]
    idx = (fc.season_phase.long()[:, None] + torch.arange(h, device=dev)[None, :]) % m
    return base + torch.gather(fc.season, -1, idx)


def moving_average_all(values: torch.Tensor, mask: torch.Tensor) -> Forecast:
    """Global-mean model over the whole masked history (the reference's
    deployed default, `foremast-brain.yaml:24-25`): level = historical
    mean, scale = historical std (ddof 0).

    On a CUDA tensor the moments come from the `masked_stats` kernel
    (two-pass, one read of the row from device memory); on the CPU from
    the shifted one-pass `masked_moments`, the JAX package's algebra.
    The two agree to f32 rounding (1e-4 band tolerance in the tests)."""
    b, t_len = values.shape
    if t_len == 0:  # empty-history batch: unmeasurable, not a crash
        zeros = torch.zeros((b,), dtype=values.dtype, device=values.device)
        return _finalize(values, level=zeros, trend=zeros, scale=zeros)
    if values.is_cuda:
        _, mu, scale = kernels.masked_stats(values, mask)
    else:
        _, mu, var = masked_moments(values, mask)
        scale = torch.sqrt(var)
    pred = mu[:, None].expand(values.shape)
    return _finalize(pred, level=mu, trend=torch.zeros_like(mu), scale=scale)
