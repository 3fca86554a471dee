"""Bivariate normal detector for 2-metric jobs.

The JAX package's `models/bivariate.py`: the historical joint
distribution of two metrics is fit as a 2-D Gaussian (masked moment sums
over the [B, T] history) and current points are scored by Mahalanobis
distance through the explicit 2x2 inverse — plain tensor reductions.
"""

from __future__ import annotations

import dataclasses

import torch

from foremast_tpu_torch.models.residual_mvn import _per_row
from foremast_tpu_torch.ops.windows import masked_mean


@dataclasses.dataclass(frozen=True)
class BivariateFit:
    """mean: [B, 2]; cov: [B, 2, 2]; valid: [B] (enough points, non-singular)."""

    mean: torch.Tensor
    cov: torch.Tensor
    valid: torch.Tensor


def fit_bivariate(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, min_points: int = 10) -> BivariateFit:
    """Fit a 2-D Gaussian to paired histories. x/y/mask: [B, T]. Below
    `min_points`, or with a degenerate covariance, valid=False."""
    mx = masked_mean(x, mask)
    my = masked_mean(y, mask)
    m = mask.to(x.dtype)
    n = m.sum(dim=-1)
    dx = (x - mx[:, None]) * m
    dy = (y - my[:, None]) * m
    denom = n.clamp_min(1.0)
    sxx = (dx * dx).sum(dim=-1) / denom
    syy = (dy * dy).sum(dim=-1) / denom
    sxy = (dx * dy).sum(dim=-1) / denom
    mean = torch.stack([mx, my], dim=-1)
    cov = torch.stack([torch.stack([sxx, sxy], -1), torch.stack([sxy, syy], -1)], dim=-2)
    det = sxx * syy - sxy * sxy
    # relative conditioning test: scale-free, so low-magnitude metric
    # pairs stay valid while degenerate fits are rejected
    valid = (n >= min_points) & (det > 1e-6 * sxx * syy) & (sxx * syy > 0)
    return BivariateFit(mean=mean, cov=cov, valid=valid)


def mahalanobis2(fit: BivariateFit, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of current points. x/y: [B, T] -> [B, T]."""
    dx = x - fit.mean[:, 0:1]
    dy = y - fit.mean[:, 1:2]
    sxx = fit.cov[:, 0, 0][:, None]
    syy = fit.cov[:, 1, 1][:, None]
    sxy = fit.cov[:, 0, 1][:, None]
    det = (sxx * syy - sxy * sxy).clamp_min(1e-30)
    return (syy * dx * dx - 2.0 * sxy * dx * dy + sxx * dy * dy) / det


def detect_bivariate(fit: BivariateFit, x, y, mask, threshold=2.0) -> torch.Tensor:
    """Anomaly flags [B, T]: d^2 > threshold^2 (the chi^2(2) reading of
    |z| > threshold); `threshold` scalar or [B]. Invalid fits flag nothing."""
    d2 = mahalanobis2(fit, x, y)
    thr = _per_row(threshold, d2)
    return mask & (d2 > thr * thr) & fit.valid[:, None]


def fit_bivariate_bf16_delta(anchor_x, delta_x, anchor_y, delta_y, mask, min_points: int = 10) -> BivariateFit:
    """`fit_bivariate` from the anchor-shifted bf16-delta upload (f32
    anchor [B], bf16 delta [B, T] per metric, exact zeros where masked);
    the mask multiplies back in so masked slots rebuild to exact zero."""
    m = mask.to(torch.float32)
    x = (anchor_x[:, None] + delta_x.float()) * m
    y = (anchor_y[:, None] + delta_y.float()) * m
    return fit_bivariate(x, y, mask, min_points=min_points)


def detect_bivariate_from_rows(mean, cov, rows, x, y, mask, threshold) -> torch.Tensor:
    """`detect_bivariate` against arena-resident fits: `mean` [capacity,
    2] and `cov` [capacity, 2, 2] hold one valid fit per row and `rows`
    [B] indexes the batch's rows, gathered on the device."""
    fit = BivariateFit(
        mean=mean.index_select(0, rows),
        cov=cov.index_select(0, rows),
        valid=torch.ones(rows.shape, dtype=torch.bool, device=rows.device),
    )
    return detect_bivariate(fit, x, y, mask, threshold)
