"""Seasonal-residual multivariate Gaussian — the joint contextual detector.

Companion of the LSTM autoencoder for 2+ metric jobs, as in the JAX
package's `models/residual_mvn.py`: per-metric causal Holt-Winters
residuals (`hw_continue` predictions never see the point they score, so
an anomaly cannot be copied, and the seasonal state removes the cycle),
then a full-covariance Gaussian over the F-dimensional residual vector,
so a single metric deviating from the pack scores a large Mahalanobis
distance. The cutoff is the chi^2_F quantile whose tail mass equals the
two-sided normal tail P(|z| > threshold).

The 7-day fit runs the per-series `holt_winters_scan` kernel over the
[B*F, Th] histories; the current-window continuation is plain torch
(`ops.forecasters.hw_continue`), and the distance is ||L^-1 d||^2 with L
the covariance's Cholesky factor, unrolled over the F <= 8 metrics in
plain tensor ops: the library's batched solves check their `info` on the
host, which would make the warm dispatch wait for the device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from foremast_tpu_torch.ops.forecasters import Forecast, holt_winters, hw_continue
from foremast_tpu_torch.ops.quantiles import gamma_ppf, two_sided_tail
from foremast_tpu_torch.ops.windows import to_device

# Holt-Winters smoothing used for residual extraction (fixed, not
# grid-fit: the residual covariance absorbs model error).
HW_PARAMS = (0.3, 0.05, 0.1)
SEASON_LENGTH = 24


@dataclasses.dataclass(frozen=True)
class MVNState:
    """Fitted residual model for a batch of F-metric jobs.

    hw:    Forecast with [B*F]-flattened leaves (terminal HW state per
           (job, metric) series; season [B*F, m])
    mu:    [B, F]    historical residual means
    cov:   [B, F, F] historical residual covariance (ridge-regularized)
    valid: [B]       enough history + well-conditioned covariance
    """

    hw: Forecast
    mu: torch.Tensor
    cov: torch.Tensor
    valid: torch.Tensor


@functools.lru_cache(maxsize=256)
def chi2_quantile(threshold: float, dof: int) -> float:
    """chi^2_dof cutoff with the same tail mass as P(|z| > threshold).

    Host-side float64 (chi^2_k is gamma(k/2, scale 2)), called once per
    judgment batch with a static dof."""
    p_tail = float(two_sided_tail(threshold))
    return float(gamma_ppf(1.0 - p_tail, dof / 2.0, 2.0))


def fit_residual_mvn(
    hist: torch.Tensor,
    mask: torch.Tensor | None = None,
    season_length: int = SEASON_LENGTH,
    min_points: int = 10,
    ridge: float = 1e-6,
) -> MVNState:
    """Fit per-metric HW + residual covariance.

    hist: [B, F, Th] aligned joint histories (every metric of a job
    shares one validity pattern); mask: [B, Th] valid-prefix mask (None
    = all valid). A batch whose STATIC length holds fewer than two full
    seasons fits with season length 1 (Holt's linear method): the cycle
    is unidentifiable there, the covariance still learns co-movement."""
    b, f, th = hist.shape
    a, bt, g = HW_PARAMS
    m_eff = int(season_length) if th >= 2 * int(season_length) else 1
    if mask is None:
        mask = torch.ones((b, th), dtype=torch.bool, device=hist.device)
    flat = hist.reshape(b * f, th)
    mflat = mask.repeat_interleave(f, dim=0)
    fc = holt_winters(flat, mflat, m_eff, a, bt, g)
    resid = (flat - fc.pred).reshape(b, f, th)
    # drop the first season: those predictions come from the init state
    warm_mask = mask & (torch.arange(th, device=hist.device)[None, :] >= m_eff)
    n = warm_mask.sum(dim=-1).clamp_min(1)  # [B]
    w = warm_mask[:, None, :].to(resid.dtype)
    nf = n.to(resid.dtype)
    mu = (resid * w).sum(dim=-1) / nf[:, None]  # [B, F]
    rc = (resid - mu[:, :, None]) * w
    cov = torch.einsum("bft,bgt->bfg", rc, rc) / nf[:, None, None]
    # scale-aware ridge keeps tiny-magnitude metrics invertible
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(dim=-1) / f
    eye = torch.eye(f, dtype=cov.dtype, device=cov.device)
    cov = cov + (ridge * tr + 1e-12)[:, None, None] * eye
    sign, logdet = torch.linalg.slogdet(cov)
    valid = (n >= min_points) & (sign > 0) & torch.isfinite(logdet)
    return MVNState(hw=fc, mu=mu, cov=cov, valid=valid)


def fit_residual_mvn_bf16_delta(
    anchor: torch.Tensor,
    delta: torch.Tensor,
    mask: torch.Tensor | None = None,
    season_length: int = SEASON_LENGTH,
    min_points: int = 10,
    ridge: float = 1e-6,
) -> MVNState:
    """`fit_residual_mvn` from an anchor-shifted bf16-delta upload:
    anchor [B, F] f32, delta [B, F, Th] bf16 (exact zeros where masked);
    f32 values are rebuilt on the device and masked slots to exact zero."""
    values = anchor[:, :, None] + delta.float()
    if mask is not None:
        values = values * mask[:, None, :]
    return fit_residual_mvn(
        values, mask, season_length=season_length, min_points=min_points, ridge=ridge
    )


def _d2(state: MVNState, cur: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """d^2 [B, Tc] with per-(job, t) state-update gating: upd False
    carries the HW state THROUGH a point (still scored against the
    un-updated prediction); the phase advances either way. The season
    length is the state's own buffer width."""
    b, f, tc = cur.shape
    a, bt, g = HW_PARAMS
    flat = cur.reshape(b * f, tc)
    pred, _ = hw_continue(
        state.hw, flat, upd.repeat_interleave(f, dim=0), state.hw.season.shape[-1], a, bt, g
    )
    d = (flat - pred).reshape(b, f, tc) - state.mu[:, :, None]  # [B, F, Tc]
    return _mahalanobis2(state.cov, d)


def _mahalanobis2(cov: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d^T cov^-1 d per job and step: cov [B, F, F] symmetric positive
    definite, d [B, F, T] -> [B, T]. The Cholesky factor L (cov = L L^T)
    by columns, then y = L^-1 d by forward substitution, d2 = |y|^2; a
    matrix that is not positive definite gives NaN, which no cutoff
    exceeds (such fits are invalid and flag nothing)."""
    f = cov.shape[-1]
    low = [[None] * f for _ in range(f)]
    for j in range(f):
        s = cov[:, j, j]
        for k in range(j):
            s = s - low[j][k] * low[j][k]
        low[j][j] = torch.sqrt(s)
        for i in range(j + 1, f):
            s = cov[:, i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            low[i][j] = s / low[j][j]
    ys = []
    for i in range(f):
        s = d[:, i]
        for k in range(i):
            s = s - low[i][k][:, None] * ys[k]
        ys.append(s / low[i][i][:, None])
    return sum(y * y for y in ys)


def residual_mvn_d2(state: MVNState, cur: torch.Tensor) -> torch.Tensor:
    """Mahalanobis d^2 [B, Tc] for aligned joint current windows [B, F, Tc]."""
    b, _, tc = cur.shape
    return _d2(state, cur, torch.ones((b, tc), dtype=torch.bool, device=cur.device))


def _per_row(cutoff, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] cutoff against [B, T] values, without a blocking
    host-to-device copy."""
    if isinstance(cutoff, torch.Tensor):
        c = cutoff.to(like.dtype)
    elif np.ndim(cutoff) == 0:
        c = torch.full((), float(cutoff), dtype=like.dtype, device=like.device)
    else:
        c = to_device(np.asarray(cutoff, np.float32), like.device).to(like.dtype)
    return c[:, None] if c.ndim == 1 else c


def residual_mvn_d2_robust(state: MVNState, cur: torch.Tensor, gate_cutoff) -> torch.Tensor:
    """Two-pass outlier-robust d^2 (the judge's scoring path): pass 2
    recomputes d^2 with state updates gated OFF at every point pass 1 put
    over `gate_cutoff` [B], so a spike never enters the state and leaves
    no echo behind it."""
    d2 = residual_mvn_d2(state, cur)
    return _d2(state, cur, ~(d2 > _per_row(gate_cutoff, d2)))


def score_residual_mvn(state: MVNState, cur: torch.Tensor, d2_cutoff) -> torch.Tensor:
    """Anomaly flags [B, Tc]: d^2 over the calibrated cutoff
    (`chi2_quantile`); invalid fits flag nothing."""
    d2 = residual_mvn_d2(state, cur)
    return (d2 > _per_row(d2_cutoff, d2)) & state.valid[:, None]
