"""Host-side float64 quantiles of the joint detectors' cutoffs.

The JAX package calls scipy for two calibrations, and the port keeps
scipy out: `residual_mvn.chi2_quantile` (the chi^2_k cutoff) and
`lstm_ae.ae_cutoff` (a gamma quantile of reconstruction error). Both
want the quantile whose upper tail equals the two-sided normal tail
P(|z| > threshold), and chi^2_k is gamma(k/2, scale 2), so one routine
serves both: `gamma_isf` inverts the regularized upper incomplete gamma
function (`torch.special.gammaincc`) by bisection on log x, in float64
on the CPU. Called once per judgment batch on a few values; nothing
here touches the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# log-space bracket of the standardized quantile: below the smallest
# subnormal double, above any tail the callers ask for (tail >= 1e-300)
_LOG_LO = -746.0
_LOG_HI = 710.0
_ITERS = 80  # 1456 / 2^80: the bracket shrinks far below one ulp of x


def norm_sf(x) -> np.ndarray:
    """Upper tail of the standard normal, P(z > x), float64 (ndtr(-x))."""
    x = np.asarray(x, np.float64)
    return np.vectorize(lambda v: 0.5 * math.erfc(v / math.sqrt(2.0)), otypes=[np.float64])(x)


def two_sided_tail(threshold) -> np.ndarray:
    """P(|z| > threshold), clipped to [1e-300, 1] as both callers clip it."""
    return np.clip(2.0 * norm_sf(threshold), 1e-300, 1.0)


def gamma_isf(tail, shape) -> np.ndarray:
    """x with Q(shape, x) = tail, for the standard gamma (scale 1).

    `tail` and `shape` broadcast; float64 out. The upper tail is what
    scipy's ppf at q = 1 - tail inverts (it rounds 1 - q back to a
    tail first), so the caller passes `1 - (1 - tail)`, computed as
    scipy computes it. Bisection keeps the invariant Q(lo) >= tail >
    Q(hi), which Q's monotone decrease in x makes a bracket."""
    tail, shape = np.broadcast_arrays(np.asarray(tail, np.float64), np.asarray(shape, np.float64))
    q = torch.from_numpy(np.array(tail))
    a = torch.from_numpy(np.array(shape))
    lo = torch.full_like(q, _LOG_LO)
    hi = torch.full_like(q, _LOG_HI)
    for _ in range(_ITERS):
        mid = 0.5 * (lo + hi)
        above = torch.special.gammaincc(a, torch.exp(mid)) >= q
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    x = torch.exp(0.5 * (lo + hi)).numpy()
    # the ends scipy returns exactly: no tail left, or all of it
    return np.where(tail <= 0.0, np.inf, np.where(tail >= 1.0, 0.0, x))


def gamma_ppf(q, shape, scale) -> np.ndarray:
    """The gamma(shape, scale) quantile at lower-tail probability `q`,
    float64; NaN where shape <= 0 or scale <= 0 (as scipy's ppf)."""
    q = np.asarray(q, np.float64)
    shape = np.asarray(shape, np.float64)
    scale = np.asarray(scale, np.float64)
    ok = (shape > 0) & (scale > 0)
    x = gamma_isf(1.0 - q, np.where(ok, shape, 1.0)) * np.where(ok, scale, 1.0)
    return np.where(ok, x, np.nan)
