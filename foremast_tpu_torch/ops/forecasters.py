"""Batched masked forecasters on torch tensors.

The JAX package's univariate model zoo (`foremast_tpu/ops/forecasters.py`):
the global mean `moving_average_all` (the deployed default), the rolling
mean, EWMA, Holt's linear trend, additive Holt-Winters and its grid-fitted
form, the pooled phase means for long seasons, and the structure-screened
`fit_auto_univariate`. Every forecaster is batched over a leading [B] axis
and handles ragged history with validity masks.

The sequential recurrences run as hand-written CUDA kernels on the card
(`ops/kernels.py`: `holt_winters_scan`, `holt_scan`); EWMA's linear
recurrence is a log-depth scan of plain tensor ops, as JAX runs it
(`lax.associative_scan`); the rest are parallel reductions.

A `Forecast` carries in-sample predictions, the residual scale and the
terminal state (level/trend/season) that `horizon` extrapolates.
"""

from __future__ import annotations

import dataclasses

import torch

from foremast_tpu_torch.ops import kernels
from foremast_tpu_torch.ops.windows import masked_mean, masked_moments, masked_std


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


def _finalize(
    pred, values, mask, level, trend, season=None, season_phase=None, scale=None
) -> Forecast:
    """A Forecast; the scale defaults to the masked residual std (ddof 0)
    and a non-seasonal fit gets an m=1 zero season."""
    if scale is None:
        scale = masked_std(values - pred, mask, ddof=0)
    b = values.shape[0]
    if season is None:
        season = torch.zeros((b, 1), dtype=values.dtype, device=values.device)
        season_phase = torch.zeros((b,), dtype=torch.int32, device=values.device)
    return Forecast(
        pred=pred,
        scale=scale,
        level=level,
        trend=trend,
        season=season,
        season_phase=season_phase,
    )


def _select(flag: torch.Tensor, a: Forecast, b: Forecast) -> Forecast:
    """Per-series select of every leaf: a where flag [B], else b."""

    def sel(x, y):
        return torch.where(flag.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)

    return Forecast(**{f.name: sel(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)})


_last_valid = kernels.last_valid_index  # [B] int64, -1 for an empty row


def horizon(fc: Forecast, h: int) -> torch.Tensor:
    """Extrapolate h future points from terminal state -> [B, h]."""
    dev = fc.level.device
    steps = torch.arange(1, h + 1, dtype=fc.level.dtype, device=dev)
    base = fc.level[:, None] + fc.trend[:, None] * steps[None, :]
    m = fc.season.shape[-1]
    idx = (fc.season_phase.long()[:, None] + torch.arange(h, device=dev)[None, :]) % m
    return base + torch.gather(fc.season, -1, idx)


# ---------------------------------------------------------------------------
# Moving averages
# ---------------------------------------------------------------------------


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
        return _finalize(values, values, mask, level=zeros, trend=zeros, scale=zeros)
    if values.is_cuda:
        _, mu, scale = kernels.masked_stats(values, mask)
    else:
        _, mu, var = masked_moments(values, mask)
        scale = torch.sqrt(var)
    pred = mu[:, None].expand(values.shape)
    return _finalize(pred, values, mask, level=mu, trend=torch.zeros_like(mu), scale=scale)


def moving_average(values: torch.Tensor, mask: torch.Tensor, window: int = 10) -> Forecast:
    """Causal rolling mean of the previous `window` time steps.

    pred[t] = mean of valid points in [t-window, t); the running global
    mean until the window holds a valid point; the point itself where no
    point precedes it. Prefix sums, as in the JAX package."""
    b, t_len = values.shape
    m = mask.to(values.dtype)
    v = values * m
    csum_v = torch.cumsum(v, dim=-1)
    csum_m = torch.cumsum(m, dim=-1)
    pad = torch.zeros_like(csum_v[:, :1])
    prev_v = torch.cat([pad, csum_v[:, :-1]], dim=-1)
    prev_m = torch.cat([pad, csum_m[:, :-1]], dim=-1)
    lo_v = torch.zeros_like(prev_v)
    lo_m = torch.zeros_like(prev_m)
    if t_len > window:
        lo_v[:, window:] = prev_v[:, : t_len - window]
        lo_m[:, window:] = prev_m[:, : t_len - window]
    win_v = prev_v - lo_v
    win_m = prev_m - lo_m
    run_mean = prev_v / prev_m.clamp_min(1.0)
    pred = torch.where(win_m > 0, win_v / win_m.clamp_min(1.0), run_mean)
    pred = torch.where(prev_m == 0, values, pred)
    last_mask = mask & (csum_m > (csum_m[:, -1:] - window).clamp_min(0.0))
    level = masked_mean(values, last_mask)
    return _finalize(pred, values, mask, level=level, trend=torch.zeros_like(level))


# ---------------------------------------------------------------------------
# Exponential smoothing (log-depth scan of a linear recurrence)
# ---------------------------------------------------------------------------


def _linrec_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of l_t = a_t * l_{t-1} + b_t along the last axis
    with l_{-1} = 0, as ceil(log2 T) Hillis-Steele passes of the JAX
    package's composition law (a1, b1) then (a2, b2) -> (a1*a2, a2*b1 + b2).
    Returns the composed b, which is the level."""
    t_len = a.shape[-1]
    d = 1
    while d < t_len:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=-1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=-1)
        d *= 2
    return b


def ewma_levels(values: torch.Tensor, mask: torch.Tensor, alpha) -> torch.Tensor:
    """Exponentially weighted level after each step, [B, T]:
    l_t = (1-a_t) l_{t-1} + a_t x_t, with a_t = 1 at the first valid point
    and 0 at masked steps. `alpha` may be scalar or [B]."""
    alpha = torch.as_tensor(alpha, dtype=values.dtype, device=values.device)
    if alpha.ndim == 1:
        alpha = alpha[:, None]
    csum = torch.cumsum(mask.to(torch.int32), dim=-1)
    is_first = mask & (csum == 1)
    a_eff = torch.where(mask, alpha, torch.zeros((), dtype=values.dtype, device=values.device))
    a_eff = torch.where(is_first, torch.ones((), dtype=values.dtype, device=values.device), a_eff)
    return _linrec_scan(1.0 - a_eff, a_eff * values)


def ewma(values: torch.Tensor, mask: torch.Tensor, alpha: float = 0.3) -> Forecast:
    """EWMA forecaster: pred[t] is the EW level of the points before t."""
    levels = ewma_levels(values, mask, alpha)
    shifted = torch.cat([levels[:, :1] * 0, levels[:, :-1]], dim=-1)
    mi = mask.to(torch.int32)
    inited_before = (torch.cumsum(mi, dim=-1) - mi) > 0
    pred = torch.where(inited_before, shifted, values)
    level = levels[:, -1]
    return _finalize(pred, values, mask, level=level, trend=torch.zeros_like(level))


# ---------------------------------------------------------------------------
# Double exponential smoothing (Holt's linear trend)
# ---------------------------------------------------------------------------


def double_exponential(
    values: torch.Tensor, mask: torch.Tensor, alpha: float = 0.3, beta: float = 0.1
) -> Forecast:
    """Holt's linear method: level <- first valid point, trend <- 0, then
    the level/trend update at every valid step; masked steps carry the
    state. The recurrence is the `holt_scan` kernel on the card."""
    level, trend, pred = kernels.holt_scan(values, mask, alpha, beta)
    return _finalize(pred, values, mask, level=level, trend=trend)


# ---------------------------------------------------------------------------
# Holt-Winters (additive seasonal)
# ---------------------------------------------------------------------------

# Season lengths up to this use the fitted Holt-Winters as auto's
# adaptive candidate; longer ones the pooled phase means (the JAX
# package's unrolled/rolled program boundary, kept for the selection).
_HW_UNROLL_MAX = 64


def _hw_init(values: torch.Tensor, mask: torch.Tensor, m_len: int):
    """Initial state: level <- mean of the first season's valid points,
    seasonal offsets <- first-season residuals vs that mean (0 where the
    slot is invalid or past the history)."""
    b, t_len = values.shape
    first_season_mask = mask & (torch.arange(t_len, device=values.device)[None, :] < m_len)
    init_level = masked_mean(values, first_season_mask)
    fs_vals = values[:, :m_len]
    fs_mask = first_season_mask[:, :m_len]
    pad = m_len - min(m_len, t_len)
    if pad:
        fs_vals = torch.nn.functional.pad(fs_vals, (0, pad))
        fs_mask = torch.nn.functional.pad(fs_mask, (0, pad))
    init_season = torch.where(fs_mask, fs_vals - init_level[:, None], torch.zeros_like(fs_vals))
    return init_level.contiguous(), init_season.contiguous()


def _hw_forecast(values, mask, m_len, params, init=None, last_valid=None) -> Forecast:
    """Holt-Winters with per-series params [B, 3] through the
    `holt_winters_scan` kernel, predictions written. `init` (`_hw_init`'s
    level and season) and `last_valid` are computed here unless given.
    The horizon continues right after each series' LAST VALID point:
    phase (last_valid + 1) mod m, not the bucket-padded length."""
    init_level, init_season = _hw_init(values, mask, m_len) if init is None else init
    lv = _last_valid(mask) if last_valid is None else last_valid
    level, trend, season, _, pred = kernels.holt_winters_scan(
        values, mask, init_level, init_season, params, per_series=True, want_pred=True,
        last_valid=lv,
    )
    phase_next = ((lv + 1) % m_len).to(torch.int32)
    return _finalize(
        pred, values, mask, level=level[0], trend=trend[0],
        season=season[0].contiguous(), season_phase=phase_next,
    )


def holt_winters(
    values: torch.Tensor,
    mask: torch.Tensor,
    season_length: int = 24,
    alpha: float = 0.3,
    beta: float = 0.05,
    gamma: float = 0.1,
) -> Forecast:
    """Additive Holt-Winters, batched; one recurrence for every season
    length. Season indexing is the absolute step index mod m (gaps keep
    their phase). `alpha`/`beta`/`gamma` may be scalars or per-series [B]."""
    m_len = int(season_length)
    values = values.float().contiguous()
    mask = mask.contiguous()
    b = values.shape[0]
    dev = values.device
    params = torch.stack(
        [kernels._row(p, b, torch.float32, dev) for p in (alpha, beta, gamma)], dim=1
    ).contiguous()
    return _hw_forecast(values, mask, m_len, params)


def _guard_unidentifiable(fc: Forecast, values, mask, m_len: int) -> Forecast:
    """Per-series 2-cycle identifiability select: series with fewer than
    two cycles of REAL points keep the global-mean model (bucket padding
    can carry a short history past the static length guards)."""
    enough = mask.sum(dim=-1) >= 2 * m_len
    ma = moving_average_all(values, mask)
    ma = dataclasses.replace(
        ma, season=torch.zeros_like(fc.season), season_phase=fc.season_phase
    )
    return _select(enough, fc, ma)


_HW_GRID = (
    (0.1, 0.01, 0.05),
    (0.1, 0.05, 0.1),
    (0.3, 0.05, 0.1),
    (0.3, 0.1, 0.2),
    (0.5, 0.1, 0.1),
    (0.5, 0.05, 0.3),
    (0.7, 0.1, 0.1),
    (0.8, 0.2, 0.2),
)


def hw_grid_sse(
    values: torch.Tensor, mask: torch.Tensor, season_length: int, init=None, last_valid=None
) -> torch.Tensor:
    """Masked in-sample SSE of Holt-Winters at every `_HW_GRID` point,
    [G, B] f64: one `holt_winters_scan` launch over the whole grid, no
    predictions written. `init` and `last_valid` as for `_hw_forecast`."""
    m_len = int(season_length)
    values = values.float().contiguous()
    mask = mask.contiguous()
    grid = torch.tensor(_HW_GRID, dtype=torch.float32, device=values.device)
    init_level, init_season = _hw_init(values, mask, m_len) if init is None else init
    return kernels.holt_winters_scan(
        values, mask, init_level, init_season, grid, last_valid=last_valid
    )[3]


def fit_holt_winters(values: torch.Tensor, mask: torch.Tensor, season_length: int = 24) -> Forecast:
    """Per-series fitted Holt-Winters: each series picks its SSE-minimizing
    (alpha, beta, gamma) of `_HW_GRID` (the first minimum, as
    `jnp.argmin`). The grid's SSEs come from one kernel launch; a second
    launch with the chosen per-series triples writes the predictions and
    terminal state, the same numbers the grid run reached for that triple.

    Histories shorter than two full seasons are unidentifiable and keep
    the global-mean model: a static early-out on the batch length, plus a
    per-series select (`_guard_unidentifiable`)."""
    m_len = int(season_length)
    if values.shape[1] < 2 * m_len:
        return moving_average_all(values, mask)
    values = values.float().contiguous()
    mask = mask.contiguous()
    grid = torch.tensor(_HW_GRID, dtype=torch.float32, device=values.device)
    init = _hw_init(values, mask, m_len)  # one pass over the history for both launches
    lv = _last_valid(mask)
    best = torch.argmin(hw_grid_sse(values, mask, m_len, init, lv), dim=0)  # [B]
    fc = _hw_forecast(values, mask, m_len, grid[best].contiguous(), init, lv)
    return _guard_unidentifiable(fc, values, mask, m_len)


# auto_univariate: a series must beat the global-mean model's in-sample
# SSE by at least this factor for a structured fit to be selected.
AUTO_SSE_RATIO = 0.5


def _z_threshold(m_len: int) -> float:
    """Bonferroni-corrected normal quantile of the auto screen's phase
    gate: Phi^-1(1 - 1e-3 / m), in float64 on the host."""
    return float(torch.special.ndtri(torch.tensor(1.0 - 1e-3 / m_len, dtype=torch.float64)))


def fit_auto_univariate(values: torch.Tensor, mask: torch.Tensor, season_length: int = 24) -> Forecast:
    """Structure-screened model selection, per series: the global mean,
    an adaptive structured fit (fitted Holt-Winters for m <= 64, pooled
    phase means for longer seasons) and the changepoint-trend + Fourier
    seasonal model. A structured model wins only where its warm-region
    (absolute index >= m) SSE is below AUTO_SSE_RATIO of the mean model's;
    between the two the lower SSE wins. Long seasons add a
    Bonferroni-corrected z-gate on the pooled phase means that routes
    sparse cycle features to the phase-means fit. Histories under two
    cycles keep the mean model."""
    m_len = int(season_length)
    t_len = values.shape[1]
    ma = moving_average_all(values, mask)
    if t_len < 2 * m_len:
        return ma
    # at call time: models.seasonal imports this module at top level
    from foremast_tpu_torch.models.seasonal import fit_seasonal

    if m_len <= _HW_UNROLL_MAX:
        hw = fit_holt_winters(values, mask, m_len)
    else:
        hw = fit_phase_means(values, mask, m_len)
    se = fit_seasonal(values, mask, period=m_len)
    warm = (mask & (torch.arange(t_len, device=values.device)[None, :] >= m_len)).to(values.dtype)

    def sse(fc):
        r = (values - fc.pred) * warm
        return (r * r).sum(dim=-1)

    sse_ma, sse_hw, sse_se = sse(ma), sse(hw), sse(se)
    use_struct = torch.minimum(sse_hw, sse_se) < AUTO_SSE_RATIO * sse_ma
    prefer_se = sse_se <= sse_hw
    if m_len > _HW_UNROLL_MAX:
        # sparse cycle features move the SSE ratio by <1% yet make a
        # phase-blind band false-flag every occurrence: a pooled phase
        # mean whose |mean| * sqrt(k) / sigma clears the corrected
        # quantile is real structure, routed to the phase-means fit
        z_thr = _z_threshold(m_len)
        kcnt = _phase_counts(mask, m_len, values.dtype)
        z = hw.season.abs() * torch.sqrt(kcnt.clamp_min(1.0)) / hw.scale[:, None].clamp_min(1e-30)
        z_gate = z.amax(dim=-1) > z_thr
        use_struct = use_struct | z_gate
        prefer_se = prefer_se & ~z_gate
    # the mean model's season is [B, 1] zeros: widen it to [B, m] so the
    # three forecasts share one shape (se/hw phases agree)
    ma = dataclasses.replace(ma, season=torch.zeros_like(hw.season), season_phase=hw.season_phase)
    structured = _select(prefer_se, se, hw)
    return _select(use_struct, structured, ma)


def _phase_counts(mask: torch.Tensor, m_len: int, dtype) -> torch.Tensor:
    """Valid observations per phase, [B, m]."""
    b, t_len = mask.shape
    n_seasons = -(-t_len // m_len)
    pad = n_seasons * m_len - t_len
    mm = torch.nn.functional.pad(mask.to(dtype), (0, pad))
    return mm.view(b, n_seasons, m_len).sum(dim=1)


def fit_phase_means(values: torch.Tensor, mask: torch.Tensor, season_length: int = 1440) -> Forecast:
    """Pooled per-phase means + linear trend — the long-season fit.

    Backfits a masked linear trend and the pooled phase means (three
    alternations, each a parallel reduction over a [B, seasons, m] view);
    the scale uses leave-one-out residuals r * k/(k-1), excluding phases
    observed once, with the plain residual std where no phase repeats.
    Under two cycles (batch length or per-series count) the series keeps
    the global-mean model."""
    m_len = int(season_length)
    b, t_len = values.shape
    dtype = values.dtype
    dev = values.device
    if t_len < 2 * m_len:
        return moving_average_all(values, mask)
    tn = (torch.arange(t_len, dtype=dtype, device=dev) / t_len)[None, :]
    mm = mask.to(dtype)
    n = mm.sum(dim=-1).clamp_min(1.0)
    st = (tn * mm).sum(dim=-1)
    stt = (tn * tn * mm).sum(dim=-1)
    denom = stt - st * st / n
    n_seasons = -(-t_len // m_len)
    pad = n_seasons * m_len - t_len
    k = _phase_counts(mask, m_len, dtype)
    phase_idx = torch.arange(t_len, device=dev) % m_len
    season = torch.zeros((b, m_len), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(3):
        y = values - season[:, phase_idx]
        sx = (y * mm).sum(dim=-1)
        stx = (tn * y * mm).sum(dim=-1)
        slope_n = torch.where(denom > 1e-12, (stx - st * sx / n) / denom.clamp_min(1e-12), zero)
        intercept = sx / n - slope_n * st / n
        detrended = values - (intercept[:, None] + slope_n[:, None] * tn)
        dv = torch.nn.functional.pad(detrended * mm, (0, pad)).view(b, n_seasons, m_len)
        season = torch.where(k > 0, dv.sum(dim=1) / k.clamp_min(1.0), zero)

    pred = intercept[:, None] + slope_n[:, None] * tn + season[:, phase_idx]
    k_at = k[:, phase_idx]
    loo = k_at / (k_at - 1.0).clamp_min(1.0)
    resid = (values - pred) * loo
    scale_mask = mask & (k_at > 1.5)
    scale = torch.where(
        scale_mask.sum(dim=-1) > 0,
        masked_std(resid, scale_mask, ddof=0),
        masked_std(values - pred, mask, ddof=0),
    )
    last_valid = _last_valid(mask)
    lv = last_valid.to(dtype)
    fc = Forecast(
        pred=pred,
        scale=scale,
        level=intercept + slope_n * lv / t_len,
        trend=slope_n / t_len,
        season=season,
        season_phase=((last_valid + 1) % m_len).to(torch.int32),
    )
    return _guard_unidentifiable(fc, values, mask, m_len)
