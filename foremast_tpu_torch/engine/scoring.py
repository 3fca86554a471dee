"""The batched health-judgment engine on torch tensors.

Reference semantics (`foremast-brain/README.md:5-11`): fit the historical
model from the 7-day window; for canaries, run pairwise same-distribution
tests between baseline and current and, if the distributions differ,
lower the threshold; flag current points outside the model's band; any
anomaly makes the window unhealthy.

The whole (service x metric) population is one `[B, T]` batch and every
step is a masked tensor op. For the deployed default `moving_average_all`
the fit, band, flags, gate and verdict run as ONE kernel
(`ops/kernels.py`): `ma_judgment` from f32 history in `score`,
`ma_judgment_bf16_delta` from the bf16-delta layout in
`score_bf16_delta`, and the fit alone through `masked_stats` in
`fit_forecast`. Every other algorithm of the `AI_MODEL` registry (and the
seasonal models that `models/` registers) goes through its fit, the
hist->cur gap advance, `horizon` and the shared judgment tail; the
Holt-Winters and Holt recurrences inside those fits are kernels too. The
rank tests run as plain torch.

The fit-cache path judges from fitted terminal state instead:
`score_from_state`, and `score_from_arena`, which gathers that state from
the judge's device arena first. Its cold fits come from
`fit_ma_from_bf16_delta` / `fit_forecast_bf16_delta` (the
FOREMAST_BF16_DELTA gate, default on) or `fit_forecast`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from foremast_tpu_torch.config import (
    PAIRWISE_ALL,
    PAIRWISE_ANY,
    PAIRWISE_FRIEDMAN,
    PAIRWISE_KRUSKAL,
    PAIRWISE_MANN_WHITE,
    PAIRWISE_WILCOXON,
)
from foremast_tpu_torch.ops import kernels
from foremast_tpu_torch.ops.anomaly import compute_bounds, detect_anomalies
from foremast_tpu_torch.ops.forecasters import (
    Forecast,
    double_exponential,
    ewma,
    fit_auto_univariate,
    fit_holt_winters,
    fit_phase_means,
    horizon,
    moving_average,
    moving_average_all,
)
from foremast_tpu_torch.ops.ranks import (
    friedman_chi_square,
    kruskal_wallis,
    mann_whitney_u,
    wilcoxon_signed_rank,
)
from foremast_tpu_torch.ops.windows import MetricWindows

# Verdict codes (the ES status machine: completed_health /
# completed_unhealth / completed_unknown).
HEALTHY = 0
UNHEALTHY = 1
UNKNOWN = 2

# Engine-internal selector (not a config choice): judge WITHOUT the
# pairwise rank tests. Only valid when the caller knows the baseline is
# absent — an empty baseline gates every test off anyway.
PAIRWISE_NONE = "NONE"

# Threshold multiplier when baseline and current distributions differ
# ("lower the threshold", design.md:33).
DIFF_THRESHOLD_FACTOR = 0.5

# Trend extrapolation across a hist->cur gap is capped at one day of 60 s
# steps, so a stale fit cannot run a trend off to infinity.
GAP_TREND_CAP_STEPS = 1440

# The model registry (the reference brain's AI_MODEL table); deployed
# default `moving_average_all`. Each entry: (values, mask) -> Forecast.
AI_MODEL = {
    "moving_average_all": moving_average_all,
    "moving_average": moving_average,
    "ewma": ewma,
    "exponential_smoothing": ewma,
    "double_exponential_smoothing": double_exponential,
    "holtwinters": fit_holt_winters,
    "holt_winters": fit_holt_winters,
    "phase_means": fit_phase_means,
    "auto_univariate": fit_auto_univariate,
}


def register_model(name: str, fit_fn) -> None:
    """Extend the registry (`models/` registers the seasonal models)."""
    AI_MODEL[name] = fit_fn


# Registry entries that take a season/period dimension, with the keyword
# each expects: the configured ML_SEASON_STEPS is threaded through all.
_SEASON_KWARG = {
    "holtwinters": "season_length",
    "holt_winters": "season_length",
    "phase_means": "season_length",
    "auto_univariate": "season_length",
    "seasonal": "period",
    "prophet": "period",
}


def _fit_model(algorithm: str, values, mask, season_length: int) -> Forecast:
    fit = AI_MODEL.get(algorithm)
    if fit is None:
        # models/ registers the seasonal models on import; resolve lazily
        # so the registry works without callers importing it
        import foremast_tpu_torch.models  # noqa: F401

        fit = AI_MODEL[algorithm]
    kw = _SEASON_KWARG.get(algorithm)
    return fit(values, mask, **({kw: season_length} if kw else {}))


@dataclasses.dataclass(frozen=True)
class ScoreBatch:
    """One fixed-shape batch of scoring work.

    historical: [B, Th] 7-day model window
    current:    [B, Tc] the window under judgment
    baseline:   [B, Tc] pre-deploy window (mask all-False when absent)
    threshold/bound/min_lower_bound: [B] per-window config vectors
    min_points: [B] minimum historical points to measure at all
    """

    historical: MetricWindows
    current: MetricWindows
    baseline: MetricWindows
    threshold: torch.Tensor
    bound: torch.Tensor
    min_lower_bound: torch.Tensor
    min_points: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """Batched judgment output.

    verdict:  [B] int32 (0 healthy / 1 unhealthy / 2 unknown)
    anomalies:[B, Tc] bool — which current points breached bounds
    upper/lower: [B, Tc] the model band over the current window
    p_value:  [B] combined pairwise p (1.0 when no baseline)
    dist_differs: [B] bool — pairwise tests rejected same-distribution
    """

    verdict: torch.Tensor
    anomalies: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor
    p_value: torch.Tensor
    dist_differs: torch.Tensor


def pairwise_decision(
    current: MetricWindows,
    baseline: MetricWindows,
    algorithm: str,
    p_threshold: float,
    min_mw: int,
    min_wilcoxon: int,
    min_kruskal: int,
    min_friedman: int = 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combined same-distribution decision, [B] (p_combined, differs).

    ALL = every applicable test must reject; ANY = one rejection
    suffices. Tests whose min-points gate fails are inconclusive (p=1,
    not counted). PAIRWISE_NONE skips the tests: (p=1, differs=False)."""
    x, xm = current.values, current.mask
    if algorithm == PAIRWISE_NONE:
        b = x.shape[0]
        return (
            torch.ones(b, dtype=x.dtype, device=x.device),
            torch.zeros(b, dtype=torch.bool, device=x.device),
        )
    y, ym = baseline.values, baseline.mask
    _, p_mw, ok_mw = mann_whitney_u(x, xm, y, ym, min_points=min_mw)
    _, p_wx, ok_wx = wilcoxon_signed_rank(x, xm, y, ym, min_points=min_wilcoxon)
    _, p_kw, ok_kw = kruskal_wallis(x, xm, y, ym, min_points=min_kruskal)
    _, p_fr, ok_fr = friedman_chi_square(x, xm, y, ym, min_points=min_friedman)

    rej_mw = ok_mw & (p_mw < p_threshold)
    rej_wx = ok_wx & (p_wx < p_threshold)
    rej_kw = ok_kw & (p_kw < p_threshold)
    rej_fr = ok_fr & (p_fr < p_threshold)

    if algorithm == PAIRWISE_MANN_WHITE:
        differs, p = rej_mw, p_mw
    elif algorithm == PAIRWISE_WILCOXON:
        differs, p = rej_wx, p_wx
    elif algorithm == PAIRWISE_KRUSKAL:
        differs, p = rej_kw, p_kw
    elif algorithm == PAIRWISE_FRIEDMAN:
        differs, p = rej_fr, p_fr
    elif algorithm == PAIRWISE_ANY:
        differs = rej_mw | rej_wx | rej_kw | rej_fr
        p = torch.minimum(torch.minimum(p_mw, p_wx), torch.minimum(p_kw, p_fr))
    elif algorithm == PAIRWISE_ALL:
        any_ok = ok_mw | ok_wx | ok_kw | ok_fr
        all_rej = (
            (rej_mw | ~ok_mw) & (rej_wx | ~ok_wx) & (rej_kw | ~ok_kw) & (rej_fr | ~ok_fr)
        )
        differs = any_ok & all_rej
        # max over applicable tests only: a gated-out test's p is 1.0
        zero = torch.zeros_like(p_mw)
        p = torch.maximum(
            torch.maximum(torch.where(ok_mw, p_mw, zero), torch.where(ok_wx, p_wx, zero)),
            torch.maximum(torch.where(ok_kw, p_kw, zero), torch.where(ok_fr, p_fr, zero)),
        )
        p = torch.where(any_ok, p, torch.ones_like(p))
    else:
        raise ValueError(f"unknown pairwise algorithm {algorithm!r}")
    return p, differs


def tile_season(s: np.ndarray, m: int) -> np.ndarray:
    """Tile a host-side season buffer's last axis from length l to m.

    Exact whenever l | m: tiled[i] = s[i mod l] commutes with every
    (phase + k) mod m lookup downstream, so [..., 1] zero buffers of
    non-seasonal fits stack next to full-season ones in one batch."""
    ell = s.shape[-1]
    if ell == m:
        return s
    if m % ell:
        raise ValueError(f"incompatible season lengths {ell} vs {m}")
    return np.tile(s, (1,) * (s.ndim - 1) + (m // ell,))


def _effective_threshold(batch: ScoreBatch, differs: torch.Tensor) -> torch.Tensor:
    thr = batch.threshold.to(torch.float32)
    return torch.where(differs, thr * DIFF_THRESHOLD_FACTOR, thr)


def _judgment_tail(
    batch: ScoreBatch,
    pred: torch.Tensor,
    scale: torch.Tensor,
    n_hist: torch.Tensor,
    pairwise_algorithm: str,
    p_threshold: float,
    min_mw: int,
    min_wilcoxon: int,
    min_kruskal: int,
    min_friedman: int = 20,
) -> ScoreResult:
    """Everything after the model fit: pairwise -> threshold lowering ->
    bounds -> flags -> measurability gate -> verdict."""
    cur = batch.current
    p, differs = pairwise_decision(
        cur, batch.baseline, pairwise_algorithm, p_threshold,
        min_mw, min_wilcoxon, min_kruskal, min_friedman,
    )
    upper, lower = compute_bounds(
        pred, scale, _effective_threshold(batch, differs), batch.min_lower_bound
    )
    anomalies = detect_anomalies(cur.values, cur.mask, upper, lower, batch.bound)
    measurable = (n_hist >= batch.min_points) & (cur.count() > 0)
    any_anom = anomalies.any(dim=-1)
    verdict = torch.where(
        measurable, torch.where(any_anom, UNHEALTHY, HEALTHY), UNKNOWN
    ).to(torch.int32)
    return ScoreResult(
        verdict=verdict,
        anomalies=anomalies & measurable[:, None],
        upper=upper,
        lower=lower,
        p_value=p,
        dist_differs=differs,
    )


def _kernel_result(p, differs, judged) -> ScoreResult:
    verdict, anomalies, upper, lower = judged
    return ScoreResult(
        verdict=verdict,
        anomalies=anomalies,
        upper=upper,
        lower=lower,
        p_value=p,
        dist_differs=differs,
    )


def score(
    batch: ScoreBatch,
    gap_steps: torch.Tensor | None = None,
    algorithm: str = "moving_average_all",
    season_length: int = 24,
    pairwise_algorithm: str = PAIRWISE_ALL,
    p_threshold: float = 0.05,
    min_mw: int = 20,
    min_wilcoxon: int = 20,
    min_kruskal: int = 5,
    min_friedman: int = 20,
) -> ScoreResult:
    """Judge a whole batch. `moving_average_all`: pairwise -> threshold
    lowering -> the fused `ma_judgment` kernel (its plain version for CPU
    tensors); its forecast is the global mean, trendless and seasonless,
    so `gap_steps` and `season_length` do not change it. Every other
    algorithm: fit -> gap advance -> `horizon` -> the judgment tail."""
    if algorithm != "moving_average_all":
        hist = batch.historical
        fc = _fit_model(algorithm, hist.values, hist.mask, season_length)
        fc = _advance_gap(fc, gap_steps)
        return _judgment_tail(
            batch, horizon(fc, batch.current.length), fc.scale, hist.count(),
            pairwise_algorithm, p_threshold, min_mw, min_wilcoxon, min_kruskal, min_friedman,
        )
    cur = batch.current
    p, differs = pairwise_decision(
        cur, batch.baseline, pairwise_algorithm, p_threshold,
        min_mw, min_wilcoxon, min_kruskal, min_friedman,
    )
    return _kernel_result(
        p,
        differs,
        kernels.ma_judgment(
            batch.historical.values,
            batch.historical.mask,
            cur.values,
            cur.mask,
            _effective_threshold(batch, differs),
            batch.bound,
            batch.min_lower_bound,
            batch.min_points,
        ),
    )


def fit_forecast(
    values: torch.Tensor,
    mask: torch.Tensor,
    algorithm: str = "moving_average_all",
    season_length: int = 24,
) -> Forecast:
    """Fit the historical model alone (no judgment): the fit half of the
    fit-cache path, replayed later through `score_from_state`."""
    return _fit_model(algorithm, values, mask, season_length)


def bf16_delta_values(
    anchor: torch.Tensor, delta: torch.Tensor, lens: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, mask) [B, T] of a bf16-delta upload: f32(anchor + delta)
    over each row's valid prefix (`lens`, left-packed rows), exact zeros
    elsewhere. The reconstruction is a select, not a product with the
    mask, so a masked slot of a negative anchor is +0.0 as in the JAX
    program."""
    t = delta.shape[1]
    mask = torch.arange(t, dtype=torch.int32, device=delta.device)[None, :] < lens[:, None]
    full = anchor[:, None] + delta.to(torch.float32)
    return torch.where(mask, full, torch.zeros_like(full)), mask


def fit_forecast_bf16_delta(
    anchor: torch.Tensor,
    delta: torch.Tensor,
    lens: torch.Tensor,
    algorithm: str = "moving_average_all",
    season_length: int = 24,
) -> Forecast:
    """`fit_forecast` from a bf16-delta upload (any algorithm), values
    rebuilt on the device by `bf16_delta_values`."""
    values, mask = bf16_delta_values(anchor, delta, lens)
    return _fit_model(algorithm, values, mask, season_length)


def _advance_gap(fc: Forecast, gap_steps: torch.Tensor | None) -> Forecast:
    """Advance terminal state across the hist->cur gap: the seasonal
    phase by the true gap mod m, the trend by at most
    GAP_TREND_CAP_STEPS. A no-op for trendless, seasonless models."""
    if gap_steps is None:
        return fc
    m = fc.season.shape[-1]
    gap = gap_steps.to(torch.int32)
    return dataclasses.replace(
        fc,
        season_phase=((fc.season_phase + gap) % m).to(torch.int32),
        level=fc.level + fc.trend * gap.clamp_max(GAP_TREND_CAP_STEPS).to(fc.level.dtype),
    )


def score_from_state(
    batch: ScoreBatch,
    level: torch.Tensor,
    trend: torch.Tensor,
    season: torch.Tensor,
    season_phase: torch.Tensor,
    scale: torch.Tensor,
    n_hist: torch.Tensor,
    gap_steps: torch.Tensor | None = None,
    pairwise_algorithm: str = PAIRWISE_ALL,
    p_threshold: float = 0.05,
    min_mw: int = 20,
    min_wilcoxon: int = 20,
    min_kruskal: int = 5,
    min_friedman: int = 20,
) -> ScoreResult:
    """Judgment from fitted terminal state (no history scan): `horizon`
    extrapolation, the residual `scale` and the history count feed
    `_judgment_tail`, so a cached fit reproduces a fresh one."""
    fc = Forecast(
        pred=torch.zeros((level.shape[0], 0), dtype=level.dtype, device=level.device),
        scale=scale,
        level=level,
        trend=trend,
        season=season,
        season_phase=season_phase,
    )
    fc = _advance_gap(fc, gap_steps)
    pred = horizon(fc, batch.current.length)
    return _judgment_tail(
        batch, pred, scale, n_hist, pairwise_algorithm, p_threshold,
        min_mw, min_wilcoxon, min_kruskal, min_friedman,
    )


def score_from_arena(
    batch: ScoreBatch,
    level: torch.Tensor,
    trend: torch.Tensor,
    season: torch.Tensor,
    season_phase: torch.Tensor,
    scale: torch.Tensor,
    n_hist: torch.Tensor,
    rows: torch.Tensor,
    gap_steps: torch.Tensor | None = None,
    pairwise_algorithm: str = PAIRWISE_ALL,
    p_threshold: float = 0.05,
    min_mw: int = 20,
    min_wilcoxon: int = 20,
    min_kruskal: int = 5,
    min_friedman: int = 20,
) -> ScoreResult:
    """Judgment from ARENA-resident terminal state (`engine.arena`).

    `rows` [B] int64 indexes the arena's [capacity] state tensors and
    [capacity, m] season buffer on the device, so a warm tick ships
    only current windows and the row indices. Exactly
    `score_from_state` of the gathered rows."""
    def take(a):
        return a.index_select(0, rows)

    return score_from_state(
        batch,
        take(level),
        take(trend),
        take(season),
        take(season_phase),
        take(scale),
        take(n_hist),
        gap_steps=gap_steps,
        pairwise_algorithm=pairwise_algorithm,
        p_threshold=p_threshold,
        min_mw=min_mw,
        min_wilcoxon=min_wilcoxon,
        min_kruskal=min_kruskal,
        min_friedman=min_friedman,
    )


# -- anchor-shifted bf16-delta history storage --------------------------------
#
# Each window is stored as (f32 anchor, bf16 deltas from the anchor): the
# deviations keep ~3 significant digits relative to the window's own
# range, and the moving-average moments never reconstruct values —
# E[v] = anchor + E[d], Var[v] = Var[d] — so a history read costs 2 B/point
# instead of 5 (f32 value + bool mask).

# Explicit override beats the env (FOREMAST_BF16_DELTA).
_BF16_DELTA_OVERRIDE: bool | None = None


def set_bf16_delta(enabled: bool | None) -> None:
    """Pin the bf16-delta gate for this process (None clears the
    override back to the env default)."""
    global _BF16_DELTA_OVERRIDE
    _BF16_DELTA_OVERRIDE = enabled if enabled is None else bool(enabled)


def bf16_delta_enabled() -> bool:
    """FOREMAST_BF16_DELTA gate (default on): the judge's cold fits ship
    histories as anchor + bf16 deltas (`judge._fit_miss_rows`). Set
    FOREMAST_BF16_DELTA=0 for f32 values and masks."""
    if _BF16_DELTA_OVERRIDE is not None:
        return _BF16_DELTA_OVERRIDE
    return os.environ.get("FOREMAST_BF16_DELTA", "1") == "1"


def fit_ma_from_bf16_delta(
    anchor: torch.Tensor, delta: torch.Tensor, lens: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """moving_average_all terminal state (mean [B], std [B], lens [B])
    from a bf16-delta history; f32 accumulation."""
    n = lens.to(torch.float32)
    d32 = delta.to(torch.float32)
    s1 = d32.sum(dim=1)
    s2 = (d32 * d32).sum(dim=1)
    nn = n.clamp_min(1.0)
    mean_d = s1 / nn
    zero = torch.zeros_like(n)
    mean = torch.where(n > 0, anchor + mean_d, zero)
    var = torch.where(n > 0, (s2 / nn - mean_d * mean_d).clamp_min(0.0), zero)
    return mean, torch.sqrt(var), lens


def pack_hist_bf16_delta(
    values: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T] f32 history -> (anchor [B] f32, delta [B, T] bf16).

    anchor = first valid value per row (a member of the sample, so deltas
    are bounded by the window range); invalid slots pack as exact 0."""
    first_idx = mask.to(torch.uint8).argmax(dim=-1)
    c = torch.gather(values, -1, first_idx[:, None])[:, 0]
    c = torch.where(mask.any(dim=-1), c, torch.zeros_like(c))
    d = torch.where(mask, values - c[:, None], torch.zeros_like(values))
    return c, d.to(torch.bfloat16)


def make_bf16_delta_batch(
    batch: ScoreBatch,
) -> tuple[ScoreBatch, torch.Tensor, torch.Tensor]:
    """(slim_batch, anchor, delta) for `score_bf16_delta`: the slim batch
    carries a [B, 0] values tensor (no f32 history stays on the device)
    but keeps the full [B, T] mask, which gives the valid counts."""
    anchor, delta = pack_hist_bf16_delta(batch.historical.values, batch.historical.mask)
    b = batch.historical.values.shape[0]
    slim = dataclasses.replace(
        batch,
        historical=MetricWindows(
            values=torch.zeros((b, 0), dtype=torch.float32, device=anchor.device),
            mask=batch.historical.mask,
            times=None,
        ),
    )
    return slim, anchor, delta


def score_bf16_delta(
    batch: ScoreBatch,
    anchor: torch.Tensor,
    delta: torch.Tensor,
    pairwise_algorithm: str = PAIRWISE_ALL,
    p_threshold: float = 0.05,
    min_mw: int = 20,
    min_wilcoxon: int = 20,
    min_kruskal: int = 5,
    min_friedman: int = 20,
) -> ScoreResult:
    """moving_average_all judgment from bf16-delta history storage:
    pairwise -> threshold lowering -> the fused `ma_judgment_bf16_delta`
    kernel. `batch.historical` carries only the mask (values may be
    [B, 0]); its row sums are the valid counts."""
    cur = batch.current
    p, differs = pairwise_decision(
        cur, batch.baseline, pairwise_algorithm, p_threshold,
        min_mw, min_wilcoxon, min_kruskal, min_friedman,
    )
    lens = batch.historical.mask.sum(dim=-1, dtype=torch.int32)
    return _kernel_result(
        p,
        differs,
        kernels.ma_judgment_bf16_delta(
            anchor,
            delta,
            lens,
            cur.values,
            cur.mask,
            _effective_threshold(batch, differs),
            batch.bound,
            batch.min_lower_bound,
            batch.min_points,
        ),
    )
