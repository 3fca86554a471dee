"""Hand-written CUDA kernels of the scoring hot path, and their plain
PyTorch versions.

The deployed default `moving_average_all` judgment reads the [B, Th]
7-day history once for masked moments, then does a tiny [B, Tc] band
comparison. Each of its kernels fuses that whole pass into one launch,
one thread block per row (sources in `csrc/`, built by `_build.py`):

  * `masked_stats`           — count/mean/std (ddof 0) of a masked [B, T]
                               batch, two-pass on the row.
  * `ma_judgment`            — stats -> band (threshold * sigma, lower
                               floored at min_lower_bound) -> bound-selector
                               flags -> measurability gate -> verdict.
  * `ma_judgment_bf16_delta` — the same judgment from the anchor-shifted
                               bf16-delta history layout, one pass.

The trended and seasonal forecasters are sequential recurrences over
time, one chain per series (the JAX package runs them as `lax.scan`):

  * `holt_winters_scan`      — additive Holt-Winters for G parameter
                               triples (the fit's grid) or one triple per
                               series, any season length m.
  * `holt_scan`              — Holt's level + trend recurrence.

Both run a chain only to the last valid step of the rows a block owns
(`last_valid`, computed on the device; masked steps change nothing) and
fill the rest of `pred` from the frozen state. The history reaches the
chain as tiles in shared memory, staged by a loader warp, and `pred`
leaves through a storer warp (`csrc/scan_tiles.cuh`). They round every
operation as their plain versions do and equal them bit for bit.

A wrapper given CPU tensors runs the plain version beside it; given CUDA
tensors it launches the kernel on the current stream or raises. Each
launch adds one to `LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from foremast_tpu_torch.ops import _build

# Verdict codes — must match engine/scoring.py (HEALTHY/UNHEALTHY/UNKNOWN).
_HEALTHY, _UNHEALTHY, _UNKNOWN = 0, 1, 2

# The scan entry point's limits: at most 256 parameter sets a launch
# (`kMaxG` of `csrc/scan_tiles.cuh`) and a season of fewer than 2^31
# entries (32-bit offsets). `holt_winters_scan` splits a larger call into
# launches within them.
_MAX_G = 256
_SEASON_ENTRIES = 1 << 31

LAUNCHES = {
    "masked_stats": 0,
    "ma_judgment": 0,
    "ma_judgment_bf16_delta": 0,
    "holt_winters_scan": 0,
    "holt_scan": 0,
}


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands span several CUDA devices")
        return True
    raise ValueError(f"kernel operands must all be on cpu or all on cuda, got {kinds}")


def _row(x, b: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Scalar or [B] per-row operand -> contiguous [B] tensor. A Python or
    numpy number is filled on the device: no blocking host-to-device copy."""
    if isinstance(x, numbers.Number):
        return torch.full((b,), x, dtype=dtype, device=device)
    x = torch.as_tensor(x, device=device).to(dtype)
    if x.ndim == 0:
        return x.expand(b).contiguous()
    if x.shape != (b,):
        raise ValueError(f"per-row operand has shape {tuple(x.shape)}, want ({b},)")
    return x.contiguous()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, *args) -> None:
    """Call the C entry point `fm_<name>` on the current stream; raise if
    it returns a CUDA error."""
    lib = _build.library(name)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"fm_{name}")(*args, stream)
    if err != 0:
        msg = lib.fm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def _judgment_plain_tail(n, mean, sigma, cur_values, cur_mask, thr, bnd, mlb, mnp):
    """Band, flags, gate and verdict from per-row (n, mean, sigma)."""
    band = thr * sigma
    up = mean + band
    lo = torch.maximum(mean - band, mlb)
    use_up = (bnd == 1) | (bnd == 3)
    use_lo = (bnd == 2) | (bnd == 3)
    cur = cur_values
    flags = cur_mask & (
        ((cur > up[:, None]) & use_up[:, None]) | ((cur < lo[:, None]) & use_lo[:, None])
    )
    ncur = cur_mask.sum(dim=-1)
    measurable = (n >= mnp) & (ncur > 0)
    flags = flags & measurable[:, None]
    any_anom = flags.any(dim=-1)
    verdict = torch.where(
        measurable,
        torch.where(any_anom, _UNHEALTHY, _HEALTHY),
        _UNKNOWN,
    ).to(torch.int32)
    shape = cur.shape
    return (
        verdict,
        flags,
        up[:, None].expand(shape).contiguous(),
        lo[:, None].expand(shape).contiguous(),
    )


# ---------------------------------------------------------------------------
# masked_stats
# ---------------------------------------------------------------------------


def _masked_stats_plain(values: torch.Tensor, mask: torch.Tensor):
    """Two-pass masked (count, mean, std[ddof=0]) — the kernel's algebra."""
    m = mask.to(torch.float32)
    v = torch.where(mask, values, torch.zeros_like(values))
    cnt = m.sum(dim=-1)
    c = cnt.clamp_min(1.0)
    mu = v.sum(dim=-1) / c
    d = (v - mu[:, None]) * m
    return cnt, mu, torch.sqrt((d * d).sum(dim=-1) / c)


def masked_stats(
    values: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked (count, mean, std[ddof=0]) over the time axis.

    values [B, T] float32, mask [B, T] bool -> three [B] float32 tensors."""
    if not _on_cuda(values, mask):
        return _masked_stats_plain(values.float(), mask)
    b, t = values.shape
    _check(values, "values", torch.float32, (b, t))
    _check(mask, "mask", torch.bool, (b, t))
    cnt, mean, std = (torch.empty(b, dtype=torch.float32, device=values.device) for _ in range(3))
    _launch(
        "masked_stats",
        values.data_ptr(), mask.data_ptr(),
        cnt.data_ptr(), mean.data_ptr(), std.data_ptr(),
        b, t,
    )
    return cnt, mean, std


# ---------------------------------------------------------------------------
# ma_judgment — the fused default-algorithm judgment from f32 history
# ---------------------------------------------------------------------------


def _ma_judgment_plain(
    hist_values, hist_mask, cur_values, cur_mask, threshold, bound,
    min_lower_bound, min_points,
):
    b = cur_values.shape[0]
    dev = cur_values.device
    cnt, mu, sigma = _masked_stats_plain(hist_values.float(), hist_mask)
    return _judgment_plain_tail(
        cnt, mu, sigma, cur_values.float(), cur_mask,
        _row(threshold, b, torch.float32, dev),
        _row(bound, b, torch.int32, dev),
        _row(min_lower_bound, b, torch.float32, dev),
        _row(min_points, b, torch.float32, dev),
    )


def ma_judgment(
    hist_values: torch.Tensor,
    hist_mask: torch.Tensor,
    cur_values: torch.Tensor,
    cur_mask: torch.Tensor,
    threshold,
    bound,
    min_lower_bound,
    min_points,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused moving_average_all judgment.

    hist [B, Th] f32 + bool mask, cur [B, Tc] f32 + bool mask;
    threshold/bound/min_lower_bound/min_points scalar or [B]. Returns
    (verdict [B] int32, anomalies [B, Tc] bool, upper [B, Tc],
    lower [B, Tc])."""
    if not _on_cuda(hist_values, hist_mask, cur_values, cur_mask):
        return _ma_judgment_plain(
            hist_values, hist_mask, cur_values, cur_mask, threshold, bound,
            min_lower_bound, min_points,
        )
    b, th = hist_values.shape
    tc = cur_values.shape[1]
    dev = cur_values.device
    _check(hist_values, "hist_values", torch.float32, (b, th))
    _check(hist_mask, "hist_mask", torch.bool, (b, th))
    _check(cur_values, "cur_values", torch.float32, (b, tc))
    _check(cur_mask, "cur_mask", torch.bool, (b, tc))
    thr = _row(threshold, b, torch.float32, dev)
    bnd = _row(bound, b, torch.int32, dev)
    mlb = _row(min_lower_bound, b, torch.float32, dev)
    mnp = _row(min_points, b, torch.float32, dev)
    verdict = torch.empty(b, dtype=torch.int32, device=dev)
    anom = torch.empty((b, tc), dtype=torch.bool, device=dev)
    upper = torch.empty((b, tc), dtype=torch.float32, device=dev)
    lower = torch.empty((b, tc), dtype=torch.float32, device=dev)
    _launch(
        "ma_judgment",
        hist_values.data_ptr(), hist_mask.data_ptr(),
        cur_values.data_ptr(), cur_mask.data_ptr(),
        thr.data_ptr(), bnd.data_ptr(), mlb.data_ptr(), mnp.data_ptr(),
        verdict.data_ptr(), anom.data_ptr(), upper.data_ptr(), lower.data_ptr(),
        b, th, tc,
    )
    return verdict, anom, upper, lower


# ---------------------------------------------------------------------------
# ma_judgment_bf16_delta — the same judgment from the bf16-delta layout
# ---------------------------------------------------------------------------


def _ma_judgment_bf16_delta_plain(
    anchor, delta, lens, cur_values, cur_mask, threshold, bound,
    min_lower_bound, min_points,
):
    b = cur_values.shape[0]
    dev = cur_values.device
    d = delta.float()
    n = lens.to(torch.float32)
    c = n.clamp_min(1.0)
    mean_d = d.sum(dim=-1) / c
    s2 = (d * d).sum(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mean = torch.where(n > 0, anchor.float() + mean_d, zero)
    var = torch.where(n > 0, (s2 / c - mean_d * mean_d).clamp_min(0.0), zero)
    return _judgment_plain_tail(
        n, mean, torch.sqrt(var), cur_values.float(), cur_mask,
        _row(threshold, b, torch.float32, dev),
        _row(bound, b, torch.int32, dev),
        _row(min_lower_bound, b, torch.float32, dev),
        _row(min_points, b, torch.float32, dev),
    )


def ma_judgment_bf16_delta(
    anchor: torch.Tensor,
    delta: torch.Tensor,
    lens: torch.Tensor,
    cur_values: torch.Tensor,
    cur_mask: torch.Tensor,
    threshold,
    bound,
    min_lower_bound,
    min_points,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ma_judgment` on the bf16-delta history layout.

    anchor [B] f32, delta [B, Th] bf16 (anchor-shifted, exact zeros in
    invalid slots), lens [B] int32 valid counts: mean = anchor + E[d],
    var = max(E[d^2] - E[d]^2, 0), accumulated in f32 off 2 B/point
    reads. Same outputs as `ma_judgment`."""
    if not _on_cuda(anchor, delta, lens, cur_values, cur_mask):
        return _ma_judgment_bf16_delta_plain(
            anchor, delta, lens, cur_values, cur_mask, threshold, bound,
            min_lower_bound, min_points,
        )
    b, th = delta.shape
    tc = cur_values.shape[1]
    dev = cur_values.device
    _check(anchor, "anchor", torch.float32, (b,))
    _check(delta, "delta", torch.bfloat16, (b, th))
    _check(lens, "lens", torch.int32, (b,))
    _check(cur_values, "cur_values", torch.float32, (b, tc))
    _check(cur_mask, "cur_mask", torch.bool, (b, tc))
    thr = _row(threshold, b, torch.float32, dev)
    bnd = _row(bound, b, torch.int32, dev)
    mlb = _row(min_lower_bound, b, torch.float32, dev)
    mnp = _row(min_points, b, torch.float32, dev)
    verdict = torch.empty(b, dtype=torch.int32, device=dev)
    anom = torch.empty((b, tc), dtype=torch.bool, device=dev)
    upper = torch.empty((b, tc), dtype=torch.float32, device=dev)
    lower = torch.empty((b, tc), dtype=torch.float32, device=dev)
    _launch(
        "ma_judgment_bf16_delta",
        anchor.data_ptr(), delta.data_ptr(), lens.data_ptr(),
        cur_values.data_ptr(), cur_mask.data_ptr(),
        thr.data_ptr(), bnd.data_ptr(), mlb.data_ptr(), mnp.data_ptr(),
        verdict.data_ptr(), anom.data_ptr(), upper.data_ptr(), lower.data_ptr(),
        b, th, tc,
    )
    return verdict, anom, upper, lower


# ---------------------------------------------------------------------------
# holt_winters_scan — additive Holt-Winters, G parameter sets or per series
# ---------------------------------------------------------------------------


def last_valid_index(mask: torch.Tensor) -> torch.Tensor:
    """Last valid absolute index per row, -1 for an empty row, [B] int64,
    computed where the mask lies (no host sync)."""
    b, t_len = mask.shape
    if t_len == 0:
        return torch.full((b,), -1, dtype=torch.int64, device=mask.device)
    # the first valid point of the reversed row, over bytes: no [B, T]
    # index tensor is built; argmax is 0 on an empty row, whose byte there
    # is 0
    rev = mask.flip(-1).view(torch.uint8)
    first = rev.argmax(dim=-1)
    seen = rev.gather(-1, first[:, None])[:, 0] != 0
    return torch.where(seen, (t_len - 1) - first, -1)


def scan_layout() -> dict[str, int]:
    """The scan kernels' layout, read from the built `holt_winters_scan`
    library (needs nvcc and a card): time steps a staged tile (`tile`),
    steps the shared-memory season is read ahead (`ring`, for m above it),
    the longest season kept in shared memory (`smem_m`) and the most
    parameter sets a launch takes (`max_g`)."""
    fn = _build.library("holt_winters_scan").fm_holt_winters_scan_layout
    fn.restype = None
    out = (ctypes.c_longlong * 4)()
    fn(out)
    return dict(zip(("tile", "ring", "smem_m", "max_g"), out))


def _steps(last_valid: torch.Tensor) -> int:
    """Steps a scan must run: the batch's last valid step, plus one."""
    return int(last_valid.max()) + 1 if last_valid.numel() else 0


def _holt_winters_scan_plain(
    values, mask, init_level, init_season, params, per_series, want_pred, last_valid=None
):
    """The kernel's recurrence as a loop over time on [G, B] tensors: the
    same f32 operations in the same order (each rounded on its own, no
    fused multiply-add), the SSE summed in f64 in time order. Like the
    kernel, it stops after the last valid step (masked steps change no
    state and add nothing to the SSE) and fills the rest of `pred` from
    the frozen state: (level + trend) + season[t mod m], or x on a row
    that never saw a valid point."""
    b, t_len = values.shape
    m = init_season.shape[1]
    if per_series:
        alpha, beta, gamma = params[:, 0], params[:, 1], params[:, 2]  # [B]
        g = 1
    else:
        alpha, beta, gamma = params[:, 0:1], params[:, 1:2], params[:, 2:3]  # [G, 1]
        g = params.shape[0]
    oma, omb, omg = 1.0 - alpha, 1.0 - beta, 1.0 - gamma
    level = init_level.expand(g, b).clone()
    trend = torch.zeros((g, b), dtype=torch.float32, device=values.device)
    season = init_season.t()[:, None, :].expand(m, g, b).clone()  # [m, G, B]
    sse = torch.zeros((g, b), dtype=torch.float64, device=values.device)
    inited = torch.zeros(b, dtype=torch.bool, device=values.device)
    xs, ms = values.t(), mask.t()
    n_steps = _steps(last_valid_index(mask) if last_valid is None else last_valid)
    preds = []
    for t in range(n_steps):
        x, msk = xs[t], ms[t]
        p = t % m
        s = season[p].clone()
        lt = level + trend
        forecast = lt + s
        new_level = alpha * (x - s) + oma * lt
        new_trend = beta * (new_level - level) + omb * trend
        new_s = gamma * (x - new_level) + omg * s
        upd = msk & inited
        season[p] = torch.where(upd, new_s, s)
        level = torch.where(upd, new_level, level)
        trend = torch.where(upd, new_trend, trend)
        out = torch.where(inited, forecast, x)
        r = x - out
        sse = sse + torch.where(msk, r * r, torch.zeros_like(r)).double()
        if want_pred:
            preds.append(out[0])
        inited = inited | msk
    pred = None
    if want_pred:
        phases = torch.arange(n_steps, t_len, device=values.device) % m
        frozen = (level + trend)[0][:, None] + season[phases, 0, :].t()
        tail = torch.where(inited[:, None], frozen, values[:, n_steps:])
        pred = torch.cat([torch.stack(preds, dim=1) if preds else values.new_zeros((b, 0)), tail], dim=1)
    return level, trend, season.permute(1, 2, 0), sse, pred


def holt_winters_scan(
    values: torch.Tensor,
    mask: torch.Tensor,
    init_level: torch.Tensor,
    init_season: torch.Tensor,
    params: torch.Tensor,
    per_series: bool = False,
    want_pred: bool = False,
    last_valid: torch.Tensor | None = None,
):
    """Additive Holt-Winters recurrence (`_hw_rolled`'s step) over [B, T].

    values [B, T] f32, mask [B, T] bool, init_level [B] f32, init_season
    [B, m] f32; params [G, 3] f32 rows (alpha, beta, gamma) applied to
    every series, or with `per_series` [B, 3], one row per series (G = 1).
    Returns (level [G, B], trend [G, B], season [G, B, m], sse [G, B] f64,
    pred [B, T] or None): terminal state per (parameter set, series), the
    masked in-sample SSE sum((x - pred)^2 over valid points) and, when
    `want_pred` (per-series only), the one-step-ahead predictions. The
    season index is the absolute step mod m; masked steps carry the
    state; before the first valid point pred = x. `last_valid` [B] is each
    row's last valid index (-1 for none), `last_valid_index(mask)` when
    not given (`fit_holt_winters` shares one between its two launches):
    the recurrence runs no further. The returned tensors may be views (not
    contiguous). More than 256 parameter sets, or a season of 2^31 entries
    or more, run as several launches."""
    b, t_len = values.shape
    m = init_season.shape[1]
    g = 1 if per_series else params.shape[0]
    if want_pred and not per_series:
        raise ValueError("pred is written only for per-series parameters (G = 1)")
    if m < 1:
        raise ValueError("season length must be at least 1")
    lv = last_valid_index(mask) if last_valid is None else last_valid
    if g > _MAX_G:
        parts = [
            holt_winters_scan(values, mask, init_level, init_season, params[i : i + _MAX_G], last_valid=lv)
            for i in range(0, g, _MAX_G)
        ]
        return (*(torch.cat(x) for x in zip(*(p[:4] for p in parts))), None)
    rows = max(1, (_SEASON_ENTRIES - 1) // (m * g))
    if b > rows:
        parts = [
            holt_winters_scan(
                values[i : i + rows], mask[i : i + rows], init_level[i : i + rows],
                init_season[i : i + rows], params[i : i + rows] if per_series else params,
                per_series, want_pred, lv[i : i + rows],
            )
            for i in range(0, b, rows)
        ]
        level, trend, season, sse = (torch.cat(x, dim=1) for x in zip(*(p[:4] for p in parts)))
        return level, trend, season, sse, torch.cat([p[4] for p in parts]) if want_pred else None
    if not _on_cuda(values, mask, init_level, init_season, params, lv):
        return _holt_winters_scan_plain(
            values.float(), mask, init_level.float(), init_season.float(), params.float(),
            per_series, want_pred, lv,
        )
    dev = values.device
    lv = lv.to(torch.int32).contiguous()
    _check(lv, "last_valid", torch.int32, (b,))
    _check(values, "values", torch.float32, (b, t_len))
    _check(mask, "mask", torch.bool, (b, t_len))
    _check(init_level, "init_level", torch.float32, (b,))
    _check(init_season, "init_season", torch.float32, (b, m))
    _check(params, "params", torch.float32, (b if per_series else g, 3))
    n = b * g
    level = torch.empty(n, dtype=torch.float32, device=dev)
    trend = torch.empty(n, dtype=torch.float32, device=dev)
    season = torch.empty((m, n), dtype=torch.float32, device=dev)
    sse = torch.empty(n, dtype=torch.float64, device=dev)
    pred = torch.empty((b, t_len), dtype=torch.float32, device=dev) if want_pred else None
    _launch(
        "holt_winters_scan",
        values.data_ptr(), mask.data_ptr(), lv.data_ptr(), init_level.data_ptr(),
        init_season.data_ptr(), params.data_ptr(), level.data_ptr(), trend.data_ptr(), season.data_ptr(),
        sse.data_ptr(), None if pred is None else pred.data_ptr(),
        int(per_series), b, t_len, m, g,
    )

    def lanes(x):  # [B * G] in lane order b * G + g -> [G, B]
        return x.view(b, g).t()

    return lanes(level), lanes(trend), season.view(m, b, g).permute(2, 1, 0), lanes(sse), pred


# ---------------------------------------------------------------------------
# holt_scan — Holt's linear trend (double exponential smoothing)
# ---------------------------------------------------------------------------


def _holt_scan_plain(values, mask, alpha, beta):
    """The kernel's recurrence as a loop over time on [B] tensors, stopped
    after the last valid step like the kernel; the rest of `pred` is the
    frozen level + trend, or x on a row that never saw a valid point."""
    b, t_len = values.shape
    oma, omb = 1.0 - alpha, 1.0 - beta
    level = torch.zeros(b, dtype=torch.float32, device=values.device)
    trend = torch.zeros_like(level)
    inited = torch.zeros(b, dtype=torch.bool, device=values.device)
    xs, ms = values.t(), mask.t()
    n_steps = _steps(last_valid_index(mask))
    preds = []
    for t in range(n_steps):
        x, msk = xs[t], ms[t]
        lt = level + trend
        new_level = alpha * x + oma * lt
        new_trend = beta * (new_level - level) + omb * trend
        first = msk & ~inited
        upd = msk & inited
        level = torch.where(first, x, torch.where(upd, new_level, level))
        trend = torch.where(first, torch.zeros_like(trend), torch.where(upd, new_trend, trend))
        preds.append(torch.where(inited, lt, x))
        inited = inited | msk
    tail = torch.where(inited[:, None], (level + trend)[:, None], values[:, n_steps:])
    pred = torch.cat([torch.stack(preds, dim=1) if preds else values.new_zeros((b, 0)), tail], dim=1)
    return level, trend, pred


def holt_scan(values: torch.Tensor, mask: torch.Tensor, alpha, beta):
    """Holt's level + trend recurrence (`double_exponential`'s scan).

    values [B, T] f32, mask [B, T] bool; alpha, beta scalar or [B].
    Level starts at each series' first valid point with trend 0; masked
    steps carry the state; the recurrence stops at each row's last valid
    step (`last_valid_index`). Returns (level [B], trend [B], pred [B, T])."""
    b, t_len = values.shape
    dev = values.device
    a = _row(alpha, b, torch.float32, dev)
    bt = _row(beta, b, torch.float32, dev)
    if not _on_cuda(values, mask):
        return _holt_scan_plain(values.float(), mask, a, bt)
    _check(values, "values", torch.float32, (b, t_len))
    _check(mask, "mask", torch.bool, (b, t_len))
    lv = last_valid_index(mask).to(torch.int32)
    level = torch.empty(b, dtype=torch.float32, device=dev)
    trend = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty((b, t_len), dtype=torch.float32, device=dev)
    _launch(
        "holt_scan",
        values.data_ptr(), mask.data_ptr(), lv.data_ptr(), a.data_ptr(), bt.data_ptr(),
        level.data_ptr(), trend.data_ptr(), pred.data_ptr(), b, t_len,
    )
    return level, trend, pred
