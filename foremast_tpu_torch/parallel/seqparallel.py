"""Context parallelism for long metric windows: the time axis over `model`.

The JAX package's `parallel/seqparallel.py` on torch. When a history
outgrows one device (year-long windows, 1 s steps, very wide batches),
its TIME axis splits into contiguous blocks over the mesh's `model`
axis (`mesh.shard_time`: rows over `data`, each row block's time over
`model`) and the recurrences and reductions run block-parallel:

  * `sharded_linear_scan` — l_t = a_t l_{t-1} + b_t, whose composition
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2) is associative: each
    time block scans locally, the per-block composed totals ([B] pairs)
    are copied to every later block, each block folds its exclusive
    prefix and applies it locally;
  * `sharded_masked_stats` / `sharded_masked_moments` — masked count,
    mean and variance from per-block partial sums added across `model`;
  * `sharded_phase_means` — the daily-seasonal (phase-pooled) fit, whose
    trend moments, per-phase sums and counts and residual scale are all
    per-block partial sums (the backfit rounds included), plus one max of
    the last valid index;
  * `score_time_sharded` — the whole judgment with the history's time
    axis sharded, through `scoring.judgment_tail` / `score_from_state`.

The JAX package's collectives (`psum`, `all_gather`, `pmax`) become
non-blocking device-to-device copies of [B]-sized partials to the row
block's first device (the grid's first column), where the sum is taken
and from where it is copied back. The results are `Blocks` over the data
axis on those first devices, as JAX's are replicated along `model`.
"""

from __future__ import annotations

import dataclasses

import torch

from foremast_tpu_torch.ops.forecasters import _linrec_scan
from foremast_tpu_torch.ops.windows import MetricWindows
from foremast_tpu_torch.parallel import mesh as meshlib
from foremast_tpu_torch.parallel.mesh import Blocks, device_scope


def _grid(x, mesh) -> Blocks:
    return meshlib.shard_time(x, mesh)


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def _psum(partials: list, root: torch.device):
    """Sum of per-time-block partial trees on `root` (the row block's
    first device), the blocks added in order."""
    total = None
    for part in partials:
        moved = meshlib.tree_map(lambda t: _to(t, root), part)
        total = moved if total is None else meshlib.tree_map(torch.add, total, moved)
    return total


def _scan_blocks(a: Blocks, b: Blocks) -> Blocks:
    """One row block of `sharded_linear_scan`: a, b are its time blocks."""
    devs = [p.device for p in a.parts]
    tots, locs = [], []
    for ap, bp in zip(a.parts, b.parts):
        with device_scope(ap.device):
            # local inclusive scan: the composed a is the running product,
            # the composed b is the local level from l = 0
            ca = torch.cumprod(ap, dim=-1)
            cb = _linrec_scan(ap, bp)
            locs.append((ca, cb))
            tots.append((ca[..., -1], cb[..., -1]))
    out = []
    for j, dev in enumerate(devs):
        with device_scope(dev):
            # exclusive prefix over the blocks before j (the gathered
            # totals, copied here): the state entering block j
            pre = torch.zeros_like(tots[j][1])
            for ta, tb in tots[:j]:
                pre = _to(ta, dev) * pre + _to(tb, dev)
            ca, cb = locs[j]
            out.append(ca * pre[..., None] + cb)
    return Blocks(out, axis=-1)


def sharded_linear_scan(a, b, mesh: meshlib.Mesh) -> Blocks:
    """Distributed l_t = a_t * l_{t-1} + b_t (l_0 = 0) with time sharded.

    a, b: [B, T] (tensors, split here, or already `shard_time`d). Returns
    l [B, T] with the same layout; `.gather()` joins it."""
    return meshlib.per_block(_scan_blocks, _grid(a, mesh), _grid(b, mesh))


def _map_time(fn, *grids) -> Blocks:
    """`fn` on every (row block, time block) part of `grids`."""
    return meshlib.per_block(lambda *rows: meshlib.per_block(fn, *rows), *grids)


def sharded_ewma(values, mask, alpha: float, mesh: meshlib.Mesh) -> Blocks:
    """EWMA levels over a time-sharded window (`ops.forecasters.
    ewma_levels`): the first-valid-point initialization needs the global
    running count of valid points, a second distributed linear scan
    (a = 1, b = mask)."""
    v, m = _grid(values, mesh), _grid(mask, mesh)
    cnt = sharded_linear_scan(_map_time(torch.ones_like, v), _map_time(lambda x, k: k.to(x.dtype), v, m), mesh)

    def coeffs(x, k, c):
        a_eff = torch.where(k, torch.full_like(x, alpha), torch.zeros_like(x))
        a_eff = torch.where(k & (c == 1.0), torch.ones_like(x), a_eff)
        return 1.0 - a_eff, a_eff * x

    ab = _map_time(coeffs, v, m, cnt)
    return sharded_linear_scan(ab[0], ab[1], mesh)


def _stats_blocks(v: Blocks, mk: Blocks):
    root = v.parts[0].device
    partials = []
    for vp, mp in zip(v.parts, mk.parts):
        with device_scope(vp.device):
            mf = mp.to(vp.dtype)
            partials.append(((vp * mf).sum(-1), (vp * vp * mf).sum(-1), mf.sum(-1)))
    with device_scope(root):
        s1, s2, n = _psum(partials, root)
        zero = torch.zeros_like(n)
        mean = torch.where(n > 0, s1 / n.clamp_min(1.0), zero)
        var = torch.where(n > 0, s2 / n.clamp_min(1.0) - mean * mean, zero)
        return n, mean, var.clamp_min(0.0)


def sharded_masked_stats(values, mask, mesh: meshlib.Mesh):
    """Global masked (count, mean, var) over a time-sharded window: three
    [B] `Blocks` over the data axis, from per-block partial sums."""
    return meshlib.per_block(_stats_blocks, _grid(values, mesh), _grid(mask, mesh))


def sharded_masked_moments(values, mask, mesh: meshlib.Mesh):
    """(mean, var) view of `sharded_masked_stats`."""
    _, mean, var = sharded_masked_stats(values, mask, mesh)
    return mean, var


def _phase_means_blocks(v: Blocks, mk: Blocks, m_len: int, t_total: int):
    """One row block of `sharded_phase_means` (the JAX program's local
    body; its psums are `_psum`, and what the blocks read back is copied
    to each of them)."""
    devs = [p.device for p in v.parts]
    root = devs[0]
    t_blk = v.parts[0].shape[-1]
    b = v.parts[0].shape[0]
    dt = v.parts[0].dtype
    loc = []
    for j, (vp, mp) in enumerate(zip(v.parts, mk.parts)):
        with device_scope(vp.device):
            gidx = j * t_blk + torch.arange(t_blk, device=vp.device)
            loc.append(dict(v=vp, mk=mp, mf=mp.to(dt), gidx=gidx, tn=gidx.to(dt) / t_total, phase=gidx % m_len))

    def each(fn, *shared):
        """`fn(block, *its copies of shared)` on every time block."""
        copies = [[_to(x, d) for d in devs] for x in shared]
        out = []
        for j, (L, dev) in enumerate(zip(loc, devs)):
            with device_scope(dev):
                out.append(fn(L, *(c[j] for c in copies)))
        return out

    def phase_sum(x):
        return x.reshape(b, t_blk // m_len, m_len).sum(dim=1)

    # psum 1: mask-only trend moments, raw value moments (the
    # identifiability guard) and per-phase counts — each block is
    # phase-aligned, so a local reshape gives exact phase columns
    n, st, stt, sx0, sxx, k = _psum(
        each(
            lambda L: (
                L["mf"].sum(-1),
                (L["tn"] * L["mf"]).sum(-1),
                (L["tn"] * L["tn"] * L["mf"]).sum(-1),
                (L["v"] * L["mf"]).sum(-1),
                (L["v"] * L["v"] * L["mf"]).sum(-1),
                phase_sum(L["mf"]),
            )
        ),
        root,
    )
    with device_scope(root):
        nn = n.clamp_min(1.0)
        denom = stt - st * st / nn
        season = torch.zeros((b, m_len), dtype=dt, device=root)
        zero = torch.zeros((), dtype=dt, device=root)

    def trend_sums(L, s):
        y = L["v"] - s[:, L["phase"]]
        return (y * L["mf"]).sum(-1), (L["tn"] * y * L["mf"]).sum(-1)

    def detrended(L, ic, sl):
        return phase_sum((L["v"] - (ic[:, None] + sl[:, None] * L["tn"])) * L["mf"])

    # backfit trend <-> pooled phase means: the iteration count and math
    # of `fit_phase_means`, two sums a round
    for _ in range(3):
        sx, stx = _psum(each(trend_sums, season), root)
        with device_scope(root):
            slope_n = torch.where(denom > 1e-12, (stx - st * sx / nn) / denom.clamp_min(1e-12), zero)
            intercept = sx / nn - slope_n * st / nn
        ssum = _psum(each(detrended, intercept, slope_n), root)
        with device_scope(root):
            season = torch.where(k > 0, ssum / k.clamp_min(1.0), zero)

    # centered leave-one-out residual scale (k = 1 phases carry no
    # information; degenerate gap patterns fall back to the plain
    # residual std — the rules of fit_phase_means)
    def resid(L, s, k_, ic, sl):
        k_at = k_[:, L["phase"]]
        pred = ic[:, None] + sl[:, None] * L["tn"] + s[:, L["phase"]]
        loo = k_at / (k_at - 1.0).clamp_min(1.0)
        smask = L["mf"] * (k_at > 1.5)
        r = (L["v"] - pred) * loo
        r_all = (L["v"] - pred) * L["mf"]
        sums = ((r * r * smask).sum(-1), (r * smask).sum(-1), smask.sum(-1), (r_all * r_all).sum(-1), r_all.sum(-1))
        never = torch.full_like(L["gidx"], -1)
        return sums, torch.where(L["mk"], L["gidx"][None, :], never[None, :]).amax(-1)

    got = each(resid, season, k, intercept, slope_n)
    ss, s1, n2, ss_all, s1_all = _psum([g[0] for g in got], root)
    with device_scope(root):
        # pmax of the last valid global index
        last_valid = _to(got[0][1], root)
        for g in got[1:]:
            last_valid = torch.maximum(last_valid, _to(g[1], root))

        def std(sq, s1_, cnt):
            c = cnt.clamp_min(1.0)
            mu = s1_ / c
            return torch.sqrt((sq / c - mu * mu).clamp_min(0.0))

        scale = torch.where(n2 > 0, std(ss, s1, n2), std(ss_all, s1_all, nn))
        level = intercept + slope_n * last_valid.to(dt) / t_total
        trend = slope_n / t_total
        season_phase = ((last_valid + 1) % m_len).to(torch.int32)
        # per-series 2-cycle identifiability: under-observed series keep
        # the global-mean model
        enough = n >= 2.0 * m_len
        mean_v = torch.where(n > 0, sx0 / nn, zero)
        var_v = (sxx / nn - mean_v * mean_v).clamp_min(0.0)
        season = torch.where(enough[:, None], season, zero)
        level = torch.where(enough, level, mean_v)
        trend = torch.where(enough, trend, zero)
        scale = torch.where(enough, scale, torch.sqrt(var_v))
        return season, level, trend, scale, season_phase, n.to(torch.int32)


def sharded_phase_means(values, mask, season_length: int, mesh: meshlib.Mesh):
    """Daily-seasonal (phase-pooled) fit over a TIME-SHARDED window
    (`ops.forecasters.fit_phase_means`).

    values/mask: [B, T], rows over `data` and time over `model`. Each
    local block must be a whole number of seasons (asserted; pad the
    window), so every block's phase grid starts at 0 (mod m). Series
    with fewer than two cycles of valid points keep the global-mean
    model, as in `fit_phase_means`.

    Returns (season [B, m], level [B], trend [B], scale [B],
    season_phase [B] int32, n_hist [B] int32) as `Blocks` over the data
    axis: the terminal state `scoring.score_from_state` consumes."""
    m_len = int(season_length)
    n_model = mesh.shape[meshlib.MODEL_AXIS]
    t_total = values.shape[1]
    if t_total % n_model:
        raise ValueError(f"model-axis size ({n_model}) must divide the time axis ({t_total})")
    t_loc = t_total // n_model
    if t_loc % m_len:
        raise ValueError(
            f"local block ({t_loc}) must be a multiple of season_length ({m_len}) so every block is "
            "phase-aligned — pad the window"
        )
    return meshlib.per_block(
        lambda v, mk: _phase_means_blocks(v, mk, m_len, t_total), _grid(values, mesh), _grid(mask, mesh)
    )


def _short_batch(batch, mesh: meshlib.Mesh):
    """The data-sharded part of a ScoreBatch (everything but the
    history), split over the data axis where it is not already."""
    short = dataclasses.replace(batch, historical=None)
    return meshlib.shard_leading(short, mesh)


def score_time_sharded(batch, mesh: meshlib.Mesh, config=None, algorithm: str = "moving_average_all", gap_steps=None):
    """Full judgment with the HISTORY's time axis sharded over `model`.

    `batch.historical` as [B over data, Th over model] (tensors are split
    here), the rest of the batch over `data`. Two fits:

      * `moving_average_all` — the masked moments from per-block partial
        sums, then `scoring.judgment_tail`, as `scoring.score`;
      * `phase_means` — `sharded_phase_means` (season from
        `config.season_steps`), whose terminal state feeds
        `scoring.score_from_state`, the fit-cache path's judgment.

    `gap_steps` [B]: the hist->cur gap of drifted re-check windows; the
    seasonal phase advances by it as on every phase_means path. Returns
    a ScoreResult whose tensors are `Blocks` over the data axis."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring

    cfg = config or BrainConfig()
    pw = dict(
        pairwise_algorithm=cfg.pairwise.algorithm,
        p_threshold=cfg.pairwise.threshold,
        min_mw=cfg.pairwise.min_mann_white_points,
        min_wilcoxon=cfg.pairwise.min_wilcoxon_points,
        min_kruskal=cfg.pairwise.min_kruskal_points,
        min_friedman=cfg.pairwise.min_friedman_points,
    )
    hist_v, hist_m = _grid(batch.historical.values, mesh), _grid(batch.historical.mask, mesh)
    short = _short_batch(batch, mesh)
    gap = None if gap_steps is None else meshlib.shard_leading(gap_steps, mesh)

    def with_hist(b):
        return dataclasses.replace(b, historical=MetricWindows(values=b.current.values[:, :0], mask=b.current.mask[:, :0], times=None))

    if algorithm == "phase_means":
        season, level, trend, scale, phase, n_hist = sharded_phase_means(hist_v, hist_m, cfg.season_steps, mesh)
        return meshlib.per_block(
            lambda b, *st, gap_steps: scoring.score_from_state(with_hist(b), *st, gap_steps=gap_steps, **pw),
            short,
            level,
            trend,
            season,
            phase,
            scale,
            n_hist,
            gap_steps=gap,
        )
    if algorithm != "moving_average_all":
        raise ValueError(f"score_time_sharded supports moving_average_all and phase_means, not {algorithm!r}")
    n, mean, var = sharded_masked_stats(hist_v, hist_m, mesh)

    def tail(b, n_, mean_, var_):
        pred = mean_[:, None].expand(b.current.values.shape)
        return scoring.judgment_tail(with_hist(b), pred, torch.sqrt(var_), n_, **pw)

    return meshlib.per_block(tail, short, n, mean, var)
