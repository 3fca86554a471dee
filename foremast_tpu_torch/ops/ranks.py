"""Masked, batched rank statistics: the pairwise baseline-vs-current tests.

Mann-Whitney U, Wilcoxon signed-rank, Kruskal-Wallis and the two-group
Friedman chi-square (reference `docs/guides/design.md:90-93`), each gated
on a minimum number of points. Windows are short (tens of points), so
tie-averaged ranks come from O(N^2) comparison blocks batched over [B]:

    rank_i = (# valid j with x_j < x_i) + (1 + # valid j with x_j == x_i) / 2

Invalid entries are parked at `_BIG` and counts are taken in int32, so
every rank sum is an exact multiple of 0.5 and matches the JAX package
bit for bit. Each test returns (stat, p, ok); a gated-out test has
p = 1.0. p-values use the normal / chi-squared asymptotic forms.
"""

from __future__ import annotations

import math

import torch

_BIG = 3.0e38


def _normal_sf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))


def _chi2_sf(x: torch.Tensor, df: float) -> torch.Tensor:
    """Survival function of chi^2 with `df` dof: Q(df/2, x/2)."""
    return torch.special.gammaincc(torch.full_like(x, df / 2.0), x / 2.0)


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den in one IEEE division (torch evaluates `float / tensor`
    as reciprocal-then-multiply, which rounds twice)."""
    return torch.full_like(den, num) / den


def _count(pred: torch.Tensor, dim: int, dtype: torch.dtype) -> torch.Tensor:
    return pred.sum(dim=dim, dtype=torch.int32).to(dtype)


def masked_ranks(
    values: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tie-averaged ranks among valid entries.

    values, mask: [B, N]. Returns (ranks [B, N] — 0.0 at invalid
    positions, 1..n at valid ones; tie_term [B] — sum over tie groups of
    (t^3 - t), which equals the sum over valid i of (t_i^2 - 1))."""
    dt = values.dtype
    x = torch.where(mask, values, torch.full_like(values, _BIG))
    xi = x[..., :, None]
    xj = x[..., None, :]
    validj = mask[..., None, :]
    cnt_less = ((xj < xi) & validj).to(dt).sum(dim=-1)
    cnt_eq = ((xj == xi) & validj).to(dt).sum(dim=-1)  # includes self
    zero = torch.zeros((), dtype=dt, device=values.device)
    ranks = torch.where(mask, cnt_less + (cnt_eq + 1.0) * 0.5, zero)
    tie_term = torch.where(mask, cnt_eq * cnt_eq - 1.0, zero).sum(dim=-1)
    return ranks, tie_term


def _two_sample_rank_stats(
    x: torch.Tensor, x_mask: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r1, tie, nx, ny), each [B]: x's tie-averaged rank sum in the
    union of x and y, and the union's tie term, from [B, Nx, Ny] and
    [B, Nx, Nx] comparison blocks (the union is never ranked whole)."""
    dt = x.dtype
    xs = torch.where(x_mask, x, torch.full_like(x, _BIG))
    ys = torch.where(y_mask, y, torch.full_like(y, _BIG))
    xi = xs[..., :, None]
    yj = ys[..., None, :]
    vy = y_mask[..., None, :]
    xy_less = (yj < xi) & vy
    xy_eq = (yj == xi) & vy  # a parked x_i never equals a valid y_j
    vx = x_mask[..., None, :]
    xx_less = (xs[..., None, :] < xi) & vx
    xx_eq = (xs[..., None, :] == xi) & vx  # includes self
    yy_eq = (ys[..., None, :] == ys[..., :, None]) & vy
    lxy = _count(xy_less, -1, dt)
    exy = _count(xy_eq, -1, dt)
    eyx = _count(xy_eq, -2, dt)  # x's equal to y_j
    lxx = _count(xx_less, -1, dt)
    exx = _count(xx_eq, -1, dt)
    eyy = _count(yy_eq, -1, dt)
    zero = torch.zeros((), dtype=dt, device=x.device)
    rank_x = lxx + lxy + (exx + exy + 1.0) * 0.5
    r1 = torch.where(x_mask, rank_x, zero).sum(dim=-1)
    tie = torch.where(x_mask, (exx + exy) ** 2 - 1.0, zero).sum(dim=-1) + torch.where(
        y_mask, (eyy + eyx) ** 2 - 1.0, zero
    ).sum(dim=-1)
    nx = _count(x_mask, -1, dt)
    ny = _count(y_mask, -1, dt)
    return r1, tie, nx, ny


def mann_whitney_u(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    y_mask: torch.Tensor,
    min_points: int = 20,
    use_continuity: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-sided Mann-Whitney U (normal approximation, tie-corrected).
    Returns (U1 [B], p [B], ok [B])."""
    r1, tie, nx, ny = _two_sample_rank_stats(x, x_mask, y, y_mask)
    n = nx + ny
    u1 = r1 - nx * (nx + 1.0) / 2.0
    mean = nx * ny / 2.0
    tie_frac = tie / (n * (n - 1.0)).clamp_min(1.0)
    var = nx * ny / 12.0 * ((n + 1.0) - tie_frac)
    sd = torch.sqrt(var.clamp_min(0.0))
    cc = 0.5 if use_continuity else 0.0
    z = ((u1 - mean).abs() - cc) / sd.clamp_min(1e-30)
    z = z.clamp_min(0.0)
    p = (2.0 * _normal_sf(z)).clamp(0.0, 1.0)
    ok = (nx >= min_points) & (ny >= min_points) & (sd > 0)
    p = torch.where(ok, p, torch.ones_like(p))
    return u1, p, ok


def wilcoxon_signed_rank(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    y_mask: torch.Tensor,
    min_points: int = 20,
    correction: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-sided Wilcoxon signed-rank test, paired position-wise, zero
    differences dropped. Returns (W+ [B], p [B], ok [B])."""
    dt = x.dtype
    d = x - y
    pair_mask = x_mask & y_mask
    nz_mask = pair_mask & (d != 0.0)
    ranks, tie = masked_ranks(d.abs(), nz_mask)
    n = _count(nz_mask, -1, dt)
    zero = torch.zeros((), dtype=dt, device=x.device)
    w_plus = torch.where(nz_mask & (d > 0), ranks, zero).sum(dim=-1)
    mean = n * (n + 1.0) / 4.0
    var = n * (n + 1.0) * (2.0 * n + 1.0) / 24.0 - tie / 48.0
    sd = torch.sqrt(var.clamp_min(0.0))
    cc = 0.5 if correction else 0.0
    z = ((w_plus - mean).abs() - cc) / sd.clamp_min(1e-30)
    p = (2.0 * _normal_sf(z)).clamp(0.0, 1.0)
    ok = (_count(pair_mask, -1, torch.int32) >= min_points) & (n > 0) & (sd > 0)
    p = torch.where(ok, p, torch.ones_like(p))
    return w_plus, p, ok


def friedman_chi_square(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    y_mask: torch.Tensor,
    min_points: int = 20,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-group paired Friedman chi-square with the tie correction
    C = 1 - ties/n, referred to chi^2 with 1 dof. Returns
    (chi2 [B], p [B], ok [B])."""
    dt = x.dtype
    pair = x_mask & y_mask
    n = _count(pair, -1, dt)
    n_plus = _count(pair & (x > y), -1, dt)
    n_minus = _count(pair & (x < y), -1, dt)
    ties = _count(pair & (x == y), -1, dt)
    r1 = 2.0 * n_plus + n_minus + 1.5 * ties
    r2 = 2.0 * n_minus + n_plus + 1.5 * ties
    n_safe = n.clamp_min(1.0)
    stat = _rdiv(2.0, n_safe) * (r1 * r1 + r2 * r2) - 9.0 * n
    c = 1.0 - ties / n_safe
    stat = (stat / c.clamp_min(1e-30)).clamp_min(0.0)
    p = _chi2_sf(stat, 1.0).clamp(0.0, 1.0)
    ok = (n >= min_points) & (c > 0)
    p = torch.where(ok, p, torch.ones_like(p))
    return stat, p, ok


def kruskal_wallis(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    y_mask: torch.Tensor,
    min_points: int = 5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kruskal-Wallis H for two groups (chi^2 approximation). y's rank
    sum is n(n+1)/2 - r1, exact in f32. Returns (H [B], p [B], ok [B])."""
    r1, tie, nx, ny = _two_sample_rank_stats(x, x_mask, y, y_mask)
    n = nx + ny
    r2 = n * (n + 1.0) * 0.5 - r1
    h = _rdiv(12.0, (n * (n + 1.0)).clamp_min(1.0)) * (
        r1 * r1 / nx.clamp_min(1.0) + r2 * r2 / ny.clamp_min(1.0)
    ) - 3.0 * (n + 1.0)
    tie_corr = 1.0 - tie / (n * n * n - n).clamp_min(1.0)
    # f32 rounding can leave H a tiny negative for identical samples
    h = (h / tie_corr.clamp_min(1e-30)).clamp_min(0.0)
    p = _chi2_sf(h, 1.0).clamp(0.0, 1.0)
    ok = (nx >= min_points) & (ny >= min_points) & (tie_corr > 0)
    p = torch.where(ok, p, torch.ones_like(p))
    return h, p, ok
