"""The plain reference of the deployed default judgment,
`moving_average_all` with the pairwise gate (`ML_PAIRWISE_ALGORITHM=ALL`).

Written from the published statistics, in NumPy and float64, with no
code of the program: for each (service, metric) window,

  1. the model over the 7-day history: the mean and the standard
     deviation (ddof 0) of the history as the configuration stores it,
     an anchor (the first point) plus bfloat16 deltas from it;
  2. for a canary, four same-distribution tests of the current window
     against its baseline window, each gated on a minimum point count:
     Mann-Whitney U (normal approximation, tie-corrected, continuity
     0.5), Wilcoxon signed-rank (zero differences dropped,
     tie-corrected, no continuity), Kruskal-Wallis H and the two-group
     Friedman chi-square (both tie-corrected, chi-square with 1 dof).
     Under ALL the distributions differ when every test that passes its
     gate rejects at `p_threshold`; p is the largest p of those tests;
  3. the band mean +/- t * sd, with t the metric type's threshold,
     halved when the distributions differ, and the lower edge floored
     at the type's min_lower_bound;
  4. flags: points above the upper edge (bound 1 or 3) or below the
     lower one (bound 2 or 3); the window is unhealthy when any point is
     flagged, unknown when the history has fewer than
     min_historical_points points or the window is empty.

`precision="control"` computes the same one step lower, as a program
tempted to save bytes would: the deltas in float8 (e4m3, saturating),
and the windows, the moments and the band edges rounded to bfloat16.

The harness's windows are whole (every point present); a window with a
missing point is refused rather than judged.

`expected` is the entry point a run calls by the configuration's
`reference` key: it walks the harness's schedule (`fleet.py`) and turns
the judgments into the statuses the worker should have written.
"""

from __future__ import annotations

import math

import numpy as np

from portbench import fleet

CONFIG, CONTROL = "config", "control"
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


def _erfc(x: np.ndarray) -> np.ndarray:
    try:
        from scipy.special import erfc
    except ImportError:  # the formula is the same either way
        return np.vectorize(math.erfc, otypes=[np.float64])(x)
    return erfc(x)


def _normal_two_sided(z: np.ndarray) -> np.ndarray:
    return np.clip(_erfc(z / math.sqrt(2.0)), 0.0, 1.0)


def _chi2_1_sf(x: np.ndarray) -> np.ndarray:
    return np.clip(_erfc(np.sqrt(np.maximum(x, 0.0) / 2.0)), 0.0, 1.0)


def _round(a: np.ndarray, dtype: str) -> np.ndarray:
    """`a` rounded to a narrower float type (round to nearest even), as
    float64."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    else:
        t = t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return t.to(torch.float64).numpy()


def fit(hist: np.ndarray, precision: str = CONFIG) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, sd, n) [R] of float32 histories [R, Th] stored as an anchor
    plus deltas."""
    hist = np.asarray(hist, np.float32)
    if not np.isfinite(hist).all():
        raise ValueError("the reference judges whole histories only")
    anchor = hist[:, :1]
    delta = hist - anchor  # float32, as stored
    d = _round(delta, "bf16" if precision == CONFIG else "fp8")
    mean = anchor[:, 0].astype(np.float64) + d.mean(axis=1)
    sd = d.std(axis=1)
    if precision == CONTROL:
        mean, sd = _round(mean, "bf16"), _round(sd, "bf16")
    return mean, sd, np.full(len(hist), hist.shape[1])


def _rank_rows(v: np.ndarray) -> np.ndarray:
    from scipy.stats import rankdata

    return rankdata(v, method="average", axis=1)


def _tie_term(v: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """sum over groups of equal values of (t^3 - t), per row."""
    out = np.zeros(len(v))
    s = np.sort(v, axis=1)
    has = (s[:, 1:] == s[:, :-1]).any(axis=1) if s.shape[1] > 1 else np.zeros(len(v), bool)
    for i in np.nonzero(has)[0]:
        row = v[i] if valid is None else v[i][valid[i]]
        _, counts = np.unique(row, return_counts=True)
        out[i] = float((counts.astype(np.float64) ** 3 - counts).sum())
    return out


def pairwise_all(cur: np.ndarray, base: np.ndarray, p_threshold: float, min_mw: int, min_wx: int,
                 min_kw: int, min_fr: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p, differs, ambiguous) [W] of whole windows cur, base [W, n]:
    the ALL decision of the four tests. `ambiguous` marks a window whose
    decision turns on rounding: a gated-in test's p within 1e-4 of the
    threshold."""
    x = np.asarray(cur, np.float64)
    y = np.asarray(base, np.float64)
    w, nx = x.shape
    ny = y.shape[1]
    n = nx + ny
    pooled = np.concatenate([x, y], axis=1)
    ranks = _rank_rows(pooled)
    r1 = ranks[:, :nx].sum(axis=1)
    tie = _tie_term(pooled)

    # Mann-Whitney U
    u1 = r1 - nx * (nx + 1) / 2.0
    var = nx * ny / 12.0 * ((n + 1) - tie / (n * (n - 1)))
    sd = np.sqrt(np.maximum(var, 0.0))
    z = np.maximum((np.abs(u1 - nx * ny / 2.0) - 0.5) / np.maximum(sd, 1e-300), 0.0)
    ok_mw = (nx >= min_mw) & (ny >= min_mw) & (sd > 0)
    p_mw = np.where(ok_mw, _normal_two_sided(z), 1.0)

    # Kruskal-Wallis H, two groups
    r2 = n * (n + 1) / 2.0 - r1
    h = 12.0 / (n * (n + 1)) * (r1 ** 2 / nx + r2 ** 2 / ny) - 3.0 * (n + 1)
    corr = 1.0 - tie / (n ** 3 - n)
    h = np.maximum(h / np.maximum(corr, 1e-300), 0.0)
    ok_kw = (nx >= min_kw) & (ny >= min_kw) & (corr > 0)
    p_kw = np.where(ok_kw, _chi2_1_sf(h), 1.0)

    # Wilcoxon signed-rank, paired by position, zero differences dropped
    d = x - y
    nz = d != 0
    m = nz.sum(axis=1).astype(np.float64)
    absd = np.where(nz, np.abs(d), np.inf)
    r = _rank_rows(absd)  # the dropped zeros rank last and are masked out
    w_plus = np.where(nz & (d > 0), r, 0.0).sum(axis=1)
    tie_w = _tie_term(absd, nz)
    var_w = m * (m + 1) * (2 * m + 1) / 24.0 - tie_w / 48.0
    sd_w = np.sqrt(np.maximum(var_w, 0.0))
    z_w = np.abs(w_plus - m * (m + 1) / 4.0) / np.maximum(sd_w, 1e-300)
    ok_wx = (min(nx, ny) >= min_wx) & (m > 0) & (sd_w > 0)
    p_wx = np.where(ok_wx, _normal_two_sided(z_w), 1.0)

    # Friedman chi-square, two groups (a paired sign test with ties)
    k = float(min(nx, ny))
    n_plus = (x > y).sum(axis=1)
    n_minus = (x < y).sum(axis=1)
    ties = k - n_plus - n_minus
    ra = 2.0 * n_plus + n_minus + 1.5 * ties
    rb = 2.0 * n_minus + n_plus + 1.5 * ties
    c = 1.0 - ties / k
    stat = np.maximum((2.0 / k * (ra ** 2 + rb ** 2) - 9.0 * k) / np.maximum(c, 1e-300), 0.0)
    ok_fr = (k >= min_fr) & (c > 0)
    p_fr = np.where(ok_fr, _chi2_1_sf(stat), 1.0)

    oks = np.stack([ok_mw, ok_wx, ok_kw, ok_fr])
    ps = np.stack([p_mw, p_wx, p_kw, p_fr])
    rej = oks & (ps < p_threshold)
    any_ok = oks.any(axis=0)
    differs = any_ok & (rej | ~oks).all(axis=0)
    p = np.where(any_ok, np.where(oks, ps, 0.0).max(axis=0), 1.0)
    ambiguous = (oks & (np.abs(ps - p_threshold) < 1e-4)).any(axis=0)
    return p, differs, ambiguous


def judge(mean, sd, n_hist, cur, base, threshold, bound, min_lower_bound, pairwise: dict,
          min_hist: int, precision: str = CONFIG, edge_rel: float = 1e-5) -> dict:
    """Judge W whole windows cur [W, Tc] against their fits (mean, sd,
    n_hist [W]); `base` [W, Tc] with NaN rows where a window has no
    baseline. Per-window threshold / bound / min_lower_bound [W].
    Returns verdict, flags [W, Tc], upper / lower (the band's last
    point), p, differs, and `near` [W]: a point within `edge_rel` of an
    edge or a pairwise p at the threshold (rounding may decide it)."""
    cur = np.asarray(cur, np.float64)
    if not np.isfinite(cur).all():
        raise ValueError("the reference judges whole windows only")
    if precision == CONTROL:
        cur = _round(cur, "bf16")
        base = np.where(np.isnan(base), np.nan, _round(np.nan_to_num(base), "bf16"))
    w = len(cur)
    p = np.ones(w)
    differs = np.zeros(w, bool)
    near = np.zeros(w, bool)
    has_base = ~np.isnan(base).any(axis=1)
    if has_base.any():
        pb, db, ab = pairwise_all(cur[has_base], base[has_base], **pairwise)
        p[has_base], differs[has_base], near[has_base] = pb, db, ab
    thr = np.where(differs, 0.5, 1.0) * np.asarray(threshold, np.float64)
    upper = mean + thr * sd
    lower = np.maximum(mean - thr * sd, np.asarray(min_lower_bound, np.float64))
    if precision == CONTROL:
        upper, lower = _round(upper, "bf16"), _round(lower, "bf16")
    bound = np.asarray(bound)
    use_up = ((bound == 1) | (bound == 3))[:, None]
    use_lo = ((bound == 2) | (bound == 3))[:, None]
    flags = ((cur > upper[:, None]) & use_up) | ((cur < lower[:, None]) & use_lo)
    scale = np.maximum(np.abs(upper), 1e-30)[:, None]
    close = (np.abs(cur - upper[:, None]) <= edge_rel * scale) | (
        np.abs(cur - lower[:, None]) <= edge_rel * np.maximum(np.abs(lower), 1e-30)[:, None]
    )
    near |= close.any(axis=1)
    measurable = (np.asarray(n_hist) >= min_hist) & (cur.shape[1] > 0)
    verdict = np.where(measurable, np.where(flags.any(axis=1), 1, 0), 2)
    flags &= measurable[:, None]
    return dict(verdict=verdict, flags=flags, upper=upper, lower=lower, p=p, differs=differs, near=near,
                values=cur)


def settings(env: dict, aliases) -> dict:
    """What the reference reads from the configuration's environment
    (the names of `foremast-brain.yaml:21-81`): each alias's (threshold,
    bound, min_lower_bound) by the first metric type named in the alias,
    else the globals; the pairwise gate; the history minimum."""
    def get(name, default):
        raw = env.get(name, "")
        return default if raw == "" else type(default)(raw)

    if get("ML_ALGORITHM", "moving_average_all") != "moving_average_all":
        raise ValueError("this reference judges moving_average_all only")
    if get("ML_PAIRWISE_ALGORITHM", "ALL").upper() != "ALL":
        raise ValueError("this reference decides ML_PAIRWISE_ALGORITHM=ALL only")
    names = {"upper": 1, "lower": 2, "both": 3}

    def bound_of(raw) -> int:
        return names.get(str(raw).lower()) or int(raw)

    glob = (float(env.get("ML_THRESHOLD") or env.get("threshold") or 2.0),
            bound_of(env.get("ML_BOUND") or env.get("bound") or 1), get("min_lower_bound", 0.0))
    types = []
    for i in range(int(env.get("metric_type_threshold_count", "0") or 0)):
        t = env.get(f"metric_type{i}", "")
        if t:
            types.append((t.lower(), (float(env.get(f"threshold{i}") or glob[0]),
                                      bound_of(env.get(f"bound{i}") or glob[1]),
                                      float(env.get(f"min_lower_bound{i}") or glob[2]))))
    rules = {}
    for a in aliases:
        rules[a] = next((r for t, r in types if t in a.lower()), glob)
    return dict(
        rules=rules,
        pairwise=dict(
            p_threshold=get("ML_PAIRWISE_THRESHOLD", 0.05),
            min_mw=get("MIN_MANN_WHITE_DATA_POINTS", 20),
            min_wx=get("MIN_WILCOXON_DATA_POINTS", 20),
            min_kw=get("MIN_KRUSKAL_DATA_POINTS", 5),
            min_fr=get("MIN_FRIEDMAN_DATA_POINTS", 20),
        ),
        min_hist=get("MIN_HISTORICAL_DATA_POINT_TO_MEASURE", 10),
    )


def expected(shape, traffic, schedule, pools, env: dict, first: int, last: int,
             precision: str = CONFIG) -> dict:
    """What the worker should have written, worked out again from the
    harness's series: (doc id, sweep) -> {"status": (status, code,
    reason, values), "windows": {alias: (verdict, flagged times, upper,
    lower, p, differs)}, "near": bool} for the sampled documents, sweeps
    `first`..`last`. The entry point the check calls by the
    configuration's `reference` key."""
    st = settings(env, shape.aliases)
    a_n = len(shape.aliases)
    tc = shape.current_points
    adv = traffic.advance_points
    docs = [d for d in schedule.docs if d.sampled and d.birth <= last]
    if not docs:
        return {}
    rows = np.asarray(sorted({d.pool * a_n + a for d in docs for a in range(a_n)}), np.int64)
    mean, sd, n_hist = fit(pools.hist[rows], precision)
    fit_of = {int(r): i for i, r in enumerate(rows)}
    # every window each document could be judged on, up to its planned end
    meta, cur, base = [], [], []
    for d in docs:
        stop = last if d.end is None else min(last, d.end)
        if d.spiked:
            stop = min(stop, d.birth)
        for s in range(d.birth, stop + 1):
            for a, alias in enumerate(shape.aliases):
                row = d.pool * a_n + a
                off = (s - d.birth) * adv
                meta.append((d, s, a, row))
                cur.append(fleet.window_values(pools, traffic, tc, fleet.Urls.CUR, row, off,
                                               d.spiked and alias == traffic.regression_alias))
                base.append(fleet.window_values(pools, traffic, tc, fleet.Urls.BASE, row, off, False)
                            if d.canary else np.full(tc, np.nan, np.float32))
    idx = np.asarray([fit_of[m[3]] for m in meta])
    rules = [st["rules"][shape.aliases[m[2]]] for m in meta]
    res = judge(
        mean[idx], sd[idx], n_hist[idx], np.stack(cur), np.stack(base),
        np.asarray([r[0] for r in rules]), np.asarray([r[1] for r in rules]),
        np.asarray([r[2] for r in rules]), st["pairwise"], st["min_hist"], precision,
    )
    by_doc_sweep: dict = {}
    for i, (d, s, a, _row) in enumerate(meta):
        by_doc_sweep.setdefault((d.n, s), []).append(i)
    out = {}
    for d in docs:
        stop = last if d.end is None else min(last, d.end)
        for s in range(d.birth, stop + 1):
            ids = by_doc_sweep.get((d.n, s))
            if ids is None:
                break
            ct = fleet.now_of(s, adv) - fleet.STEP * tc + fleet.STEP * np.arange(tc)
            windows, values = {}, {}
            for i in ids:
                alias = shape.aliases[meta[i][2]]
                cols = np.nonzero(res["flags"][i])[0]
                pairs = []
                for c in cols:
                    pairs += [float(ct[c]), float(np.float32(res["values"][i][c]))]
                windows[alias] = (int(res["verdict"][i]), tuple(float(ct[c]) for c in cols),
                                  float(res["upper"][i]), float(res["lower"][i]), float(res["p"][i]),
                                  bool(res["differs"][i]))
                if pairs:
                    values[alias] = pairs
            verdicts = [w[0] for w in windows.values()]
            end_t = fleet.now_of(d.end, adv) - fleet.STEP // 2 if d.end is not None else fleet.T0 + fleet.FAR
            if 1 in verdicts:
                status = ("completed_unhealth", "200", "anomaly detected", values)
            elif fleet.now_of(s, adv) >= end_t:
                status = (("completed_unknown", "200", "insufficient data", {}) if all(v == 2 for v in verdicts)
                          else ("completed_health", "200", "", {}))
            else:
                status = ("preprocess_completed", "201", "", {})
            if s >= first:
                out[(d.id, s)] = {"status": status, "windows": windows,
                                  "near": bool(res["near"][ids].any())}
            if status[0] != "preprocess_completed":
                break
    return out
