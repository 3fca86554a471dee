"""Shared fixtures of the port's fit-cache and columnar parity tests: a
small numpy fleet made from a seed, the same task list built for the JAX
judge and the port's, and a verdict-by-verdict comparison.

Current windows keep their points well away from the band edges except
for the injected spikes, and baselines sit a fixed shift from the
current window, so every live rank statistic is far from 0 (ROADMAP.md
Queue 3): f32 summation order can then move neither a flag nor a
`dist_differs` bit."""

from __future__ import annotations

import contextlib

import numpy as np

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import judge as jj
from foremast_tpu.engine import scoring as js
from foremast_tpu.engine.arena import set_arena_budget as jax_set_arena_budget
from foremast_tpu.models.cache import ModelCache as JaxCache
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.engine import scoring as ts
from foremast_tpu_torch.engine.arena import set_arena_budget
from foremast_tpu_torch.models.cache import ModelCache

T0 = 1_700_000_000
MTYPES = ["error5xx", "error4xx", "latency", "cpu", "memory", None, "custom"]
# band tolerance by cold-fit route (ROADMAP.md: the bf16-delta fit is the
# same one-pass algebra on both sides; the f32 fit is two-pass here and
# shifted one-pass in the JAX program)
BAND_TOL = {True: 1e-5, False: 1e-4}


def fleet_kwargs(n: int, seed: int = 0, th: int = 400, tc: int = 30, key_prefix: str = "k"):
    """MetricTask keyword dicts for `n` tasks: mixed metric types, every
    5th task spiked, every 7th dropped to 0, even tasks canaries with a
    baseline, a few short or empty histories and current windows of
    several lengths; each with a fit key."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hl = th if i % 9 != 4 else 3  # a too-short history: UNKNOWN
        cl = tc if i % 11 != 6 else max(tc // 3, 1)
        level = 0.5 + 0.1 * (i % 4)
        hv = (level + 0.05 * rng.standard_normal(hl)).astype(np.float32)
        cv = (level + 0.02 * rng.standard_normal(cl)).astype(np.float32)
        if i % 5 == 1:
            cv[cl // 2] = level + 40.0
        if i % 7 == 3:
            cv[0] = 0.0
        ht = T0 + 60 * np.arange(hl, dtype=np.int64)
        ct = ht[-1] + 60 * np.arange(1, cl + 1, dtype=np.int64)
        kw = dict(
            job_id=f"job{i}", alias=f"m{i % 3}", metric_type=MTYPES[i % len(MTYPES)],
            hist_times=ht, hist_values=hv, cur_times=ct, cur_values=cv,
            fit_key=f"{key_prefix}{i}",
        )
        if i % 2 == 0:
            shift = 0.12 if i % 8 == 0 else 0.03
            # every 8th canary's baseline is too short for any rank test
            # (p=1, differs=False)
            bl = 4 if i % 8 == 4 else cl
            kw["base_times"] = ct[:bl] - 60 * cl
            kw["base_values"] = (cv[:bl] - shift).astype(np.float32)
        out.append(kw)
    return out


def seasonal_kwargs(n: int, m: int, th: int, tc: int = 30, seed: int = 0, key_prefix: str = "s"):
    """MetricTask keyword dicts for `n` tasks whose histories are the
    quality generator's kinds at period `m` (flat, seasonal,
    sharp-seasonal, trend, shift, in turn) and whose current windows
    continue each signal with its two 8-sigma spikes. Every third task's
    current window starts 7 steps late (a history-to-current gap the
    seasonal phase must advance over, values at their true time); even
    tasks are canaries with a baseline a fixed shift below; each has a
    fit key."""
    from benchmarks.quality import gen

    kinds = ("flat", "seasonal", "sharp-seasonal", "trend", "shift")
    out = []
    for i in range(n):
        gap = 7 if i % 3 == 1 else 0
        hist, cur, _ = gen(kinds[i % len(kinds)], 1, th + gap, tc, seed=seed + i, period=m)
        hv, cv = hist[0, :th], cur[0]
        ht = T0 + 60 * np.arange(th, dtype=np.int64)
        ct = ht[-1] + 60 * (gap + 1) + 60 * np.arange(tc, dtype=np.int64)
        kw = dict(
            job_id=f"job{i}", alias=f"m{i % 3}", metric_type=MTYPES[i % len(MTYPES)],
            hist_times=ht, hist_values=hv, cur_times=ct, cur_values=cv,
            fit_key=f"{key_prefix}{i}",
        )
        if i % 2 == 0:
            kw["base_times"] = ct - 60 * tc
            kw["base_values"] = (cv - 0.12).astype(np.float32)
        out.append(kw)
    return out


def assert_far_from_band_edges(verdicts, kws, margin: float = 1e-4) -> None:
    """Every judged current point lies `margin` (relative) away from the
    reference judge's band edges ("full" bands), so f32 differences in a
    fit cannot move a flag: a failure means other data are needed."""
    for v, k in zip(verdicts, kws):
        if v.verdict == js.UNKNOWN:
            continue
        cur = np.asarray(k["cur_values"], np.float32)
        for edge in (np.asarray(v.upper), np.asarray(v.lower)):
            gap = np.abs(cur - edge) / (1 + np.abs(edge))
            assert gap.min() > margin, f"{k['job_id']}: a point sits {gap.min():.2e} from a band edge"


def columnar_inputs(judge, kws, canary: bool):
    """The columnar call's arguments, packed as the worker packs a warm
    bucket: keys and entries from `fit_cache.peek`, nidx = len - 1,
    per-row thr/bound/mlb from the metric-type table; the canary bucket
    with its baseline buffer pair; the hist->cur gaps for the algorithms
    whose horizon depends on them."""
    cfg = judge.config
    rows = [k for k in kws if ("base_values" in k) == canary]
    keys = [(cfg.algorithm, cfg.season_steps, k["fit_key"]) for k in rows]
    entries = [judge.fit_cache.peek(key) for key in keys]
    lens = np.asarray([len(k["cur_values"]) for k in rows])
    n_max = max(lens.max(), max((len(k["base_values"]) for k in rows), default=1) if canary else 1)
    tc = jj.bucket_length(int(n_max))
    values = np.zeros((len(rows), tc), np.float32)
    mask = np.zeros((len(rows), tc), bool)
    for i, k in enumerate(rows):
        values[i, : lens[i]] = k["cur_values"]
        mask[i, : lens[i]] = True
    thr, bnd, mlb = cfg.anomaly.gather([k["metric_type"] for k in rows])
    kw = {}
    if canary:
        kw["base_values"] = np.zeros_like(values)
        kw["base_mask"] = np.zeros_like(mask)
        for i, k in enumerate(rows):
            kw["base_values"][i, : len(k["base_values"])] = k["base_values"]
            kw["base_mask"][i, : len(k["base_values"])] = True
    nidx = np.maximum(lens - 1, 0).astype(np.int32)
    if cfg.algorithm in tj.GAP_SENSITIVE_FITS:
        kw["gap_steps"] = tj._gap_steps([tj.MetricTask(**k) for k in rows])
    return (values, mask, keys, entries, nidx, thr, bnd, mlb), kw


def judges(band_mode: str = "full", cache_size: int = 256, **config):
    """(JAX judge, port judge on the CPU), each with an empty fit cache;
    `config` (algorithm, season_steps, ...) goes to both configs."""
    jax_judge = jj.HealthJudge(JaxConfig(**config))
    jax_judge.fit_cache = JaxCache(cache_size)
    jax_judge.band_mode = band_mode
    port = tj.HealthJudge(BrainConfig(**config), device="cpu")
    port.fit_cache = ModelCache(cache_size)
    port.band_mode = band_mode
    return jax_judge, port


def run_both(jax_judge, port, kws):
    want = jax_judge.judge([jj.MetricTask(**k) for k in kws])
    got = port.judge([tj.MetricTask(**k) for k in kws])
    return got, want


def assert_same_verdicts(got, want, tol: float) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.job_id, g.alias) == (w.job_id, w.alias)
        assert g.verdict == w.verdict, g.job_id
        assert g.anomaly_pairs == w.anomaly_pairs, g.job_id
        assert g.dist_differs == w.dist_differs, g.job_id
        assert abs(g.p_value - w.p_value) <= 1e-5 * (1 + abs(w.p_value)), g.job_id
        assert len(g.upper) == len(w.upper) and len(g.lower) == len(w.lower)
        np.testing.assert_allclose(g.upper, w.upper, rtol=tol, atol=tol)
        np.testing.assert_allclose(g.lower, w.lower, rtol=tol, atol=tol)


def assert_same_device_state(jax_judge, port) -> None:
    """Equal counters, and equal row maps in every arena."""
    assert port.device_state_counters() == jax_judge.device_state_counters()
    assert port._arenas.keys() == jax_judge._arenas.keys()
    for key, arena in port._arenas.items():
        ref = jax_judge._arenas[key]
        assert arena.rows == ref.rows
        assert arena.row_key == ref.row_key
        assert arena.counters() == ref.counters()


@contextlib.contextmanager
def bf16_gate(enabled: bool):
    """The bf16-delta cold-fit gate pinned in both packages."""
    js.set_bf16_delta(enabled)
    ts.set_bf16_delta(enabled)
    try:
        yield
    finally:
        js.set_bf16_delta(None)
        ts.set_bf16_delta(None)


@contextlib.contextmanager
def arena_budget(soft_bytes, max_bytes):
    """Arena byte budgets pinned in both packages."""
    jax_set_arena_budget(soft_bytes, max_bytes)
    set_arena_budget(soft_bytes, max_bytes)
    try:
        yield
    finally:
        jax_set_arena_budget(None, None)
        set_arena_budget(None, None)
