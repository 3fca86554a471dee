"""The port's HealthJudge on the CPU against the JAX package's, task for
task, on a mixed list: several history and current-window buckets,
metric types with every bound selector, canaries with and without
baselines, too-short histories, and the reference demo's golden traces.

Verdicts, anomaly pairs and `dist_differs` must match exactly. Bands
match to 1e-4: the port judges through `ma_judgment`'s two-pass moments
where the JAX judge's XLA program uses shifted one-pass moments, both in
f32. `p_value` matches to 1e-5 (the same f32 rank-test formulas; the
baselines keep every live statistic far from 0, where a chi-square p
moves faster than f32 rounding of the statistic). Current points stay
well away from band edges, so neither difference can flip a flag.
"""

import numpy as np
import pytest
import torch

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import judge as jj
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.engine.scoring import HEALTHY, UNHEALTHY, UNKNOWN

T0 = 1_700_000_000


def _series(values, t0=T0):
    v = np.asarray(values, np.float32)
    return t0 + 60 * np.arange(len(v), dtype=np.int64), v


def _task_kwargs(job, alias, mtype, hist, cur, base=None):
    ht, hv = _series(hist)
    ct, cv = _series(cur, T0 + 60 * len(hv))
    kw = dict(
        job_id=job, alias=alias, metric_type=mtype,
        hist_times=ht, hist_values=hv, cur_times=ct, cur_values=cv,
    )
    if base is not None:
        kw["base_times"], kw["base_values"] = _series(base, ct[0] - 60 * len(base))
    return kw


def _mixed_tasks(demo_traces):
    rng = np.random.default_rng(11)
    kws = []
    mtypes = ["error5xx", "error4xx", "latency", "cpu", "memory", None, "custom"]
    shapes = [(50, 10), (200, 30), (1000, 30), (300, 7), (3, 10), (1000, 12)]
    for i in range(28):
        hl, cl = shapes[i % len(shapes)]
        level = 0.5 + 0.1 * (i % 4)
        hist = level + 0.05 * rng.standard_normal(hl)
        cur = level + 0.05 * rng.standard_normal(cl)
        if i % 5 == 1:
            cur[cl // 2] = level + 40.0  # a spike
        if i % 7 == 3:
            cur[0] = 0.0  # a drop, flagged where the lower bound is used
        base = None
        if i % 6 in (1, 2):
            # canary with a baseline a fixed shift below the current window
            base = cur - (0.08 if i % 2 else 0.02)
        kws.append(_task_kwargs(f"job{i}", f"m{i}", mtypes[i % len(mtypes)], hist, cur, base))
    _, nv = demo_traces["normal"]
    _, sv = demo_traces["spike"]
    hist = np.tile(nv, 6)  # the normal trace as a stable history
    kws.append(_task_kwargs("g1", "error4xx", "error4xx", hist, nv))
    kws.append(_task_kwargs("g2", "error4xx", "error4xx", hist, sv))
    return kws


def test_judge_matches_jax_on_a_mixed_fleet(demo_traces):
    kws = _mixed_tasks(demo_traces)
    got = tj.HealthJudge(BrainConfig(), device="cpu").judge([tj.MetricTask(**k) for k in kws])
    want = jj.HealthJudge(JaxConfig()).judge([jj.MetricTask(**k) for k in kws])
    assert len(got) == len(want) == len(kws)
    for g, w in zip(got, want):
        assert (g.job_id, g.alias) == (w.job_id, w.alias)
        assert g.verdict == w.verdict, g.job_id
        assert g.anomaly_pairs == w.anomaly_pairs, g.job_id
        assert g.dist_differs == w.dist_differs, g.job_id
        assert g.p_value == pytest.approx(w.p_value, rel=1e-5, abs=1e-5), g.job_id
        np.testing.assert_allclose(g.upper, w.upper, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.lower, w.lower, rtol=1e-4, atol=1e-4)
        assert len(g.upper) == len(w.upper)
    verdicts = {v.verdict for v in got}
    assert verdicts == {HEALTHY, UNHEALTHY, UNKNOWN}
    assert any(v.dist_differs for v in got) and not all(v.dist_differs for v in got)


def test_golden_traces(demo_traces):
    """Reference demo parity: the spike trace is unhealthy with the 40.134
    spike in its anomaly pairs, the normal trace healthy."""
    kws = _mixed_tasks(demo_traces)[-2:]
    v_norm, v_spike = tj.HealthJudge(device="cpu").judge([tj.MetricTask(**k) for k in kws])
    assert v_norm.verdict == HEALTHY and v_norm.anomaly_pairs == []
    assert v_spike.verdict == UNHEALTHY
    assert pytest.approx(40.134) in v_spike.anomaly_pairs[1::2]
    assert tj.combine_verdicts([v_norm, v_spike]) == UNHEALTHY
    assert tj.combine_verdicts([v_norm]) == HEALTHY
    assert tj.combine_verdicts([]) == UNKNOWN


def test_judge_without_device_needs_cuda():
    """Entry points default to the card and refuse to fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tj.HealthJudge()


def test_from_env_matches_jax_config():
    env = {
        "ML_ALGORITHM": "moving_average_all",
        "ML_THRESHOLD": "2.5",
        "ML_BOUND": "both",
        "min_lower_bound": "0.1",
        "metric_type_threshold_count": "2",
        "metric_type0": "error5xx",
        "threshold0": "4",
        "metric_type1": "latency",
        "bound1": "lower",
        "ML_PAIRWISE_ALGORITHM": "any",
        "MIN_KRUSKAL_DATA_POINTS": "7",
        "MIN_HISTORICAL_DATA_POINT_TO_MEASURE": "12",
    }
    got, want = BrainConfig.from_env(env), JaxConfig.from_env(env)
    assert got.algorithm == want.algorithm
    assert got.min_historical_points == want.min_historical_points
    assert got.season_steps == want.season_steps
    assert vars(got.pairwise) == vars(want.pairwise)
    assert got.anomaly.threshold == want.anomaly.threshold
    assert got.anomaly.bound == want.anomaly.bound
    assert got.anomaly.min_lower_bound == want.anomaly.min_lower_bound
    assert [vars(r) for r in got.anomaly.rules] == [vars(r) for r in want.anomaly.rules]
    types = ["error5xx", "latency", "cpu", None]
    for a, b in zip(got.anomaly.gather(types), want.anomaly.gather(types)):
        np.testing.assert_array_equal(a, b)
