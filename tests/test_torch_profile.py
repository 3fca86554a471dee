"""The port's profiler hooks (`foremast_tpu_torch/observe/profile.py`:
`trace_scoring`, `annotate`) on the CPU, after the JAX package's
`foremast_tpu/observe/profile.py`.

Without `FOREMAST_PROFILE` or a directory `trace_scoring` records
nothing; with one it writes a Chrome trace that holds the judge's span
markers (`judge.fit`, `judge.score`, `judge.decode`); and the judge's
verdicts under the profiler are those of the same pass without it, and
the JAX judge's. On the card, `chip_smoke.py` phase 15 also finds the
CUDA kernels in the trace."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import judge as jj
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.observe import annotate, trace_scoring

T0 = 1_760_000_000.0
MARKERS = ("judge.fit", "judge.score", "judge.decode")


def _task_kwargs(n=24, hist=240, cur=30, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        level, scale = rng.uniform(5, 50), rng.uniform(0.5, 3)
        hv = (level + scale * rng.standard_normal(hist)).astype(np.float32)
        cv = (level + scale * rng.standard_normal(cur)).astype(np.float32)
        if i % 4 == 0:
            cv[-3:] += 12 * scale  # a spike past any band
        ht = T0 - 60.0 * np.arange(hist, 0, -1)
        ct = T0 + 60.0 * np.arange(cur)
        out.append(dict(job_id=f"j{i}", alias="latency", metric_type=("latency", "error5xx")[i % 2],
                        hist_times=ht, hist_values=hv, cur_times=ct, cur_values=cv, app=f"app{i}",
                        fit_key=f"fit-{i}"))
    return out


def _judge(kws):
    """A cold pass through the fit-cache path (the worker's): fit, score
    and decode each open a marker."""
    judge = tj.HealthJudge(BrainConfig(), device="cpu")
    judge.fit_cache = ModelCache(4 * len(kws))
    return judge.judge([tj.MetricTask(**k) for k in kws])


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_no_op_without_profile_env(monkeypatch, tmp_path):
    monkeypatch.delenv("FOREMAST_PROFILE", raising=False)
    with trace_scoring() as handle:
        _judge(_task_kwargs(4))
    assert handle.path is None
    with trace_scoring(None, create_perfetto_link=True) as handle:
        pass
    assert handle.path is None


def test_env_directory_turns_it_on(monkeypatch, tmp_path):
    monkeypatch.setenv("FOREMAST_PROFILE", str(tmp_path / "prof"))
    with trace_scoring() as handle:
        with annotate("profile.region"):
            pass
    assert handle.path is not None and os.path.dirname(handle.path) == str(tmp_path / "prof")
    assert "profile.region" in {e.get("name") for e in _events(handle.path)}


def test_judge_pass_trace_holds_the_span_markers(tmp_path):
    with trace_scoring(str(tmp_path), create_perfetto_link=True) as handle:
        assert handle.path is None  # set when the region exits
        _judge(_task_kwargs())
    assert handle.path is not None and handle.path.endswith(".json")
    names = {e.get("name") for e in _events(handle.path)}
    for marker in MARKERS:
        assert marker in names, marker
    # a second region writes a second file
    with trace_scoring(str(tmp_path)) as again:
        pass
    assert again.path != handle.path and os.path.exists(again.path)


def test_results_unchanged_under_the_profiler(tmp_path):
    kws = _task_kwargs(seed=1)
    plain = _judge(kws)
    with trace_scoring(str(tmp_path)):
        profiled = _judge(kws)
    from foremast_tpu.models.cache import ModelCache as JaxCache

    jax_judge = jj.HealthJudge(JaxConfig())
    jax_judge.fit_cache = JaxCache(4 * len(kws))
    jax = jax_judge.judge([jj.MetricTask(**k) for k in kws])
    assert len(plain) == len(profiled) == len(jax) == len(kws)
    assert len({v.verdict for v in plain}) >= 2  # healthy and anomalous rows both
    for a, b, j in zip(plain, profiled, jax):
        assert (a.job_id, a.verdict, a.anomaly_pairs, a.p_value) == (b.job_id, b.verdict, b.anomaly_pairs, b.p_value)
        np.testing.assert_array_equal(a.upper, b.upper)
        np.testing.assert_array_equal(a.lower, b.lower)
        assert a.verdict == j.verdict and a.anomaly_pairs == pytest.approx(list(j.anomaly_pairs), rel=1e-6)


def test_observe_exports_the_hooks():
    import foremast_tpu_torch.observe as obs

    assert obs.trace_scoring is trace_scoring and obs.annotate is annotate
    assert set(obs.__all__) == {"trace_scoring", "annotate"}


def test_worker_sweeps_write_a_trace_each_under_profile_env(monkeypatch, tmp_path):
    """`FOREMAST_PROFILE` on the worker: each sweep (`BrainWorker.tick`)
    is one `trace_scoring` region, so each writes one Chrome trace, and
    the cold sweep's trace holds the judge's markers."""
    from tests.torch_workers import worker_pair

    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")
    (_, _, _), (worker, _, _) = worker_pair(2)
    prof = tmp_path / "prof"
    monkeypatch.setenv("FOREMAST_PROFILE", str(prof))
    assert worker.tick() > 0
    first = sorted(os.listdir(prof))
    assert len(first) == 1 and first[0].endswith(".trace.json")
    names = {e.get("name") for e in _events(prof / first[0])}
    assert "judge.fit" in names and "judge.score" in names
    worker.tick()
    assert len(os.listdir(prof)) == 2
    monkeypatch.delenv("FOREMAST_PROFILE")
    worker.tick()
    assert len(os.listdir(prof)) == 2
