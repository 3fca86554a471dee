"""The port's joint detectors on the CPU against the JAX package's.

Seeded numpy inputs go through the JAX functions and their ports:
`hw_continue`, the residual-MVN fit (f32 and bf16-delta uploads) and its
robust d^2, the bivariate fit and detection, `TreeArena`, and
`MultivariateJudge.judge` on mixed `auto` fleets. Tolerances, with
their reasons:

  * Holt-Winters state and the continuation's predictions: rtol = atol =
    2e-4, as tests/test_torch_forecasters.py allows the recurrence (XLA
    may fuse multiply-adds, the port rounds every operation);
  * residual means and covariances: rtol 1e-4, atol 1e-6 of the
    covariance scale (10^4-term sums in another order);
  * d^2 on the same carried state: rtol 1e-4; bivariate moments 1e-5;
  * verdicts, flags and anomaly pairs: exact — bivariate and univariate
    jobs fitted by each engine itself, LSTM jobs scored from the JAX-
    trained entries carried into the port's cache (two trainings never
    give the same weights); the data keep every score away from its
    cutoff (checked);
  * the port's OWN training holds the quality gates of
    tests/test_benchmarks.py at `benchmarks.quality.main --small`'s joint
    size (16 jobs, 240-point histories, 30-point windows).
"""

from __future__ import annotations

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import prf1
from benchmarks.quality import PERIOD, draw_comoving, gen_correlated_pair, gen_joint_lstm
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import multivariate as jmv
from foremast_tpu.engine.judge import MetricTask as JaxTask
from foremast_tpu.models import bivariate as jbv
from foremast_tpu.models import residual_mvn as jrm
from foremast_tpu.ops import forecasters as jf
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import multivariate as mv
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.engine.arena import TreeArena, set_arena_budget
from foremast_tpu_torch.engine.judge import MetricTask
from foremast_tpu_torch.interop import joint_entry_from_numpy
from foremast_tpu_torch.models import bivariate as bv
from foremast_tpu_torch.models import residual_mvn as rm
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.ops import forecasters as tf

T0 = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run loops of small tensor ops, where torch's intra-op
    thread pool adds nothing but contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX's leaves are read-only)


# ---------------------------------------------------------------------------
# hw_continue
# ---------------------------------------------------------------------------


def _hw_state(rng, b, m, phase_wrap=True):
    level = rng.normal(1.0, 0.3, b).astype(np.float32)
    trend = rng.normal(0.0, 0.01, b).astype(np.float32)
    season = rng.normal(0.0, 0.2, (b, m)).astype(np.float32)
    phase = ((m - 2) + np.arange(b)) % m if phase_wrap else np.zeros(b)
    return level, trend, season, phase.astype(np.int32)


@pytest.mark.parametrize("m,season_length", [(24, 24), (1, 1), (1, 24), (7, 7), (48, 48), (30, 30)],
                         ids=["m24", "m1", "nonseasonal", "m7", "m48", "m30"])
def test_hw_continue_matches_jax(m, season_length):
    """Masked steps carry the state and still advance the phase, phases
    wrap, m = 1, a non-seasonal state (season width 1) continued at
    m = 24 against zero offsets; seasons at least the window long (m48,
    m30) take the gathered-offsets loop, which equals the general one
    bit for bit."""
    rng = np.random.default_rng(m * 10 + season_length)
    b, t_len = 9, 30
    level, trend, season, phase = _hw_state(rng, b, m)
    vals = (level[:, None] + rng.normal(0, 0.3, (b, t_len))).astype(np.float32)
    mask = rng.random((b, t_len)) > 0.3
    mask[0] = False
    zb = np.zeros(b, np.float32)
    jfc = jf.Forecast(pred=jnp.zeros((b, 0)), scale=jnp.asarray(zb), level=jnp.asarray(level),
                      trend=jnp.asarray(trend), season=jnp.asarray(season), season_phase=jnp.asarray(phase))
    tfc = tf.Forecast(pred=torch.zeros((b, 0)), scale=_t(zb), level=_t(level), trend=_t(trend),
                      season=_t(season), season_phase=_t(phase))
    jp, jout = jf.hw_continue(jfc, jnp.asarray(vals), jnp.asarray(mask), season_length)
    tp, tout = tf.hw_continue(tfc, _t(vals), _t(mask), season_length)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-4, atol=2e-4)
    for name in ("level", "trend", "season"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tout.season_phase.numpy(), np.asarray(jout.season_phase))
    if m >= t_len:
        f32 = lambda p: torch.full((), p)  # noqa: E731
        ps = [f32(p) for p in (0.3, 0.05, 0.1)]
        ps += [1.0 - p for p in ps]
        season2 = _t(season)
        lp, ll, lt = tf._hw_continue_steps(_t(vals), _t(mask), season2, _t(level), _t(trend), _t(phase).long(),
                                           m, ps)
        assert torch.equal(lp, tp) and torch.equal(ll, tout.level) and torch.equal(lt, tout.trend)
        assert torch.equal(season2, tout.season)


# ---------------------------------------------------------------------------
# residual MVN
# ---------------------------------------------------------------------------


def _joint_hist(b, f, th, period=PERIOD, seed=3, short=()):
    """[B, F, Th] co-moving histories with a valid-prefix mask; rows in
    `short` end early."""
    rng = np.random.default_rng(seed)
    hist = draw_comoving(rng, b, f, th, 0, period)
    mask = np.ones((b, th), bool)
    for i, n in short:
        mask[i, n:] = False
    hist = np.where(mask[:, None, :], hist, 0.0).astype(np.float32)
    return hist, mask


def _assert_mvn(got, want):
    n = got.hw.level.shape[0]
    for name in ("level", "trend", "season"):
        np.testing.assert_allclose(getattr(got.hw, name).numpy(), np.asarray(getattr(want.hw, name)), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_array_equal(got.hw.season_phase.numpy(), np.asarray(want.hw.season_phase))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-4, atol=1e-5)
    cov = np.asarray(want.cov)
    scale = np.abs(cov).max()
    np.testing.assert_allclose(got.cov.numpy(), cov, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert n == got.mu.shape[0] * got.mu.shape[1]


@pytest.mark.parametrize("th,season,short", [(256, 24, ((1, 100),)), (64, 24, ()), (512, 1, ((2, 9),))],
                         ids=["m24-ragged", "m24-two-seasons", "m1-short-partition"])
def test_fit_residual_mvn_matches_jax(th, season, short):
    """The f32 fit at m = 24 (ragged rows; a batch just over two seasons)
    and at m = 1 explicitly — the judge's partition of short histories,
    whose padded bucket may exceed 2m; a row below min_points is invalid
    on both sides."""
    hist, mask = _joint_hist(4, 3, th, short=short)
    want = jrm.fit_residual_mvn(jnp.asarray(hist), jnp.asarray(mask), season_length=season)
    got = rm.fit_residual_mvn(_t(hist), _t(mask), season_length=season)
    _assert_mvn(got, want)


def test_fit_residual_mvn_static_length_guard():
    """A batch whose padded length holds fewer than two seasons fits at
    m = 1 on both sides, whatever season is asked for."""
    hist, mask = _joint_hist(3, 2, 40, short=((0, 30),))
    want = jrm.fit_residual_mvn(jnp.asarray(hist), jnp.asarray(mask), season_length=24)
    got = rm.fit_residual_mvn(_t(hist), _t(mask), season_length=24)
    assert got.hw.season.shape[-1] == 1
    _assert_mvn(got, want)


def test_fit_residual_mvn_bf16_delta_matches_jax():
    """The bf16-delta upload: the port's pack (torch's round-to-nearest
    cast) equals ml_dtypes' bit for bit, and the fit from it JAX's."""
    hist, mask = _joint_hist(4, 3, 256, short=((1, 200),))
    ja, jd = jmv._pack_bf16_delta_rows(hist, mask[:, None, :])
    pa, pd = mv._pack_bf16_delta_rows(hist, mask[:, None, :])
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pd.float().numpy(), np.asarray(jd, np.float32))
    want = jrm.fit_residual_mvn_bf16_delta(jnp.asarray(ja), jnp.asarray(jd), jnp.asarray(mask), season_length=24)
    got = rm.fit_residual_mvn_bf16_delta(_t(pa), pd, _t(mask), season_length=24)
    _assert_mvn(got, want)


def test_residual_mvn_d2_robust_matches_jax():
    """The two-pass robust d^2 and the flags of `score_residual_mvn`, from
    the JAX-fitted state carried over: rtol 1e-4, flags exact."""
    hist, mask = _joint_hist(5, 4, 240, seed=8)
    st = jrm.fit_residual_mvn(jnp.asarray(hist), jnp.asarray(mask), season_length=24)
    cur = draw_comoving(np.random.default_rng(9), 5, 4, 30, 240)
    cur[:, :, 7] += 0.6  # a spike: its echo is what pass 2 removes
    cur[2, 1, 12] -= 0.6
    leaves = jax.tree.map(np.asarray, st)
    port_state = rm.MVNState(
        hw=tf.Forecast(*(_t(getattr(leaves.hw, k)) for k in ("pred", "scale", "level", "trend", "season",
                                                               "season_phase"))),
        mu=_t(leaves.mu), cov=_t(leaves.cov), valid=_t(leaves.valid),
    )
    gate = np.full(5, jrm.chi2_quantile(4.0, 4), np.float32)
    want = np.asarray(jrm.residual_mvn_d2_robust(st, jnp.asarray(cur), jnp.asarray(gate)))
    got = rm.residual_mvn_d2_robust(port_state, _t(cur), _t(gate)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not (np.abs(want - gate[:, None]) <= 1e-3 * gate[:, None]).any()
    np.testing.assert_array_equal(
        rm.score_residual_mvn(port_state, _t(cur), float(gate[0])).numpy(),
        np.asarray(jrm.score_residual_mvn(st, jnp.asarray(cur), float(gate[0]))),
    )


# ---------------------------------------------------------------------------
# bivariate
# ---------------------------------------------------------------------------


def test_bivariate_fit_and_detection_match_jax():
    hist, cur, _ = gen_correlated_pair(12, 300, 30, seed=4)
    hm = np.ones((12, 300), bool)
    hm[3, 5:] = False  # under min_points: invalid on both sides
    hm[4, 150:] = False
    hist = np.where(hm[:, None, :], hist, 0.0).astype(np.float32)
    cm = np.ones((12, 30), bool)
    cm[5, 20:] = False
    want = jbv.fit_bivariate(jnp.asarray(hist[:, 0]), jnp.asarray(hist[:, 1]), jnp.asarray(hm))
    got = bv.fit_bivariate(_t(hist[:, 0]), _t(hist[:, 1]), _t(hm))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    thr = np.linspace(2.0, 4.0, 12).astype(np.float32)
    d2 = np.asarray(jbv.mahalanobis2(want, jnp.asarray(cur[:, 0]), jnp.asarray(cur[:, 1])))
    assert not (np.abs(d2 - thr[:, None] ** 2) <= 1e-4 * thr[:, None] ** 2).any()
    jflags = jbv.detect_bivariate(want, jnp.asarray(cur[:, 0]), jnp.asarray(cur[:, 1]), jnp.asarray(cm), jnp.asarray(thr))
    pflags = bv.detect_bivariate(got, _t(cur[:, 0]), _t(cur[:, 1]), _t(cm), _t(thr))
    np.testing.assert_array_equal(pflags.numpy(), np.asarray(jflags))
    # bf16-delta fit and the arena-row detection
    ja, jd = jmv._pack_bf16_delta_rows(hist, hm[:, None, :])
    pa, pd = mv._pack_bf16_delta_rows(hist, hm[:, None, :])
    wb = jbv.fit_bivariate_bf16_delta(jnp.asarray(ja[:, 0]), jnp.asarray(jd[:, 0]), jnp.asarray(ja[:, 1]),
                                      jnp.asarray(jd[:, 1]), jnp.asarray(hm))
    gb = bv.fit_bivariate_bf16_delta(_t(pa[:, 0]), pd[:, 0], _t(pa[:, 1]), pd[:, 1], _t(hm))
    np.testing.assert_allclose(gb.cov.numpy(), np.asarray(wb.cov), rtol=1e-5, atol=1e-9)
    rows = np.array([2, 2, 0, 7, 11, 2, 1, 8, 9, 10, 6, 0])
    jr = jbv.detect_bivariate_from_rows(want.mean, want.cov, jnp.asarray(rows), jnp.asarray(cur[:, 0]),
                                        jnp.asarray(cur[:, 1]), jnp.asarray(cm), jnp.asarray(thr))
    pr = bv.detect_bivariate_from_rows(got.mean, got.cov, _t(rows), _t(cur[:, 0]), _t(cur[:, 1]), _t(cm), _t(thr))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# MultivariateJudge against the JAX judge
# ---------------------------------------------------------------------------


def _cfgs(algorithm, threshold=4.0, **kw):
    out = []
    for cls in (JaxConfig, BrainConfig):
        c = cls(algorithm=algorithm, season_steps=PERIOD, **kw)
        out.append(dataclasses.replace(c, anomaly=dataclasses.replace(c.anomaly, threshold=threshold, rules=())))
    return out


def _tasks(cls, hist, cur, prefix, base=None, t0=T0):
    b, f, th = hist.shape
    tc = cur.shape[-1]
    ht = t0 + 60 * np.arange(th, dtype=np.int64)
    ct = t0 + 60 * (th + np.arange(tc, dtype=np.int64))
    bt = t0 - 60 * np.arange(tc, 0, -1, dtype=np.int64)
    return [
        cls(job_id=f"{prefix}{i}", alias=f"m{j}", metric_type=None, hist_times=ht, hist_values=hist[i, j],
            cur_times=ct, cur_values=cur[i, j], app=f"{prefix}{i}",
            **({} if base is None else dict(base_times=bt, base_values=base[i, j])))
        for i in range(b) for j in range(f)
    ]


def _carry(jj, pj) -> int:
    n = 0
    for key, entry in jj.cache.snapshot().items():
        if key[0] == "lstm":
            pj.cache.put(key, joint_entry_from_numpy(jax.tree.map(np.asarray, entry)))
            n += 1
    return n


def _same_verdicts(got, want):
    key = lambda v: (v.job_id, v.alias)  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [key(v) for v in got] == [key(v) for v in want]
    for a, b in zip(got, want):
        assert (a.verdict, a.anomaly_pairs, a.dist_differs) == (b.verdict, b.anomaly_pairs, b.dist_differs), key(a)
        assert a.p_value == pytest.approx(b.p_value, rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(a.upper, b.upper, rtol=1e-5)
        np.testing.assert_allclose(a.lower, b.lower, rtol=1e-5)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_mixed_auto_fleet_matches_jax(bf16):
    """`auto` over bivariate, LSTM (3 and 4 metrics) and univariate jobs,
    half the bivariate ones canaries: verdicts, flags and pairs exact."""
    scoring.set_bf16_delta(bf16)
    try:
        hb, cb, _ = gen_correlated_pair(6, 240, 30, seed=3)
        base_b = gen_correlated_pair(6, 240, 30, seed=33)[1]
        base_b[:3] += 0.5  # a shifted baseline lowers the threshold
        hl, cl, _ = gen_joint_lstm(5, 4, 240, 30, seed=4)
        h3, c3, _ = gen_joint_lstm(3, 3, 240, 20, seed=6, kind="break")
        rng = np.random.default_rng(5)
        hu, cu = draw_comoving(rng, 4, 1, 240, 0), draw_comoving(rng, 4, 1, 30, 240)
        jc, pc = _cfgs("auto")
        jj, pj = jmv.MultivariateJudge(jc), mv.MultivariateJudge(pc, device="cpu")
        jj.lstm_steps = pj.lstm_steps = 10

        def fleet(cls):
            return (_tasks(cls, hb[:3], cb[:3], "c", base=base_b[:3]) + _tasks(cls, hb[3:], cb[3:], "b")
                    + _tasks(cls, hl, cl, "l") + _tasks(cls, h3, c3, "k") + _tasks(cls, hu, cu, "u"))

        want = jj.judge(fleet(JaxTask))
        assert _carry(jj, pj) == 8
        got = pj.judge(fleet(MetricTask))
        _same_verdicts(got, want)
        assert {v.verdict for v in got} == {scoring.HEALTHY, scoring.UNHEALTHY}
        assert any(v.dist_differs for v in got)
        # the warm path's state: the same joint keys on both sides
        assert set(pj.cache._d) == set(jj.cache._d)
        assert set(pj.joint_meta._d) == set(jj.joint_meta._d)
    finally:
        scoring.set_bf16_delta(None)


def _quality_prf(judge, hist, cur, truth, prefix):
    verdicts = judge.judge(_tasks(MetricTask, hist, cur, prefix))
    tc = cur.shape[-1]
    ct = T0 + 60 * (hist.shape[-1] + np.arange(tc, dtype=np.int64))
    flagged: dict[str, set] = {}
    for v in verdicts:
        flagged.setdefault(v.job_id, set()).update(v.anomaly_pairs[0::2])
    tp = fp = fn = 0
    for i in range(hist.shape[0]):
        got = flagged.get(f"{prefix}{i}", set())
        want = {float(t) for t, a in zip(ct, truth[i]) if a}
        tp += len(got & want)
        fp += len(got - want)
        fn += len(want - got)
    return prf1(tp, fp, fn), verdicts


def test_port_training_holds_the_joint_quality_gates():
    """The port's own LSTM training (60 steps, seed 0) and bivariate fit
    at `quality.main --small`'s joint size hold tests/test_benchmarks.py's
    gates: bivariate F1 >= 0.9, LSTM hybrid precision >= 0.95 and recall
    >= 0.98 on all-metric spikes and correlation breaks, and no clean
    job flagged."""
    jb, th, tc = 16, 240, 30
    _, bi_cfg = _cfgs("bivariate_normal")
    _, ls_cfg = _cfgs("lstm_autoencoder")
    hist, cur, truth = gen_correlated_pair(jb, th, tc)
    (p, r, f1), _ = _quality_prf(mv.MultivariateJudge(bi_cfg, device="cpu"), hist, cur, truth, "bivariate")
    assert f1 >= 0.9, (p, r, f1)
    for kind in ("all", "break"):
        hist, cur, truth = gen_joint_lstm(jb, 4, th, tc, kind=kind)
        (p, r, f1), _ = _quality_prf(mv.MultivariateJudge(ls_cfg, device="cpu"), hist, cur, truth, kind)
        assert p >= 0.95 and r >= 0.98, (kind, p, r)
    rng = np.random.default_rng(7)
    hist, cur = draw_comoving(rng, jb, 4, th, 0), draw_comoving(rng, jb, 4, tc, th)
    verdicts = mv.MultivariateJudge(ls_cfg, device="cpu").judge(_tasks(MetricTask, hist, cur, "clean"))
    assert not {v.job_id for v in verdicts if v.verdict == scoring.UNHEALTHY}


# ---------------------------------------------------------------------------
# counterparts of tests/test_multivariate.py
# ---------------------------------------------------------------------------


def _task(job, alias, hist_v, cur_v, base_v=None, t0=T0, step=60, app=""):
    hist_t = t0 + step * np.arange(len(hist_v), dtype=np.int64)
    cur_t = t0 + step * (len(hist_v) + np.arange(len(cur_v), dtype=np.int64))
    base = {}
    if base_v is not None:
        base = dict(base_times=t0 - step * np.arange(len(base_v), 0, -1, dtype=np.int64),
                    base_values=np.asarray(base_v, np.float32))
    return MetricTask(job_id=job, alias=alias, metric_type=None, hist_times=hist_t,
                      hist_values=np.asarray(hist_v, np.float32), cur_times=cur_t,
                      cur_values=np.asarray(cur_v, np.float32), app=app, **base)


@pytest.mark.parametrize("algorithm,n,mode", [
    ("auto", 1, "univariate"), ("auto", 2, "bivariate"), ("auto", 3, "lstm"), ("auto", 4, "lstm"),
    ("bivariate_normal", 2, "bivariate"), ("bivariate_normal", 3, "univariate"),
    ("lstm_autoencoder", 2, "lstm"), ("lstm_autoencoder", 1, "univariate"), ("moving_average_all", 5, "univariate"),
])
def test_select_mode_rule(algorithm, n, mode):
    assert mv.select_mode(algorithm, n) == mode == jmv.select_mode(algorithm, n)


def test_fallback_algorithms_and_default_steps():
    assert mv.MultivariateJudge(BrainConfig(algorithm="auto"), device="cpu").univariate.config.algorithm == (
        "auto_univariate")
    judge = mv.MultivariateJudge(BrainConfig(algorithm="bivariate_normal"), device="cpu")
    assert judge.univariate.config.algorithm == "moving_average_all"
    assert judge.lstm_steps == 60


def test_lstm_short_history_gates_to_unknown():
    """A history under two windows of the job's bucket stays UNKNOWN and
    caches nothing; just past the floor it judges (clean: not unhealthy)."""
    rng = np.random.default_rng(11)
    cur = rng.normal(0.5, 0.05, size=(3, 12)).astype(np.float32)
    _, cfg = _cfgs("lstm_autoencoder")
    judge = mv.MultivariateJudge(cfg, device="cpu")
    judge.lstm_steps = 30
    short = rng.normal(0.5, 0.05, size=(3, 30)).astype(np.float32)
    vs = judge.judge([_task("s", f"m{i}", short[i], cur[i]) for i in range(3)])
    assert len(vs) == 3 and all(v.verdict == scoring.UNKNOWN for v in vs)
    assert len(judge.cache) == 0
    ok = rng.normal(0.5, 0.05, size=(3, 64)).astype(np.float32)
    vs2 = judge.judge([_task("k", f"m{i}", ok[i], cur[i]) for i in range(3)])
    assert all(v.verdict not in (scoring.UNKNOWN, scoring.UNHEALTHY) for v in vs2)


def test_lstm_cache_is_per_app_and_survives_mid_batch_eviction():
    """Two apps with one alias set train two models; with max_cache_size
    1 a batch of both still scores every job."""
    rng = np.random.default_rng(4)
    hist = rng.normal(0.5, 0.05, size=(3, 240)).astype(np.float32)
    cur = rng.normal(0.5, 0.05, size=(3, 12)).astype(np.float32)
    judge = mv.MultivariateJudge(BrainConfig(algorithm="lstm_autoencoder"), device="cpu")
    judge.lstm_steps = 5
    judge.judge([_task("ja", f"m{i}", hist[i], cur[i], app="app-a") for i in range(3)])
    judge.judge([_task("jb", f"m{i}", hist[i], cur[i], app="app-b") for i in range(3)])
    assert len(judge.cache) == 2
    small = mv.MultivariateJudge(dataclasses.replace(BrainConfig(algorithm="lstm_autoencoder"), max_cache_size=1),
                                 device="cpu")
    small.lstm_steps = 5
    tasks = [_task(j, f"m{i}", hist[i], cur[i], app=j) for j in ("j1", "j2") for i in range(3)]
    assert len(small.judge(tasks)) == 6


def test_lstm_cache_warm_restart_via_checkpoint(tmp_path):
    """`ModelCache.save` -> `load` in a fresh judge scores WITHOUT
    retraining (the torch checkpoint restores NamedTuples as tuples) and
    reproduces the in-memory model's judgment."""
    rng = np.random.default_rng(7)
    hist = rng.normal(0.5, 0.05, size=(3, 240)).astype(np.float32)
    cur = rng.normal(0.5, 0.05, size=(3, 12)).astype(np.float32)
    cur[:, 6] = 10.0
    cfg = BrainConfig(algorithm="lstm_autoencoder")
    judge = mv.MultivariateJudge(cfg, device="cpu")
    judge.lstm_steps = 20
    ref = judge.judge([_task("j1", f"m{i}", hist[i], cur[i]) for i in range(3)])
    assert all(v.verdict == scoring.UNHEALTHY for v in ref)
    path = str(tmp_path / "ck.pt")
    judge.cache.save(path)
    cache2 = ModelCache()
    assert cache2.load(path, key_parser=ast.literal_eval) == 1
    judge2 = mv.MultivariateJudge(cfg, cache=cache2, device="cpu")
    judge2.lstm_steps = 10**9  # would hang if training ran
    got = judge2.judge([_task("j2", f"m{i}", hist[i], cur[i]) for i in range(3)])
    for a, b in zip(ref, got):
        assert (a.verdict, a.anomaly_pairs) == (b.verdict, b.anomaly_pairs)
    assert isinstance(cache2.peek(next(iter(cache2._d)))[0], mv.AEParams)  # coerced once


def test_lstm_mvn_refits_for_new_deployment_history():
    """The cached residual-MVN state is time-anchored: a redeploy 12
    steps later (anti-phase to the cached fit) refits and stays healthy."""
    f, th, tc = 3, 240, 24
    _, cfg = _cfgs("lstm_autoencoder")
    judge = mv.MultivariateJudge(cfg, device="cpu")
    judge.lstm_steps = 20

    def tasks(job, t0_steps, seed):
        r = np.random.default_rng(seed)
        hist = draw_comoving(r, 1, f, th, t0_steps)[0]
        cur = draw_comoving(r, 1, f, tc, t0_steps + th)[0]
        return [_task(job, f"m{i}", hist[i], cur[i], t0=T0 + 60 * t0_steps, app="svc") for i in range(f)]

    assert all(v.verdict == scoring.HEALTHY for v in judge.judge(tasks("d1", 0, 5)))
    anchor = judge.cache.peek(next(iter(judge.cache._d)))[3][7]
    assert all(v.verdict == scoring.HEALTHY for v in judge.judge(tasks("d2", 12, 6)))
    assert judge.cache.peek(next(iter(judge.cache._d)))[3][7] == anchor + 60 * 12


def test_canary_threshold_lowering_matches_jax():
    """Bivariate canary: a shifted baseline lowers the joint threshold
    and the pinned window flags; a same-distribution baseline does not;
    an LSTM job reports per-alias pairwise evidence. As the JAX judge."""
    rng = np.random.default_rng(10)
    hx, hy = rng.normal(1.0, 0.2, 400).astype(np.float32), rng.normal(2.0, 0.3, 400).astype(np.float32)
    cx = (np.full(24, 1.2) + rng.normal(0, 0.01, 24)).astype(np.float32)
    cy = (np.full(24, 2.3) + rng.normal(0, 0.01, 24)).astype(np.float32)
    bx, by = rng.normal(1.0, 0.2, 24).astype(np.float32), rng.normal(2.0, 0.3, 24).astype(np.float32)
    jc, pc = _cfgs("bivariate_normal", threshold=2.0)
    got = mv.MultivariateJudge(pc, device="cpu").judge(
        [_task("j1", "a", hx, cx), _task("j1", "b", hy, cy), _task("j2", "a", hx, cx, bx), _task("j2", "b", hy, cy, by)])
    jt = [JaxTask(**{k: getattr(t, k) for k in ("job_id", "alias", "metric_type", "hist_times", "hist_values",
                                                "cur_times", "cur_values", "base_times", "base_values", "app")})
          for t in [_task("j1", "a", hx, cx), _task("j1", "b", hy, cy), _task("j2", "a", hx, cx, bx),
                    _task("j2", "b", hy, cy, by)]]
    want = jmv.MultivariateJudge(jc).judge(jt)
    _same_verdicts(got, want)
    by_job = {v.job_id: v for v in got}
    assert by_job["j1"].verdict == scoring.HEALTHY and by_job["j2"].verdict == scoring.UNHEALTHY
    assert by_job["j2"].dist_differs and not by_job["j1"].dist_differs


# ---------------------------------------------------------------------------
# TreeArena
# ---------------------------------------------------------------------------


def test_tree_arena_bookkeeping():
    """Rows scatter by key, re-used keys hit, a replaced entry is forced,
    the row gather returns what was scattered, growth keeps rows, and
    the counters follow RowArena's; sharded over a mesh, each leaf is one
    block a device and a scattered row reads back from its block."""
    judge = mv.MultivariateJudge(BrainConfig(algorithm="auto"), device="cpu")
    tmpl = judge._lstm_template(3, 4)
    arena = TreeArena(tmpl, device="cpu")
    # f32 AE leaves, level, trend, season, rmu, cov; int32 phase; bool valid
    assert arena.row_bytes == 4 * (2 * (3 * 128 + 32 * 128 + 128) + 32 * 3 + 3 + 3 + 3 + 12 + 3 + 9) + 4 * 3 + 1

    def tree(seed):
        r = np.random.default_rng(seed)
        leaf = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
        cell = lambda: mv.LSTMParams(leaf(3, 128), leaf(32, 128), leaf(128))  # noqa: E731
        return {"ae": mv.AEParams(cell(), cell(), leaf(32, 3), leaf(3)), "level": leaf(3), "trend": leaf(3),
                "season": leaf(3, 4), "phase": np.arange(3, dtype=np.int32) + seed, "rmu": leaf(3),
                "cov": leaf(3, 3), "valid": np.bool_(seed % 2)}

    keys = [f"k{i}" for i in range(5)]
    trees = [tree(i) for i in range(5)]
    rows, scat = arena.assign(keys, [], 5)
    assert scat == list(range(5))
    arena.scatter(rows, scat, trees)
    got = arena.state["ae"].enc.w_h.index_select(0, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.stack([t["ae"].enc.w_h for t in trees]))
    np.testing.assert_array_equal(arena.state["valid"][torch.from_numpy(rows)].numpy(), [t["valid"] for t in trees])
    rows2, scat2 = arena.assign(keys[:3] + ["k9"], [1], 4)
    assert list(rows2[:3]) == list(rows[:3]) and scat2 == [1, 3]
    c = arena.counters()
    assert (c["hits"], c["misses"], c["rows_live"], c["capacity_rows"]) == (2, 7, 6, 64)
    before = arena.state["rmu"].clone()
    arena._ensure_capacity(100)  # pow2 growth keeps every row
    assert arena.cap == 128 and torch.equal(arena.state["rmu"][:64], before)
    from foremast_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(n_data=2, devices=["cpu"] * 2)
    sharded = TreeArena(tmpl, shards=2, device="cpu", sharding=meshlib.data_sharding(mesh, 1))
    rows, scat = sharded.assign(keys[:4], [], 4)
    sharded.scatter(rows, scat, trees[:4])
    w_h = sharded.state["ae"].enc.w_h
    assert w_h.parts[0] is w_h.parts[1] and w_h.parts[0].shape[0] == 2 * sharded.cap_s  # the CPU's buffer
    for i, (r, d) in enumerate(zip(rows, sharded.device_rows(rows))):
        assert int(r) // sharded.cap_s == i // 2
        np.testing.assert_array_equal(w_h.parts[i // 2][d].numpy(), trees[i]["ae"].enc.w_h)


def test_joint_arena_fallback_and_budget():
    """With arenas disabled (budget 0) the joint columnar path stacks the
    state per call and gives the same flags as through the arena."""
    hb, cb, _ = gen_correlated_pair(4, 240, 30, seed=3)
    _, pc = _cfgs("bivariate_normal")
    out = []
    for budget in (None, 0):
        set_arena_budget(budget, None)
        try:
            judge = mv.MultivariateJudge(pc, device="cpu")
            tasks = _tasks(MetricTask, hb, cb, "b")
            for t in tasks:
                t.fit_key = f"{t.job_id}|{t.alias}"
            judge.judge(tasks)
            peeks = [judge.columnar_joint_peek("bivariate", f"b{i}", ("m0", "m1"), (f"b{i}|m0", f"b{i}|m1"))
                     for i in range(4)]
            keys, entries, metas = zip(*[(p[0], p[1], p[3]) for p in peeks])
            out.append(judge.joint_columnar("bivariate", list(keys), list(entries), list(metas), cb,
                                            np.ones((4, 30), bool)))
            if budget == 0:
                assert judge._joint_arenas == {}
        finally:
            set_arena_budget(None, None)
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0].any()
