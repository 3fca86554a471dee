"""The port's worker on joint fleets against the JAX worker (CPU).

Mirrors tests/test_joint_fast_tick.py: a mixed fleet under `auto`
(`benchmarks.worker_bench.build_mixed_fleet(joint_frac=...)`: 2-alias
bivariate docs, 4-alias LSTM-hybrid docs, single-alias docs), copied into
the port's own store and source. The JAX worker ticks first; its trained
LSTM-AE entries (with their residual-MVN state) are carried into the
port's joint cache through `interop.joint_entry_from_numpy`, since two
trainings never give the same weights. Everything else — bivariate fits,
the univariate fallback, alignment, admission, the joint columnar path —
the port computes itself, and every doc's (status, code, reason,
anomaly_info) must equal the JAX worker's exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.worker_bench import build_mixed_fleet
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.jobs import BrainWorker as JaxWorker
from foremast_tpu_torch.chaos.degrade import REASON_DEMOTED
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.jobs import BrainWorker
from foremast_tpu_torch.jobs.models import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED
from foremast_tpu_torch.interop import joint_entry_from_numpy
from tests.torch_workers import PortArraySource, port_store, statuses

NOW = 1_760_000_000.0
HIST_LEN = 256
CUR_LEN = 30
SERVICES = 12  # 2 joint (job-0 bivariate, job-1 lstm) + 10 single-alias
STEPS = 10  # LSTM training steps (CI speed; the carried entries decide)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run loops of small tensor ops, where torch's intra-op
    thread pool adds nothing but contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    # the port runs only the monolithic tick
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _cfg(cls, algorithm: str):
    cfg = cls(algorithm=algorithm, season_steps=24, max_cache_size=4 * SERVICES + 64)
    # the joint detectors' calibrated threshold (the quality scenarios')
    return dataclasses.replace(cfg, anomaly=dataclasses.replace(cfg.anomaly, threshold=4.0))


def _pair(algorithm: str = "auto", joint_fast: bool = True, hooks=(None, None), joint_frac: float = 0.17):
    store, source, _ = build_mixed_fleet(SERVICES, HIST_LEN, CUR_LEN, NOW, joint_frac=joint_frac)
    pstore, psource = port_store(store), PortArraySource(source.data)
    kw = dict(claim_limit=2 * SERVICES, worker_id="joint-w")
    jw = JaxWorker(store, source, config=_cfg(JaxConfig, algorithm), on_verdict=hooks[0], device_mesh=None, **kw)
    pw = BrainWorker(pstore, psource, config=_cfg(BrainConfig, algorithm), device="cpu", on_verdict=hooks[1], **kw)
    jw.judge.lstm_steps = pw.judge.lstm_steps = STEPS
    if not joint_fast:
        pw._joint_fast = False
    return (jw, store, source), (pw, pstore, psource)


def _carry_lstm(jw, pw) -> int:
    """The JAX worker's trained LSTM entries -> the port worker's cache."""
    n = 0
    for key, entry in jw._mvj.cache.snapshot().items():
        if key[0] == "lstm":
            pw._mvj.cache.put(key, joint_entry_from_numpy(jax.tree.map(np.asarray, entry)))
            n += 1
    return n


def _cold(jw, pw, now=NOW + 150):
    assert jw.tick(now=now) == SERVICES
    _carry_lstm(jw, pw)
    assert pw.tick(now=now) == SERVICES


def _spike_joint(sources, sid: str, f: int):
    """Every metric of a joint service up 0.6 (~8 idiosyncratic sigmas)
    on its last 3 points, in every source."""
    for src in sources:
        for m in range(f):
            url = f"http://prom/cur?q=m{m}:app{sid}&step=60"
            ct, cv = src.data[url]
            spiked = cv.copy()
            spiked[-3:] += 0.6
            src.data[url] = (ct, spiked)


def test_joint_fast_path_engages_and_matches_object_path():
    """Cold tick on the object path, then a warm tick with the LSTM doc
    spiked: the port's joint columnar worker, the port's object-path
    worker and the JAX worker write the same statuses; the hook verdicts
    of the two port workers agree, bands within 1e-5 of each other."""
    got_a, got_b = {}, {}
    (jw, jstore, jsrc), (a, astore, asrc) = _pair(hooks=(None, lambda d, vs: got_a.__setitem__(d.id, vs)))
    _, (b, bstore, bsrc) = _pair(joint_fast=False, hooks=(None, lambda d, vs: got_b.__setitem__(d.id, vs)))
    assert jw.tick(now=NOW + 150) == SERVICES
    assert _carry_lstm(jw, a) == 1 and _carry_lstm(jw, b) == 1
    assert a.tick(now=NOW + 150) == SERVICES and b.tick(now=NOW + 150) == SERVICES
    assert statuses(astore) == statuses(jstore) == statuses(bstore)
    assert a._fast_kinds["bivariate"] == 0 and a._fast_kinds["lstm"] == 0

    _spike_joint((jsrc, asrc, bsrc), "1", 4)
    for w in (jw, a, b):
        assert w.tick(now=NOW + 200) == SERVICES
    sa = statuses(astore)
    assert sa == statuses(jstore) == statuses(bstore)
    assert sa["job-1"][0] == STATUS_COMPLETED_UNHEALTH
    assert sa["job-0"][0] == STATUS_PREPROCESS_COMPLETED
    assert a._fast_kinds == jw._fast_kinds
    assert a._fast_kinds["bivariate"] == 1 and a._fast_kinds["lstm"] == 1
    assert b._fast_kinds["bivariate"] == 0 and b._fast_kinds["lstm"] == 0
    assert a._mvj.joint_state_counters() == jw._mvj.joint_state_counters()
    assert set(a._mvj.cache._d) == set(b._mvj.cache._d) == set(jw._mvj.cache._d)
    assert set(a._mvj.joint_meta._d) == set(jw._mvj.joint_meta._d)
    for doc_id in ("job-0", "job-1"):
        for x, y in zip(got_a[doc_id], got_b[doc_id]):
            assert (x.alias, x.verdict, x.anomaly_pairs, x.p_value, x.dist_differs) == (
                y.alias, y.verdict, y.anomaly_pairs, y.p_value, y.dist_differs
            )
            np.testing.assert_allclose(x.upper, y.upper, rtol=1e-5)
            np.testing.assert_allclose(x.lower, y.lower, rtol=1e-5)


def test_joint_admission_revalidates_by_identity():
    """Unrelated churn bumps both joint cache versions: the admitted docs
    revalidate by identity (same jinfo object, restamped) and the warm
    tick gathers their arena rows instead of re-scattering them."""
    (jw, _, _), (a, _, _) = _pair()
    _cold(jw, a)
    a.tick(now=NOW + 160)
    assert len(a._jadmit) == 2
    token0 = {k: v[2] for k, v in a._jadmit.items()}
    jinfo0 = {k: v[1] for k, v in a._jadmit.items()}
    a._mvj.cache.put(("unrelated",), (1,))
    a._mvj.joint_meta.put(("unrelated-meta",), (1,))
    a.tick(now=NOW + 170)
    assert len(a._jadmit) == 2
    for k in a._jadmit:
        assert a._jadmit[k][2] != token0[k]
        assert a._jadmit[k][1] is jinfo0[k]
    assert a._mvj.joint_state_counters()["hits"] >= 2


def test_joint_fast_matches_slow_under_explicit_bivariate_algorithm():
    """bivariate_normal: the 2-alias doc rides the joint columnar path,
    the 4-alias doc and single-alias docs the univariate fallback; an
    off-ridge spike flags the bivariate doc as on the JAX worker."""
    (jw, jstore, jsrc), (a, astore, asrc) = _pair(algorithm="bivariate_normal")
    _cold(jw, a)
    for src in (jsrc, asrc):
        for url, delta in (("http://prom/cur?q=m0:app0&step=60", 1.0), ("http://prom/cur?q=m1:app0&step=60", -1.0)):
            ct, cv = src.data[url]
            s = cv.copy()
            s[-2:] += delta
            src.data[url] = (ct, s)
    assert jw.tick(now=NOW + 200) == SERVICES and a.tick(now=NOW + 200) == SERVICES
    assert statuses(astore) == statuses(jstore)
    assert statuses(astore)["job-0"][0] == STATUS_COMPLETED_UNHEALTH
    assert a._fast_kinds == jw._fast_kinds
    assert a._fast_kinds["bivariate"] == 1 and a._fast_kinds["univariate"] > 0


def test_joint_window_bucket_drift_demotes_to_slow_path():
    """The LSTM doc's current windows grow past the fitted 32-bucket:
    the port demotes it to the slow path (counted), refits, and writes
    what the JAX worker writes."""
    (jw, jstore, jsrc), (a, astore, asrc) = _pair()
    _cold(jw, a)
    for src in (jsrc, asrc):
        for m in range(4):
            url = f"http://prom/cur?q=m{m}:app1&step=60"
            ct, cv = src.data[url]
            src.data[url] = (
                np.concatenate([ct, ct[-1:] + 60 * np.arange(1, 4)]),
                np.concatenate([cv, cv[-3:]]).astype(np.float32),
            )
    before = a._degrade.stats.docs_snapshot().get(REASON_DEMOTED, 0)
    assert jw.tick(now=NOW + 200) == SERVICES
    # the refit at the new bucket trains on both sides: carry again
    _carry_lstm(jw, a)
    assert a.tick(now=NOW + 200) == SERVICES
    assert statuses(astore) == statuses(jstore)
    assert a._fast_kinds["lstm"] == 0
    assert a._degrade.stats.docs_snapshot().get(REASON_DEMOTED, 0) == before + 1


def test_joint_fast_disabled_by_env(monkeypatch):
    """FOREMAST_JOINT_COLUMNAR=0 keeps joint docs on the object path."""
    monkeypatch.setenv("FOREMAST_JOINT_COLUMNAR", "0")
    (jw, jstore, _), (a, astore, _) = _pair()
    assert not a._joint_fast and not jw._joint_fast
    _cold(jw, a)
    assert jw.tick(now=NOW + 200) == SERVICES and a.tick(now=NOW + 200) == SERVICES
    assert statuses(astore) == statuses(jstore)
    assert a._fast_kinds["bivariate"] == 0 and a._fast_kinds["lstm"] == 0


def test_debug_state_carries_joint_counters():
    """The joint arena's counters and the per-kind columnar counts in
    debug_state equal the JAX worker's."""
    (jw, _, _), (a, _, _) = _pair()
    _cold(jw, a)
    jw.tick(now=NOW + 200)
    a.tick(now=NOW + 200)
    state = a.debug_state()
    assert state["fast_path_docs"] == jw.debug_state()["fast_path_docs"]
    assert state["fast_path_docs"]["bivariate"] == 1 and state["fast_path_docs"]["lstm"] == 1
    want = jw._mvj.joint_state_counters()
    assert {k: state["joint_arena"][k] for k in want} == want
    assert state["joint_arena"]["rows_live"] == 2


@pytest.mark.parametrize("algorithm", ["bivariate_normal", "lstm_autoencoder", "auto"])
def test_each_joint_selector_ticks_like_jax(algorithm):
    """Every joint selector over a fleet of 4-alias docs with the port's
    OWN training (nothing carried): cold then warm ticks complete on
    every doc, and under bivariate_normal (every doc a metric-count
    misfit: the univariate fallback) the statuses equal the JAX
    worker's."""
    (jw, jstore, _), (a, astore, _) = _pair(algorithm=algorithm, joint_frac=0.0)
    assert a.tick(now=NOW + 150) == SERVICES
    assert a.tick(now=NOW + 200) == SERVICES
    if algorithm == "bivariate_normal":
        jw.tick(now=NOW + 150)
        jw.tick(now=NOW + 200)
        assert statuses(astore) == statuses(jstore)
    else:
        assert a._fast_kinds["lstm"] == SERVICES
