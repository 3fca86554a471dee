"""The port's brain worker against the JAX worker on the same fleet: the
monolithic fleet tick, cold then warm, through the columnar fast tick
(baseline-less and canary buckets) and the chunked object path.

Both workers tick the same documents and series (`tests/torch_workers.py`).
Statuses, status codes, reasons and `anomaly_info` are equal exactly (the
anomaly pairs are input timestamps and values); hook verdicts, flags and
`dist_differs` are exact, bands within `BAND_TOL` (1e-5 for the
bf16-delta cold fit, 1e-4 for f32) and p-values within 1e-5; arena
counters are equal. Modeled on `tests/test_fast_tick.py`.

Run alone: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_worker.py -q
"""

import numpy as np
import pytest

from foremast_tpu_torch.engine.judge import MetricVerdict
from foremast_tpu_torch.jobs import (
    STATUS_COMPLETED_UNHEALTH,
    STATUS_PREPROCESS_COMPLETED,
)
from tests.torch_fleet import BAND_TOL, bf16_gate
from tests.torch_workers import (
    CUR_LEN,
    HIST_LEN,
    NOW,
    assert_same_hook_records,
    count_columnar,
    force_slow,
    hook_recorder,
    seasonal_series,
    spike,
    statuses,
    worker_pair,
)


@pytest.fixture(autouse=True)
def _monolithic(monkeypatch):
    """Both workers run the monolithic tick (the JAX worker's parity arm
    of its sliced sweeps; the port has only this one)."""
    monkeypatch.setenv("FOREMAST_SWEEP_SLICE_DOCS", "0")


def _same_state(jax_worker, port) -> None:
    assert port._uni.device_state_counters() == jax_worker._uni.device_state_counters()
    for kind in ("univariate", "baseline"):
        assert port._fast_kinds[kind] == jax_worker._fast_kinds[kind]


@pytest.mark.parametrize("port_path", ["columnar", "object"])
def test_cold_then_warm_tick_matches_jax(port_path):
    """Tick 1 is cold (object path: fit, cache, scatter) on both; tick 2
    takes the columnar path on the JAX worker and, in the "columnar"
    case, on the port too — the "object" case holds the port's forced
    object path to the JAX fast tick. A spike carried to anomaly_info."""
    services = 6
    (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(services)
    jcalls, pcalls = count_columnar(jw), count_columnar(pw)
    if port_path == "object":
        force_slow(pw)

    assert jw.tick(now=NOW + 150) == services
    assert pw.tick(now=NOW + 150) == services
    assert not jcalls and not pcalls, "the cold tick must not take the fast path"
    assert statuses(pstore) == statuses(jstore)
    _same_state(jw, pw)

    spike((jsrc, psrc), "http://prom/cur", "latency:app3&")
    assert jw.tick(now=NOW + 200) == services
    assert pw.tick(now=NOW + 200) == services
    assert jcalls
    assert bool(pcalls) == (port_path == "columnar")
    got = statuses(pstore)
    assert got == statuses(jstore)
    assert got["job-3"][0] == STATUS_COMPLETED_UNHEALTH
    assert list(got["job-3"][3]["values"]) == ["latency"]
    assert all(s[0] == STATUS_PREPROCESS_COMPLETED for k, s in got.items() if k != "job-3")
    if port_path == "columnar":
        _same_state(jw, pw)
        assert pw._fast_kinds["univariate"] == services


@pytest.mark.parametrize("band_mode,band_len", [("full", CUR_LEN), ("last", 1)])
def test_hook_bands_match_jax_on_cold_and_warm_ticks(band_mode, band_len):
    """band_mode="full" hands hooks the whole [Tc] band on cold AND warm
    ticks; "last" a length-1 band. Every hook verdict equals the JAX
    worker's (bands within the bf16-delta tolerance)."""
    jrec, prec = [], []
    (jw, _, _), (pw, _, _) = worker_pair(
        3, band_mode=band_mode, hooks=(hook_recorder(jrec), hook_recorder(prec))
    )
    pcalls = count_columnar(pw)
    for now in (NOW + 150, NOW + 200):
        jw.tick(now=now)
        pw.tick(now=now)
    assert pcalls, "the warm tick should engage the fast path"
    assert prec and all(len(r[4]) == band_len for r in prec)
    assert_same_hook_records(prec, jrec)


def _row_by_row_verdicts(packed, res) -> dict:
    """doc id -> the hook's verdicts built row by row off a decoded
    columnar result (numpy scalar reads, a band slice and an anomaly
    search per row): the reference for the worker's column-wise build."""
    v8, anoms, ub, lb, ps, difs = res
    nz_r, nz_c = np.nonzero(anoms)
    empty = np.zeros(0, np.float32)
    out, a = {}, 0
    for (doc, _end, rowsinfo, _ops), s in packed.ok_items:
        vs = []
        for k2, (row, (ct, cv)) in enumerate(zip(rowsinfo, s)):
            r = a + k2
            n = min(len(cv), packed.tc)
            if not n:
                up = lo = empty
            elif ub.ndim == 2:
                up, lo = ub[r, :n], lb[r, :n]
            else:
                up, lo = ub[r : r + 1], lb[r : r + 1]
            cols = nz_c[np.searchsorted(nz_r, r) : np.searchsorted(nz_r, r, side="right")]
            pairs = []
            if len(cols):
                flat = np.empty(2 * len(cols), np.float64)
                flat[0::2] = np.asarray(ct)[cols]
                flat[1::2] = np.asarray(cv)[cols]
                pairs = flat.tolist()
            vs.append(MetricVerdict(
                job_id=doc.id, alias=row[0], verdict=int(v8[r]), anomaly_pairs=pairs, upper=up, lower=lo,
                p_value=float(ps[r]) if ps is not None else 1.0,
                dist_differs=bool(difs[r]) if difs is not None else False,
            ))
        out[doc.id] = vs
        a += len(s)
    return out


@pytest.mark.parametrize("band_mode", ["last", "full"])
@pytest.mark.parametrize("baseline_frac", [0.0, 1.0], ids=["continuous", "canary"])
def test_hook_verdicts_equal_the_row_by_row_build(band_mode, baseline_frac):
    """On a warm columnar tick every hook verdict equals the row-by-row
    build field by field and type by type: int verdict, float p, bool
    differs, float anomaly pairs, ndarray bands of the same length and
    dtype; each verdict holds its own pairs list. The fleet has a spiked
    row and an alias whose current window came back empty (on the canary
    bucket, an alias judged without a baseline)."""
    services = 4
    got, want = {}, {}
    _, (pw, pstore, psrc) = worker_pair(
        services, band_mode=band_mode, baseline_frac=baseline_frac,
        hooks=(None, lambda doc, verdicts: got.__setitem__(doc.id, verdicts)),
    )
    if baseline_frac:
        doc = pstore._docs["job-2"]
        doc.baseline_config = " ||".join(doc.baseline_config.split(" ||")[1:])
    decode = pw._decode_uni

    def recording(packed, res, now):
        want.update(_row_by_row_verdicts(packed, res))
        return decode(packed, res, now)

    pw._decode_uni = recording
    assert pw.tick(now=NOW + 150) == services
    spike((psrc,), "http://prom/cur", "latency:app1&")
    url = next(u for u in psrc.data if u.startswith("http://prom/cur") and "latency:app2&" in u)
    psrc.data[url] = (np.zeros(0, np.int64), np.zeros(0, np.float32))
    got.clear()
    want.clear()
    assert pw.tick(now=NOW + 200) == services
    assert pw._fast_kinds["baseline" if baseline_frac else "univariate"] == services
    assert sorted(got) == sorted(want) == [f"job-{i}" for i in range(services)]
    for doc_id, verdicts in got.items():
        assert len(verdicts) == len(want[doc_id]) == 4
        for g, w in zip(verdicts, want[doc_id]):
            for field in ("job_id", "alias", "verdict", "anomaly_pairs", "p_value", "dist_differs"):
                gv, wv = getattr(g, field), getattr(w, field)
                assert type(gv) is type(wv) and gv == wv, (doc_id, g.alias, field, gv, wv)
            assert all(type(x) is float for x in g.anomaly_pairs)
            for gv, wv in ((g.upper, w.upper), (g.lower, w.lower)):
                assert type(gv) is np.ndarray and gv.dtype == wv.dtype and gv.shape == wv.shape
                np.testing.assert_array_equal(gv, wv)
    assert any(v.anomaly_pairs for v in got["job-1"])
    empty = [v for v in got["job-2"] if v.alias == "latency"]
    assert empty and len(empty[0].upper) == len(empty[0].lower) == 0
    if baseline_frac:
        assert empty[0].p_value == 1.0 and empty[0].dist_differs is False
    flat = [v for verdicts in got.values() for v in verdicts]
    assert len({id(v.anomaly_pairs) for v in flat}) == len(flat)


def test_admission_revalidates_per_key_not_wholesale():
    """A fit-cache version bump (churn elsewhere) must not force a full
    admission re-walk: unchanged entries revalidate by identity; an
    entry replaced under the same key is re-admitted with the new
    object, and only its doc's admission row changes."""
    services = 4
    _, (worker, _, _) = worker_pair(services)
    worker.tick(now=NOW + 150)
    worker.tick(now=NOW + 160)
    admit = worker._admit
    assert len(admit) == services
    token0 = {k: v[3] for k, v in admit.items()}

    worker._fit_cache.put(("x", 1, "unrelated"), (0.0, 0.0, np.zeros(1, np.float32), 0, 1.0, 1))
    calls = count_columnar(worker)
    worker.tick(now=NOW + 170)
    assert calls
    assert len(admit) == services
    assert all(admit[k][3] != token0[k] for k in admit)  # restamped

    key = next(
        k for k in worker._fit_cache._d if "app0" in str(k) and "latency" in str(k)
    )
    replacement = tuple(worker._fit_cache.peek(key))  # equal value, new identity
    worker._fit_cache.put(key, replacement)
    rows_before = {k: v[1] for k, v in admit.items()}
    worker.tick(now=NOW + 180)
    assert any(r[3] is replacement for r in admit["job-0"][1])
    for k in admit:
        if k != "job-0":
            assert admit[k][1] is rows_before[k]


def test_cold_fit_bf16_matches_f32_and_jax():
    """The cold fit ships anchor + bf16 deltas by default and f32 values
    + masks with the gate off (`masked_stats` on the card). Both routes
    write the same statuses, on the cold tick and on the warm re-check
    from the cached state, and each equals the JAX worker on its route."""
    services = 5
    runs = {}
    for bf16 in (True, False):
        (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(services)
        spike((jsrc, psrc), "http://prom/cur", "latency:app2&", points=2)
        with bf16_gate(bf16):
            assert jw.tick(now=NOW + 150) == services
            assert pw.tick(now=NOW + 150) == services
            cold = statuses(pstore)
            assert cold == statuses(jstore)
            # the spiked doc is terminal; the warm tick re-checks the rest
            assert jw.tick(now=NOW + 200) == services - 1
            assert pw.tick(now=NOW + 200) == services - 1
            assert statuses(pstore) == statuses(jstore)
        _same_state(jw, pw)
        runs[bf16] = (cold, statuses(pstore))
    assert runs[True] == runs[False]
    assert runs[True][0]["job-2"][0] == STATUS_COMPLETED_UNHEALTH


def test_canary_bucket_matches_jax():
    """Canary docs ride the columnar tick as their own bucket, and their
    statuses, anomaly_info and hook verdicts (bands, pairwise p and
    differs from the device) equal the JAX worker's — including a doc
    whose baseline distribution shifted (differs=True lowers the
    threshold in-program)."""
    services = 6
    jrec, prec = [], []
    (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(
        services, band_mode="full", baseline_frac=0.5,
        hooks=(hook_recorder(jrec), hook_recorder(prec)),
    )
    assert jw.tick(now=NOW + 150) == services
    assert pw.tick(now=NOW + 150) == services
    assert statuses(pstore) == statuses(jstore)
    assert_same_hook_records(prec, jrec)

    spike((jsrc, psrc), "http://prom/cur", "latency:app1&")
    for src in (jsrc, psrc):
        burl = next(u for u in src.data if u.startswith("http://prom/base") and "latency:app0&" in u)
        bt, bv = src.data[burl]
        src.data[burl] = (bt, (bv + 0.5).astype(np.float32))
    jrec.clear()
    prec.clear()
    assert jw.tick(now=NOW + 200) == services
    assert pw.tick(now=NOW + 200) == services
    assert pw._fast_kinds["baseline"] == 3
    got = statuses(pstore)
    assert got == statuses(jstore)
    assert got["job-1"][0] == STATUS_COMPLETED_UNHEALTH
    assert_same_hook_records(prec, jrec)
    differs = [r for r in prec if r[0] == "job-0" and r[7]]
    assert differs and all(r[6] < 0.05 for r in differs)
    _same_state(jw, pw)


def test_canary_columnar_opt_out(monkeypatch):
    """FOREMAST_CANARY_COLUMNAR=0 keeps canary docs on the object path
    with the same judgments as the canary bucket and the JAX worker."""
    monkeypatch.setenv("FOREMAST_CANARY_COLUMNAR", "0")
    (_, jstore_off, _), (off, off_store, _) = worker_pair(4, baseline_frac=1.0)
    assert not off._canary_fast
    monkeypatch.delenv("FOREMAST_CANARY_COLUMNAR")
    (jw, jstore, _), (on, on_store, _) = worker_pair(4, baseline_frac=1.0)
    for now in (NOW + 150, NOW + 200):
        assert off.tick(now=now) == 4
        assert on.tick(now=now) == 4
        assert jw.tick(now=now) == 4
    assert off._fast_kinds["baseline"] == 0
    assert on._fast_kinds["baseline"] == 4
    assert statuses(off_store) == statuses(on_store) == statuses(jstore)


def test_canary_doc_with_partial_baseline_aliases():
    """A canary doc where only SOME aliases carry baselines: the
    baseline-less alias judges with (p=1, differs=False) inside the
    pairwise-active program, as on the JAX worker."""
    services = 3
    jrec, prec = [], []
    (jw, jstore, _), (pw, pstore, _) = worker_pair(
        services, baseline_frac=1.0, hooks=(hook_recorder(jrec), hook_recorder(prec))
    )
    for store in (jstore, pstore):
        doc = store._docs["job-2"]
        doc.baseline_config = " ||".join(doc.baseline_config.split(" ||")[1:])
    for now in (NOW + 150, NOW + 200):
        jrec.clear()
        prec.clear()
        assert jw.tick(now=now) == services
        assert pw.tick(now=now) == services
        assert statuses(pstore) == statuses(jstore)
        assert_same_hook_records(prec, jrec)
    assert pw._fast_kinds["baseline"] == services
    stripped = [r for r in prec if r[0] == "job-2" and r[1] == "latency"]
    assert stripped and all(r[6] == 1.0 and not r[7] for r in stripped)


def test_f32_cold_fit_bands_within_tolerance():
    """With the bf16 gate off the port's f32 fit is two-pass and the JAX
    program's shifted one-pass: hook bands agree within BAND_TOL[False]."""
    jrec, prec = [], []
    (jw, _, _), (pw, _, _) = worker_pair(
        3, band_mode="full", hooks=(hook_recorder(jrec), hook_recorder(prec))
    )
    with bf16_gate(False):
        jw.tick(now=NOW + 150)
        pw.tick(now=NOW + 150)
    assert_same_hook_records(prec, jrec, tol=BAND_TOL[False])


# Every univariate algorithm at a 24-step season over 512-point
# histories, and the daily season over 7-day histories for auto.
_ALGORITHM_CASES = [
    (a, 24, HIST_LEN)
    for a in (
        "moving_average", "ewma", "exponential_smoothing", "double_exponential_smoothing",
        "holtwinters", "holt_winters", "phase_means", "auto_univariate", "seasonal",
        "prophet", "seasonal_hourly",
    )
] + [("auto_univariate", 1440, 10_080)]


# the models that carry any period-m cycle shape, bursts included: the
# seasonal fleet stays healthy under them (the Fourier seasonal model
# flags the `tps` alias's two-step bursts, as on the JAX worker)
_CYCLE_MODELS = {"holtwinters", "holt_winters", "phase_means", "auto_univariate"}


@pytest.mark.parametrize(
    "algorithm,m,hist_len", _ALGORITHM_CASES, ids=[f"{a}-{m}" for a, m, _ in _ALGORITHM_CASES]
)
def test_univariate_algorithm_ticks_match_jax(algorithm, m, hist_len):
    """A fleet with seasonal, flat, trended and bursty aliases, judged by
    `algorithm` on both workers: the cold tick (bf16-delta fits of the
    model, [m]-wide entries) and a warm tick with one doc's latency
    spiked write the same statuses, codes, reasons and anomaly_info, with
    equal arena counters. The models that fit the cycle keep the fleet
    healthy until the spike; the others may flag the cycle itself, as
    the JAX worker does."""
    services = 3
    (jw, jstore, jsrc), (pw, pstore, psrc) = worker_pair(
        services, hist_len=hist_len, baseline_frac=0.5, algorithm=algorithm, season_steps=m
    )
    seasonal_series((jsrc, psrc), m)
    pcalls = count_columnar(pw)
    with bf16_gate(True):
        assert jw.tick(now=NOW + 150) == pw.tick(now=NOW + 150) == services
        cold = statuses(pstore)
        assert cold == statuses(jstore)
        _same_state(jw, pw)
        spike((jsrc, psrc), "http://prom/cur", "latency:app1&")
        assert jw.tick(now=NOW + 200) == pw.tick(now=NOW + 200)
    got = statuses(pstore)
    assert got == statuses(jstore)
    assert got["job-1"][0] == STATUS_COMPLETED_UNHEALTH
    _same_state(jw, pw)
    widths = {len(e[2]) for e in pw._fit_cache._d.values()}
    assert widths <= {1, m, 60}
    if algorithm in _CYCLE_MODELS:
        assert {s[0] for s in cold.values()} == {STATUS_PREPROCESS_COMPLETED}
        assert got["job-0"][0] == got["job-2"][0] == STATUS_PREPROCESS_COMPLETED
        assert pcalls, "the warm tick should take the columnar buckets"
        assert m in widths
