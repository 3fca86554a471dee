"""The port's `PrometheusSource` (standard-library session) against the
JAX package's (`requests`), on a loopback `query_range` server
(`tests/torch_fake_services.py`) and on injected flaky sessions: the
retry cases of `tests/test_sources.py` (transient statuses and errors,
exhausted retries, 4xx fail-fast, zero retries, the knob), the merge of
several series by timestamp and the drop of non-finite values. Both
sources must return the same series and make the same number of
requests."""

from __future__ import annotations

import numpy as np
import pytest

from foremast_tpu.metrics import source as js
from foremast_tpu_torch.chaos import CircuitBreaker
from foremast_tpu_torch.metrics import source as ts
from tests.torch_fake_services import FakePrometheus, serve_fake_prometheus

KEY = "/api/v1/query_range?query=latency%7Bapp%3D%22a%22%7D&start=100&end=400&step=60"
T = np.array([100, 160, 220, 280, 340], np.int64)
V = np.array([1.0, 2.5, -0.125, 1e-3, 3.0e6], np.float32)


class _Flaky:
    """Raises `exc` for the first `failures` GETs, then answers 200 with
    the loopback server's body."""

    def __init__(self, failures, exc, fake):
        self.failures, self.exc, self.fake, self.calls = failures, exc, fake, 0

    def get(self, url, timeout=None):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc("injected")
        return _Resp(self.fake.body(KEY))


class _Resp:
    def __init__(self, body):
        self.status_code, self._body = 200, body

    def raise_for_status(self):
        pass

    def json(self):
        import json

        return json.loads(self._body)


# (failure kind, failures, retries) -> (requests made, whether it raises)
CASES = {
    "conn_retried": (("conn", 2, 2), (3, False)),
    "timeout_retried": (("timeout", 1, 2), (2, False)),
    "503_retried": ((503, 2, 2), (3, False)),
    "429_retried": ((429, 1, 2), (2, False)),
    "500_retried": ((500, 2, 3), (3, False)),
    "conn_exhausted": (("conn", 10, 2), (3, True)),
    "503_exhausted": ((503, 10, 2), (3, True)),
    "404_fails_fast": ((404, 10, 3), (1, True)),
    "400_fails_fast": ((400, 10, 3), (1, True)),
    "zero_retries": (("conn", 1, 0), (1, True)),
    "zero_retries_503": ((503, 1, 0), (1, True)),
}


@pytest.fixture(scope="module")
def prom():
    fake = FakePrometheus({KEY: (T, V)})
    srv, url = serve_fake_prometheus(fake)
    yield fake, url
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_retry_policy_equals_jax(case, prom):
    (kind, failures, retries), (want_calls, raises) = CASES[case]
    fake, url = prom
    got = []
    for mod in (js, ts):
        if isinstance(kind, int):
            with fake.lock:
                fake.faults[KEY] = [kind] * failures
                fake.requests.clear()
            src = mod.PrometheusSource(retries=retries, backoff_seconds=0.001)
        else:
            exc = ConnectionError if kind == "conn" else TimeoutError
            sess = _Flaky(failures, exc, fake)
            src = mod.PrometheusSource(session=sess, retries=retries, backoff_seconds=0.001)
        try:
            series = src.fetch(url + KEY)
            err = None
        except Exception as e:  # noqa: BLE001 - the kind of failure is compared below
            series, err = None, e
        calls = fake.requests["/api/v1/query_range"] if isinstance(kind, int) else sess.calls
        with fake.lock:
            fake.faults.pop(KEY, None)
        got.append((series, err, calls))
    (jser, jerr, jcalls), (tser, terr, tcalls) = got
    assert jcalls == tcalls == want_calls
    assert (jerr is not None) == (terr is not None) == raises
    if raises:
        if isinstance(kind, int):
            assert terr.response.status_code == jerr.response.status_code == kind
        else:
            assert isinstance(terr, ConnectionError)
    else:
        for a, b in zip(tser, jser):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tser[0], T)
        np.testing.assert_array_equal(tser[1], V)


def test_refused_connection_is_transient_in_both():
    srv, url = serve_fake_prometheus(FakePrometheus())
    srv.shutdown()
    srv.server_close()
    for mod in (js, ts):
        with pytest.raises(mod._transient_exceptions()):
            mod.PrometheusSource(retries=1, backoff_seconds=0.001).fetch(url + KEY)


@pytest.mark.parametrize("split", [1, 3])
def test_merge_and_non_finite_drop_equal_jax(split):
    v = V.copy()
    v[1], v[3] = np.nan, np.inf
    fake = FakePrometheus({KEY: (T, v)}, split=split)
    srv, url = serve_fake_prometheus(fake)
    try:
        want = js.PrometheusSource().fetch(url + KEY)
        got = ts.PrometheusSource().fetch(url + KEY)
        empty = ts.PrometheusSource().fetch(url + "/api/v1/query_range?query=none")
    finally:
        srv.shutdown()
        srv.server_close()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a NaN or Inf point is dropped; the other series' zeros keep its
    # timestamp when there are several
    keep = [0, 2, 4] if split == 1 else [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(got[0], T[keep])
    assert empty[0].dtype == np.int64 and len(empty[0]) == len(empty[1]) == 0


def test_retry_knob_read_as_jax_reads_it(monkeypatch):
    monkeypatch.setenv("FOREMAST_FETCH_RETRIES", "5")
    assert ts.PrometheusSource().retries == js.PrometheusSource().retries == 5
    monkeypatch.delenv("FOREMAST_FETCH_RETRIES")
    assert ts.PrometheusSource().retries == js.PrometheusSource().retries == 2


def test_breaker_fails_fast_once_open(prom):
    fake, url = prom
    breaker = CircuitBreaker("prometheus", failure_threshold=1, open_seconds=60)
    sess = _Flaky(10, ConnectionError, fake)
    src = ts.PrometheusSource(session=sess, retries=0, breaker=breaker)
    with pytest.raises(ConnectionError):
        src.fetch(url + KEY)
    with pytest.raises(ConnectionError):  # BreakerOpen, without a request
        src.fetch(url + KEY)
    assert sess.calls == 1


def test_one_session_per_thread(prom):
    import threading

    fake, url = prom
    src = ts.PrometheusSource()
    out = []

    def fetch():
        out.append((src.fetch(url + KEY), src._session, src._session))

    threads = [threading.Thread(target=fetch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(np.array_equal(series[1], V) and a is b for series, a, b in out)
    assert len({id(a) for _, a, _ in out}) == 4
