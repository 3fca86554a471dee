"""Metric sources: where the brain fetches its windows from.

The reference brain HTTP-GETs each `query_range` URL stored in the ES
document's config strings (SURVEY.md section 3.2). The port's own copy
of the JAX package's `foremast_tpu/metrics/source.py`. Sources here:

  * `PrometheusSource` — real HTTP fetch (the port's standard-library
    session, `foremast_tpu_torch/httpclient.py`), parsing the
    query_range JSON matrix response;
  * `ReplaySource` — serves deterministic CSV traces keyed by substring
    match on the URL/query, the analog of the reference demo's
    `FileErrorGenerator` replay (`error/FileErrorGenerator.java:27-37`) —
    drives golden end-to-end runs without a live Prometheus;
  * `StaticSource` — direct alias->series map for unit tests.

All return (times: int64[N], values: float32[N]) numpy arrays.
"""

from __future__ import annotations

import csv
import http.client
import math
import os
import random
import socket
import threading
import time
from datetime import datetime, timezone
from typing import Callable, Mapping

import numpy as np

Series = tuple[np.ndarray, np.ndarray]


def _empty() -> Series:
    return np.zeros(0, np.int64), np.zeros(0, np.float32)


class MetricSource:
    # True => fetches block on I/O and the worker may fan a claimed
    # batch's fetches through a thread pool; in-memory sources say False
    # so the (single-core) worker skips pure-GIL thread overhead
    concurrent_fetch = True

    def fetch(self, url: str) -> Series:  # pragma: no cover - interface
        raise NotImplementedError


# HTTP statuses worth retrying: throttling and transient server-side
# failures; 4xx configuration errors (bad query) fail immediately
RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})


def _transient_exceptions() -> tuple:
    """The retryable exception types: the builtin connection and timeout
    errors (what `httpclient.Session` raises for a transport failure, and
    what injected test sessions raise), and the socket and `http.client`
    failures a session of another make may let through."""
    return (ConnectionError, TimeoutError, socket.gaierror, http.client.HTTPException)


class PrometheusSource(MetricSource):
    """Fetches query_range URLs; merges a multi-series result by summing
    values per timestamp (recording rules normally return one series).

    Thread-safe: the worker fetches a claimed batch from a thread pool
    and a session is not safe for concurrent use, so each thread gets
    its own session. An explicitly injected `session` (tests) is used
    as-is.

    Transient failures (HTTP 429/5xx, connection/timeout errors) are
    retried up to `FOREMAST_FETCH_RETRIES` times (default 2) with
    exponential jittered backoff. Non-transient errors (4xx, parse
    errors) raise on the first attempt.

    `chaos` perturbs every attempt at this one request choke point;
    `breaker` (chaos.CircuitBreaker) is checked once per fetch and
    records the fetch's final outcome, so a dead Prometheus fails
    further fetches in microseconds (BreakerOpen is a ConnectionError).
    """

    def __init__(
        self,
        session=None,
        timeout: float = 10.0,
        retries: int | None = None,
        backoff_seconds: float = 0.25,
        chaos=None,
        breaker=None,
    ):
        self._injected = session
        self._local = threading.local()
        self.timeout = timeout
        if retries is None:
            retries = int(os.environ.get("FOREMAST_FETCH_RETRIES", "") or 2)
        self.retries = max(0, retries)
        self.backoff_seconds = backoff_seconds
        self.chaos = chaos
        self.breaker = breaker

    @property
    def _session(self):
        if self._injected is not None:
            return self._injected
        sess = getattr(self._local, "session", None)
        if sess is None:
            from foremast_tpu_torch.httpclient import Session

            sess = self._local.session = Session()
        return sess

    def _get_with_retries(self, url: str):
        transient = _transient_exceptions()
        breaker = self.breaker
        if breaker is not None:
            breaker.allow()  # BreakerOpen (a ConnectionError) fails fast
        chaos = self.chaos
        for attempt in range(self.retries + 1):
            last = attempt == self.retries
            try:
                if chaos is not None:
                    chaos.perturb(url)  # injected faults are transient
                resp = self._session.get(url, timeout=self.timeout)
            except transient:
                if last:
                    if breaker is not None:
                        breaker.record_failure()
                    raise
            else:
                if resp.status_code not in RETRY_STATUSES:
                    if breaker is not None:
                        breaker.record_success()
                    return resp
                if last:
                    if breaker is not None:
                        breaker.record_failure()
                    return resp
            # bounded jittered exponential backoff: 0.5-1x of
            # base * 2^attempt, so a herd of claim fetches does not
            # re-synchronize on the throttling server
            time.sleep(self.backoff_seconds * (2**attempt) * (0.5 + 0.5 * random.random()))
        raise AssertionError("unreachable")  # pragma: no cover

    def fetch(self, url: str) -> Series:
        resp = self._get_with_retries(url)
        resp.raise_for_status()
        return series_from_body(resp.json())


def series_from_body(body: dict) -> Series:
    """A `query_range` answer, parsed from JSON, as one series: the
    values of every result series summed per timestamp, non-numeric and
    non-finite points dropped. `PrometheusSource.fetch` is the round trip,
    `json.loads` and this."""
    if body.get("status") != "success":
        raise RuntimeError(f"prometheus error response: {body.get('error')}")
    acc: dict[int, float] = {}
    for series in body.get("data", {}).get("result", []):
        for t, v in series.get("values", []):
            try:
                fv = float(v)
                ft = int(float(t))
            except (TypeError, ValueError):
                continue
            if not math.isfinite(fv):
                # Prometheus emits "NaN"/"+Inf" strings, which float()
                # parses: drop them or they poison the window
                continue
            acc[ft] = acc.get(ft, 0.0) + fv
    if not acc:
        return _empty()
    ts = np.asarray(sorted(acc), np.int64)
    vs = np.asarray([acc[t] for t in ts], np.float32)
    return ts, vs


def load_csv_trace(path: str, t0: int | None = None, step: int = 60) -> Series:
    """Load a `timestamp,value` or `value`-per-line CSV trace (the demo's
    data1/data2 format: `YYYY-MM-DD HH:MM:SS,value`).

    Tolerant of real-world exports: an empty file yields the empty
    series (the brain then judges UNKNOWN, not a crash), and
    timestamped rows are STABLY sorted — an unsorted export would
    otherwise produce an out-of-order window that breaks every
    step-inference and gap-anchoring consumer downstream. Duplicate
    timestamps are kept (stable: file order within a timestamp run):
    the demo's replay traces record several observations per coarse
    5-min stamp, and collapsing them would starve the min-points gates.
    Synthetic timelines (`t0` given, or value-only rows) are generated
    in order and skip the sort."""
    ts: list[int] = []
    vs: list[float] = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            if len(row) == 1:
                vs.append(float(row[0]))
                ts.append(0)
            else:
                raw = row[0].strip()
                try:
                    t = int(float(raw))
                except ValueError:
                    t = int(
                        datetime.strptime(raw, "%Y-%m-%d %H:%M:%S")
                        .replace(tzinfo=timezone.utc)
                        .timestamp()
                    )
                ts.append(t)
                vs.append(float(row[1]))
    times = np.asarray(ts, np.int64)
    values = np.asarray(vs, np.float32)
    if t0 is not None or (len(times) and (times == 0).all()):
        base = 0 if t0 is None else t0
        return base + step * np.arange(len(vs), dtype=np.int64), values
    if len(times) > 1 and not (np.diff(times) >= 0).all():
        order = np.argsort(times, kind="stable")
        times = times[order]
        values = values[order]
    return times, values


class ReplaySource(MetricSource):
    """Serves canned traces by substring match against the fetched URL.

    Register patterns most-specific first; an unmatched URL returns an
    empty series (the brain then yields UNKNOWN, not a crash).
    """

    concurrent_fetch = False

    def __init__(self):
        self._routes: list[tuple[str, Callable[[], Series]]] = []

    def register(self, pattern: str, series: Series | Callable[[], Series]):
        fn = series if callable(series) else (lambda s=series: s)
        self._routes.append((pattern, fn))
        return self

    def register_csv(self, pattern: str, path: str, t0: int | None = None):
        return self.register(pattern, lambda: load_csv_trace(path, t0=t0))

    def fetch(self, url: str) -> Series:
        from urllib.parse import unquote

        target = unquote(url)
        for pattern, fn in self._routes:
            if pattern in target:
                return fn()
        return _empty()


class StaticSource(MetricSource):
    """alias-keyed direct map (unit tests)."""

    concurrent_fetch = False

    def __init__(self, data: Mapping[str, Series]):
        self.data = dict(data)

    def fetch(self, url: str) -> Series:
        for key, series in self.data.items():
            if key in url:
                return series
        return _empty()
