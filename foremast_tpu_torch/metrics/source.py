"""Metric sources: where the brain fetches its windows from.

The reference brain HTTP-GETs each `query_range` URL stored in the ES
document's config strings (SURVEY.md section 3.2). The port's own copy
of the JAX package's `foremast_tpu/metrics/source.py`, without
`PrometheusSource` (its HTTP client is not on the card's machine; it
comes with a later slice, over `urllib`). Sources here:

  * `ReplaySource` — serves deterministic CSV traces keyed by substring
    match on the URL/query, the analog of the reference demo's
    `FileErrorGenerator` replay (`error/FileErrorGenerator.java:27-37`) —
    drives golden end-to-end runs without a live Prometheus;
  * `StaticSource` — direct alias->series map for unit tests.

All return (times: int64[N], values: float32[N]) numpy arrays.
"""

from __future__ import annotations

import csv
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
    """The retryable exception types. The JAX package adds `requests`'
    connection and timeout types, which its HTTP source raises; no
    source of the port uses `requests`, so the builtins are the set."""
    return (ConnectionError, TimeoutError)


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
