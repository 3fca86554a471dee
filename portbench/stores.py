"""The job store and the metric source that the worker runs over.

`BenchStore` is the port's `InMemoryStore` with the host clock on its
writes: it stamps each document's creation and its first verdict, counts
the (document, metric) windows whose verdict it receives, keeps what it
received for the documents held to the reference, and drops a document
once it is terminal (the job service's index keeps it, not the worker's
process). `BenchSource` answers each query URL with the arrays of
`fleet.py`, for the sweep the harness is on.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench import fleet

VERDICT_STATUSES = frozenset(
    {"preprocess_completed", "completed_health", "completed_unhealth", "completed_unknown"}
)


def make_store(n_aliases: dict, sampled: set):
    """A BenchStore (built here so that importing this module imports
    nothing of the program)."""
    from foremast_tpu_torch.jobs import InMemoryStore
    from foremast_tpu_torch.jobs.models import TERMINAL_STATUSES
    from foremast_tpu_torch.jobs.store import now_rfc3339

    class BenchStore(InMemoryStore):
        def __init__(self):
            super().__init__()
            self.n_aliases = n_aliases  # doc id -> windows it judges
            self.sampled = sampled  # doc ids whose writes are kept
            self.sweep = -1
            self.created: dict[str, float] = {}
            self.first_verdict: dict[str, float] = {}
            self.judged: set = set()  # doc ids given a verdict in this sweep
            self.windows = 0  # windows whose verdict this store received
            self.failed = 0  # preprocess_failed writes
            # (sweep, doc id, status, code, reason, frozen anomaly values) of sampled docs
            self.log: list = []

        def create(self, doc):
            out = super().create(doc)
            self.created[doc.id] = time.perf_counter()
            return out

        def update(self, doc):
            self.update_many([doc])
            return doc

        def update_many(self, docs):
            stamp = now_rfc3339()
            t = time.perf_counter()
            with self._lock:
                for doc in docs:
                    doc.modified_at = stamp
                    if doc.status in TERMINAL_STATUSES:
                        # out of the store: its record is the log below
                        self._docs.pop(doc.id, None)
                    else:
                        self._docs[doc.id] = doc
                    if doc.status in VERDICT_STATUSES:
                        self.windows += self.n_aliases[doc.id]
                        self.judged.add(doc.id)
                        self.first_verdict.setdefault(doc.id, t)
                    elif doc.status == "preprocess_failed":
                        self.failed += 1
                    if doc.id in self.sampled:
                        self.log.append((self.sweep, doc.id, doc.status, str(doc.status_code), doc.reason or "",
                                         frozen_values(doc.anomaly_info)))

        def open_count(self) -> int:
            with self._lock:
                return len(self._docs)

    return BenchStore()


def make_source(pools: "fleet.Pools", urls: "fleet.Urls", traffic: "fleet.Traffic"):
    from foremast_tpu_torch.metrics.source import MetricSource

    tc = urls.shape.current_points

    class BenchSource(MetricSource):
        # in memory: the worker fetches on its own thread, with no pool
        concurrent_fetch = False

        def __init__(self):
            self.sweep = 0
            self._hist_t: dict[int, np.ndarray] = {}
            self._cur_t = self._base_t = None

        def at_sweep(self, sweep: int) -> None:
            self.sweep = sweep
            now = fleet.now_of(sweep, traffic.advance_points)
            self._cur_t = now - fleet.STEP * tc + fleet.STEP * np.arange(tc, dtype=np.int64)
            self._base_t = self._cur_t - fleet.BASE_LAG

        def fetch(self, url: str):
            kind, row, birth, spiked = urls.table[url]
            if kind == urls.HIST:
                ht = self._hist_t.get(birth)
                if ht is None:
                    ht = self._hist_t[birth] = urls.hist_times(birth)
                return ht, pools.hist[row]
            offset = (self.sweep - birth) * traffic.advance_points
            v = fleet.window_values(pools, traffic, tc, kind, row, offset, spiked)
            return (self._cur_t if kind == urls.CUR else self._base_t), v

    return BenchSource()


def frozen_values(info) -> tuple:
    """The anomaly pairs of a document's `anomaly_info` as ((alias,
    (t1, v1, ...)), ...)."""
    values = info.get("values", {}) if isinstance(info, dict) else {}
    return tuple((alias, tuple(float(x) for x in pairs)) for alias, pairs in values.items())


class VerdictLog:
    """The worker's verdict hook: keeps each verdict of a sampled
    document (per alias: verdict, anomaly pairs, the band's last point,
    the pairwise p and decision) with the sweep it came in.

    What the harness keeps through the window is tuples of numbers and
    strings, which the collector stops tracking, and no list or dict: a
    record that it tracked would lengthen every full collection of the
    worker a little more with each sweep."""

    def __init__(self, sampled: set):
        self.sampled = sampled
        self.sweep = -1
        self.rows: list = []
        self._lock = threading.Lock()

    def __call__(self, doc, verdicts) -> None:
        if doc.id not in self.sampled:
            return
        rec = tuple(
            (v.alias, int(v.verdict), tuple(float(x) for x in v.anomaly_pairs),
             float(v.upper[-1]) if len(v.upper) else float("nan"),
             float(v.lower[-1]) if len(v.lower) else float("nan"),
             float(v.p_value), bool(v.dist_differs))
            for v in verdicts
        )
        with self._lock:
            self.rows.append((self.sweep, doc.id, rec))
