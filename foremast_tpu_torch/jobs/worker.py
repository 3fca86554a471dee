"""The brain worker — claim, fetch, judge (batched), write back.

Reference loop (SURVEY.md section 3.2): poll the job store for claimable
docs (stuck-job takeover after MAX_STUCK_IN_SECONDS), mark
preprocess_inprogress, GET each query_range URL, run pairwise +
historical-model scoring, fail fast to `completed_unhealth` on any
anomaly, else keep re-checking until endTime then `completed_health`.

Batched design: one worker claims MANY jobs per tick and judges every
(job x alias) window in batched `HealthJudge` calls on the card — jobs
are array rows, not units of work. Shared-nothing workers still scale
out against one store (CAS claims).

The port's own copy of the JAX package's monolithic fleet tick
(`foremast_tpu/jobs/worker.py` `BrainWorker.tick` → `_tick`): the
columnar fast tick (baseline-less and canary buckets through
`judge_columnar`) for warm re-checks, and the chunked slow path (cold
fits through `HealthJudge.judge` with the fit cache) for everything
else, with the same write-behind, release and tick-budget contracts.
Every univariate `ML_ALGORITHM` of the engine's registry judges here
(the seasonal and trended ones with the hist->cur gap advance), and the
joint selectors (`bivariate_normal`, `lstm_autoencoder`, `auto`) through
the default `MultivariateJudge`: multi-alias docs fit on the slow path
and, once their joint fit is cached, re-check on the joint columnar path
(`_judge_joint_fast`). Fit journals (`enable_fit_persistence`) make a
restart warm. Cold fits read resident ring columns first (`_fetch_hist`);
a pure-push source with an admission floor admits newcomers on short
coverage as PROVISIONAL fits, which `_refine_provisional` invalidates as
the ring grows so the next claim refits them (`jobs/refine.py`).

The reactive plane: with a `DirtySet` wired (`dirty=`), `micro_tick`
judges just the documents whose series the receiver saw pushed, through
the same `_tick` body; a sweep whose claim can exceed
`FOREMAST_SWEEP_SLICE_DOCS` runs SLICED (`_sweep_sliced`): bounded
slices through a prefetch / dispatch / write pipeline, with a micro-tick
preemption point between slices.

Tenancy (`FOREMAST_TENANTS`, `tenant.get_tenancy`): with two or more
tenants the sweep pool serves slices deficit-weighted across tenants,
every claim is charged to its documents' tenants, and the verdict-latency
histogram carries each doc's bounded `tenant` label.

The worker mesh (`mesh=`, a `mesh.MeshNode`): every claim cycle renews
the member's lease and refreshes its rings, the claim takes only the
member's partition, and a planned join or drain moves the fit caches with
the partition (`attach_handoff`).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
import urllib.parse
import uuid
from functools import partial
from typing import Callable

import numpy as np

from foremast_tpu_torch.chaos.degrade import (
    REASON_ABORT,
    REASON_DEADLINE,
    REASON_DEMOTED,
    REASON_FETCH,
    REASON_REPLAYED,
    Degradation,
    is_transient_error,
)
from foremast_tpu_torch.config import BrainConfig, env_overrides
from foremast_tpu_torch.engine.judge import (
    _MIN_BUCKET,
    GAP_SENSITIVE_FITS,
    HealthJudge,
    MetricTask,
    MetricVerdict,
    bucket_length,
    combine_verdicts,
    infer_step,
)
from foremast_tpu_torch.engine.multivariate import (
    MULTIVARIATE_ALGOS,
    MultivariateJudge,
    align_series,
    select_mode,
)
from foremast_tpu_torch.engine.scoring import HEALTHY, UNHEALTHY, UNKNOWN
from foremast_tpu_torch.jobs.models import (
    STATUS_COMPLETED_HEALTH,
    STATUS_COMPLETED_UNHEALTH,
    STATUS_COMPLETED_UNKNOWN,
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_FAILED,
    TERMINAL_STATUSES,
    AnomalyInfo,
    Document,
)
from foremast_tpu_torch.jobs.pipeline import END, ChunkPipeline, StageError
from foremast_tpu_torch.jobs.refine import RefineBook, refine_docs_per_tick_from_env
from foremast_tpu_torch.jobs.store import JobStore, parse_time
# the module, not the function: `metrics.promql` imports `jobs.models`,
# so importing `metrics` first reaches this line while promql is half built
from foremast_tpu_torch.metrics import promql
from foremast_tpu_torch.metrics.source import MetricSource
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.observe.logs import ctx_log
from foremast_tpu_torch.observe.profile import trace_scoring
from foremast_tpu_torch.observe.spans import inherit_span, span
from foremast_tpu_torch.reactive.dirty import (
    doc_route_key,
    microtick_docs_from_env,
    microtick_seconds_from_env,
    sweep_slice_docs_from_env,
)

log = logging.getLogger("foremast_tpu_torch.worker")

# History-cache sizing and admission: entries are whole ~10k-point series
# (~120 KB), so the cap is independent of MAX_CACHE_SIZE (model params);
# a range's `end` must be at least this far in the past before its series
# is treated as immutable (covers the reference's 1-min Prometheus
# ingestion latency with margin, metricsquery.go:53-55).
HIST_CACHE_ENTRIES = 256
HIST_SETTLED_SECONDS = 120.0

_EMPTY_TIMES = np.zeros(0, np.int64)
_EMPTY_VALUES = np.zeros(0, np.float32)

# Partial-tick sentinels: a doc whose fetch failed TRANSIENTLY
# (dependency down, breaker open) or whose turn came after the tick
# budget is RELEASED — status back to preprocess_completed, claimable
# next tick, counted per reason — instead of terminally
# preprocess_failed (permanent errors keep that reference behavior) or
# wedging the tick. Two sentinels so the counters name the cause.
RELEASED = object()  # transient fetch failure
RELEASED_DEADLINE = object()  # tick budget exceeded


# Sliced, preemptible sweeps: a full sweep whose claim can exceed
# FOREMAST_SWEEP_SLICE_DOCS (reactive/dirty.py: sweep_slice_docs_from_env,
# default 2048, 0 = the monolithic body) runs as a SEQUENCE of bounded
# slices through a warm-path pipeline (claim-pool prepare / async
# columnar dispatch / gather + decode + write), with a micro-tick
# preemption point at every slice boundary: a pushed anomaly's latency is
# bounded by one slice's wall clock, not the sweep's.


class _TickLedger:
    """One judging cycle's arrival-attribution state: the route keys this
    cycle owes a push->verdict latency observation (``pending``: key ->
    receiver arrival stamp) and the keys already observed. A sliced sweep
    and the micro-ticks that PREEMPT it mid-flight each carry their OWN
    ledger, so a nested cycle can never clobber the outer one's
    attribution (the sweep's writer thread reads its ledger while the
    tick thread runs the nested micro). Single dict and set operations
    are GIL-atomic; iteration happens only after the cycle's pipeline
    threads are joined."""

    __slots__ = ("path", "pending", "observed")

    def __init__(self, path: str, pending=None):
        self.path = path
        self.pending: dict[str, float] = dict(pending) if pending else {}
        self.observed: set[str] = set()


class _SweepPool:
    """The sliced sweep's claimed-but-unsliced document pool.

    One leaf lock guards the queue, the route-key index, the promoted
    front and the in-flight key counts; three threads touch it: the
    prefetch thread takes slices, the tick thread promotes dirty route
    keys to the front at preemption points, and the writer thread
    retires written slices. ``promote`` is how a pushed anomaly whose
    document is claimed but NOT yet fetched jumps the queue: its slice
    runs next, fetches post-arrival samples, and the sweep itself
    delivers the verdict inside ~one slice."""

    def __init__(self, docs, tenancy=None):
        self._lock = threading.Lock()
        self._queue = collections.OrderedDict((d.id, d) for d in docs)
        self._keys: dict[str, list[str]] = {}
        for d in docs:
            self._keys.setdefault(doc_route_key(d), []).append(d.id)
        self._front: collections.deque = collections.deque()
        self._inflight: dict[str, int] = {}
        # Tenant-fair slice order: with >= 2 tenants configured, take()
        # serves tenants deficit-weighted (promoted docs still jump
        # everything — preemption latency beats fairness), so a whale
        # tenant's large claim cannot push a quiet tenant's documents to
        # the sweep's tail. With one (or zero) tenants self._drr stays
        # None and take() is byte-identical to the untenanted queue order
        # (the parity pin).
        self._tenancy = tenancy if tenancy is not None and tenancy.fair else None
        self._drr = None
        self._tenant_of: dict[str, str] = {}
        self._tqueues: dict[str, collections.OrderedDict] = {}
        if self._tenancy is not None:
            from foremast_tpu_torch.tenant.fairness import DeficitRoundRobin

            self._drr = DeficitRoundRobin(self._tenancy.weights())
            for d in docs:
                t = self._tenancy.tenant_of_doc(d)
                self._tenant_of[d.id] = t
                self._tqueues.setdefault(t, collections.OrderedDict())[d.id] = d

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def take(self, n: int) -> list:
        """Next slice: promoted docs first, then claim order — or, with
        tenant fairness active, deficit-weighted across tenants (claim
        order preserved within a tenant). Taken docs enter the in-flight
        set until `done` retires them."""
        out = []
        with self._lock:
            while self._front and len(out) < n:
                doc = self._queue.pop(self._front.popleft(), None)
                if doc is not None:
                    out.append(doc)
            if self._drr is None:
                while self._queue and len(out) < n:
                    _, doc = self._queue.popitem(last=False)
                    out.append(doc)
            else:
                # promoted docs leave their tenant queues too
                for doc in out:
                    self._forget(doc.id)
                need = n - len(out)
                if need > 0 and self._queue:
                    order = self._drr.pick({t: len(q) for t, q in self._tqueues.items()}, need)
                    for t in order:
                        tq = self._tqueues.get(t)
                        if not tq:
                            continue
                        doc_id, doc = tq.popitem(last=False)
                        if not tq:
                            del self._tqueues[t]
                        self._tenant_of.pop(doc_id, None)
                        self._queue.pop(doc_id, None)
                        out.append(doc)
            for doc in out:
                rk = doc_route_key(doc)
                ids = self._keys.get(rk)
                if ids:
                    try:
                        ids.remove(doc.id)
                    except ValueError:
                        pass
                    if not ids:
                        del self._keys[rk]
                self._inflight[rk] = self._inflight.get(rk, 0) + 1
        return out

    def _forget(self, doc_id: str) -> None:
        """Drop one doc from its tenant queue. Runs ONLY from take()'s
        `with self._lock:` block: the lock is not reentrant, so the
        guarded accesses carry the suppression instead."""
        t = self._tenant_of.pop(doc_id, None)  # foremast: ignore[lock-discipline] — caller (take) holds _lock
        if t is None:
            return
        tq = self._tqueues.get(t)  # foremast: ignore[lock-discipline] — caller (take) holds _lock
        if tq is not None:
            tq.pop(doc_id, None)
            if not tq:
                del self._tqueues[t]  # foremast: ignore[lock-discipline] — caller (take) holds _lock

    def drain(self) -> list:
        """Everything still pooled (deadline expiry, abort): one bulk
        release instead of judging over budget."""
        with self._lock:
            out = list(self._queue.values())
            self._queue.clear()
            self._keys.clear()
            self._tqueues.clear()
            self._tenant_of.clear()
            return out

    def done(self, docs) -> None:
        """A slice's docs were written (or released): their route keys
        leave the in-flight set, making them fair game for the next
        boundary's micro-tick."""
        with self._lock:
            for doc in docs:
                rk = doc_route_key(doc)
                c = self._inflight.get(rk, 0)
                if c <= 1:
                    self._inflight.pop(rk, None)
                else:
                    self._inflight[rk] = c - 1

    def promote(self, route_key: str) -> bool:
        """Move every pooled doc of `route_key` to the front of the slice
        order; False when none are pooled."""
        with self._lock:
            ids = self._keys.get(route_key)
            if not ids:
                return False
            self._front.extend(ids)
            return True

    def inflight(self, route_key: str) -> bool:
        with self._lock:
            return route_key in self._inflight


class _SlicePrep:
    """One prepared slice: admission split + fetched windows + packed
    columnar buffers, built on the prefetch thread. `release_all` marks a
    deadline-expiry bundle (every doc releases un-judged)."""

    __slots__ = (
        "docs", "claim_mono", "slow", "ok_items", "ok_citems", "ok_joint",
        "failed", "released", "uni_packed", "canary_packed", "release_all",
        "slow_done",
    )

    def __init__(self, docs, claim_mono, release_all=False):
        self.docs = docs
        self.claim_mono = claim_mono
        self.release_all = release_all
        self.slow_done = False
        self.slow = []
        self.ok_items = []
        self.ok_citems = []
        self.ok_joint = []
        self.failed = []
        self.released = []
        self.uni_packed = None
        self.canary_packed = None


class _SliceResult:
    """A dispatched slice: pending (ungathered) columnar judgments plus
    the synchronously judged joint docs. `aborted` marks a StageError
    partial: finish writes what was judged and releases the rest."""

    __slots__ = ("prep", "joint_updated", "joint_counts", "uni_pending", "canary_pending", "aborted")

    def __init__(self, prep):
        self.prep = prep
        self.joint_updated = []
        self.joint_counts = None
        self.uni_pending = None
        self.canary_pending = None
        self.aborted = False


class _UniPacked:
    """One packed univariate/canary columnar bucket: the [B, tc]
    buffers plus per-row operands, ready for `judge_columnar_async`.
    `ok_items` is the (canary-split) item list the decode walks. Built on
    whichever thread packs (the prefetch thread under a sliced sweep);
    consumed by the dispatch (tick thread) and the decode (writer)."""

    __slots__ = (
        "ok_items", "values", "mask", "keys", "entries", "nidx",
        "thr", "bnd", "mlb", "gaps", "tc", "canary",
        "base_vals", "base_m",
    )

    def __init__(
        self, ok_items, values, mask, keys, entries, nidx,
        thr, bnd, mlb, gaps, tc, canary, base_vals, base_m,
    ):
        self.ok_items = ok_items
        self.values = values
        self.mask = mask
        self.keys = keys
        self.entries = entries
        self.nidx = nidx
        self.thr = thr
        self.bnd = bnd
        self.mlb = mlb
        self.gaps = gaps
        self.tc = tc
        self.canary = canary
        self.base_vals = base_vals
        self.base_m = base_m


def _hist_end_epoch(url: str) -> float | None:
    """The historical range's end as unix seconds, or None if unknown.

    Handles both datasource URL shapes: Prometheus query_range's `?end=`
    parameter (epoch float or RFC3339 — Prometheus accepts either,
    prometheushelper.go:12-27) and the wavefront stub's
    `<query>&&<start>&&<unit>&&<end>` encoding (wavefronthelper.go:20-29).
    """
    raw: str | None = None
    try:
        q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
        raw = q["end"][0]
    except (KeyError, IndexError):
        if "&&" in url:
            parts = url.split("&&")
            if len(parts) >= 4:
                raw = parts[3]
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        ts = parse_time(raw)  # RFC3339 fallback; 0.0 when unparseable
        return ts if ts > 0 else None


def infer_metric_type(alias: str, config: BrainConfig) -> str | None:
    """Map a metric alias onto a per-type threshold row by substring match
    (the reference keys its override matrix by metric *type* names like
    error5xx/latency which appear in the aliases, foremast-brain.yaml:32-73)."""
    low = alias.lower()
    for rule in config.anomaly.rules:
        if rule.metric_type.lower() in low:
            return rule.metric_type
    return None


class BrainWorker:
    """One scoring node on `device` (the card by default; the judge
    raises where there is none). `tick()` processes one
    claim-fetch-judge-write cycle; `run()` loops forever."""

    def __init__(
        self,
        store: JobStore,
        source: MetricSource,
        config: BrainConfig | None = None,
        device="cuda",
        worker_id: str | None = None,
        claim_limit: int = 256,
        on_verdict: Callable[[Document, list[MetricVerdict]], None] | None = None,
        band_mode: str = "last",
        tracer=None,  # observe.spans.Tracer (optional)
        degrade: Degradation | None = None,
        metrics=None,  # observe.gauges.WorkerMetrics (optional)
        dirty=None,  # reactive.DirtySet (optional: the micro-tick plane)
        mesh=None,  # mesh.MeshNode (optional: fleet partitioning)
        device_mesh="env",  # parallel.Mesh | None | "env"
    ):
        """`band_mode` controls how much of the model band each verdict
        carries back from the device: "last" (default — only the final
        band point, what a gauge exporter publishes) or "full" (whole
        [Tc] band per metric, for on_verdict hooks that consume the band
        shape).

        `device_mesh`: the univariate judge spans a device mesh of this
        process — a `parallel.Mesh`, None for the single-device judge,
        or "env" (default) to resolve FOREMAST_DEVICE_MESH ("auto" = all
        local cards; one card, or a worker on the CPU, resolves to the
        single-device judge). Placement, not semantics: batches split
        their leading axis, arenas their row space, and every cache,
        admission and degradation contract is unchanged."""
        self.store = store
        self.source = source
        self.config = config or BrainConfig()
        self.claim_limit = claim_limit
        # MultivariateJudge dispatches by metric count (1 -> univariate,
        # 2 -> bivariate normal, 3+ -> LSTM-AE hybrid, per the selector)
        # and delegates univariate jobs to its HealthJudge, `_uni`
        univariate = None
        if device_mesh is not None:
            from foremast_tpu_torch.parallel.batch import sharded_univariate

            univariate = sharded_univariate(
                self.config, mesh=None if isinstance(device_mesh, str) else device_mesh, device=device
            )
        self.judge = MultivariateJudge(self.config, univariate=univariate, device=device)
        self._uni = self.judge.univariate
        self._uni.band_mode = band_mode
        self.worker_id = worker_id or f"brain-{uuid.uuid4().hex[:8]}"
        self.on_verdict = on_verdict
        # Fitted-forecast cache (the reference's MAX_CACHE_SIZE model
        # cache, `foremast-brain/README.md:30`): terminal forecaster state
        # per (algorithm, season, app|alias|historical-URL), so a re-check
        # tick on an unchanged history skips the 7-day scan and re-runs
        # only the judgment tail.
        self._fit_cache = ModelCache(self.config.max_cache_size)
        self._uni.fit_cache = self._fit_cache
        # the algorithm and season the univariate judge fits and caches
        # under (a multivariate selector rewrites the algorithm to its
        # univariate fallback)
        self._eff_cfg = self._uni.config
        self._eff_algo = self._eff_cfg.algorithm
        self._eff_season = self._eff_cfg.season_steps
        # multivariate selectors route multi-alias docs to joint models;
        # once their fits are cached those docs re-check on the joint
        # columnar path (FOREMAST_JOINT_COLUMNAR=0 keeps them on the
        # object path)
        self._mv = self.config.algorithm in MULTIVARIATE_ALGOS
        self._mvj = self.judge
        self._joint_fast = self._mv and os.environ.get("FOREMAST_JOINT_COLUMNAR", "1") == "1"
        # joint-doc admission cache: doc.id -> [end_epoch, jinfo, token];
        # token is the (joint cache, joint meta) version pair,
        # revalidated per entry by identity on a version bump
        self._jadmit: dict = {}
        # fast-path admission cache: doc.id -> [end_epoch, rowsinfo,
        # ops, token, has_base]; token is the (fit, gap) cache-version
        # pair at last validation. A token match trusts the entry
        # wholesale; a mismatch revalidates PER ROW by entry identity
        # (one dict peek + `is` compare each) instead of discarding the
        # whole cache — a churning fleet bumps the version every tick.
        self._admit: dict = {}
        self._gap_sensitive = self._eff_algo in GAP_SENSITIVE_FITS
        # canary columnar path: baseline-carrying univariate docs ride
        # the fast tick as their own bucket (a second [B, tc] baseline
        # buffer through the pairwise-active columnar program).
        # FOREMAST_CANARY_COLUMNAR=0 opts out: they take the object path.
        self._canary_fast = (
            os.environ.get("FOREMAST_CANARY_COLUMNAR", "1") == "1"
        )
        # cumulative columnar-path doc counts per model kind ("baseline"
        # is the canary bucket)
        self._fast_kinds = {"univariate": 0, "bivariate": 0, "lstm": 0, "baseline": 0}
        # per-document decoded config/endTime metadata (immutable per doc
        # id — see _doc_meta) and per-fit-key gap anchors (step, last
        # hist timestamp) for the history-free warm path
        self._meta_cache = ModelCache(max(4096, 2 * claim_limit))
        self._gap_meta = ModelCache(max(4096, 8 * claim_limit))
        # slow-path doc-chunk size (progressive cold admission)
        self.cold_chunk_docs = int(
            os.environ.get("FOREMAST_COLD_CHUNK_DOCS", "1024")
        )
        # slow-path chunk pipeline depth: chunks in flight across
        # fetch/judge/write (1 = serial)
        self.pipeline_depth = int(
            os.environ.get("FOREMAST_PIPELINE_DEPTH", "2")
        )
        # One persistent fetch pool per worker (per-doc query_range
        # fan-out within a chunk), not one pool per chunk per tick;
        # built lazily so in-memory sources never spawn threads.
        self.fetch_workers = max(
            1, int(os.environ.get("FOREMAST_FETCH_WORKERS", "16"))
        )
        self._fetch_pool = None
        self._prefetch_pool = None
        self._last_pipeline: dict | None = None
        # Ring-first cold path: when the source serves historical ranges
        # from resident ring columns (ingest.RingSource.hist_columns,
        # duck-typed like ingest_debug_state), cold fits read the ring
        # directly and the history cache below is BYPASSED for
        # ring-covered ranges: it would double-buffer ~120 KB histories
        # the ring already owns. The cache shrinks to a sliver serving
        # only fallback-path (HTTP) reads; /debug/state shows the
        # decision (`cold_start.hist_bypass`).
        self._ring_hist = getattr(source, "hist_columns", None)
        self._hist_bypass = self._ring_hist is not None
        # pure push: a ring source with no fallback never does HTTP; its
        # unservable reads come back empty and count "unserved", not
        # "http" (operators read the http count as proof a pull path
        # exists)
        self._cold_unserved = self._hist_bypass and getattr(source, "fallback", object()) is None
        # Short-history admission + background refinement: the ledger of
        # provisional fits and the per-tick upgrade budget. Refinement
        # INVALIDATES a provisional fit when its ring coverage grew
        # enough; the next claim refits it from the ring through the
        # production slow path (band parity by construction).
        self.refine_docs_per_tick = refine_docs_per_tick_from_env()
        self._refine_book = RefineBook()
        # Historical-window cache for the re-check loop (SURVEY "hard
        # part" (d)): a job's historical URL is fixed for its lifetime,
        # so a job re-checked every tick until endTime need not re-fetch
        # ~10k-point histories each time. Only settled ranges are cached
        # (see _fetch_hist_cached).
        self._hist_cache = ModelCache(
            max(8, HIST_CACHE_ENTRIES // 16) if self._hist_bypass else HIST_CACHE_ENTRIES
        )
        # cold-path historical-read accounting (fetch-pool threads write,
        # debug_state reads — lock-guarded)
        self._cold_lock = threading.Lock()
        self._cold_counts = {"ring_full": 0, "ring_partial": 0, "http": 0, "cache": 0, "unserved": 0}
        # Span tracer: tick() opens a root span and every stage — claim,
        # fetch, fit, arena, score, decode, decide, write — parents to
        # it through the ambient-context helper. None = zero overhead.
        self.tracer = tracer
        # optional Prometheus families (observe.gauges.WorkerMetrics)
        self.metrics = metrics
        # FitJournal per journaled cache (enable_fit_persistence), and
        # the ring snapshotter the CLI attaches (attach_ring_snapshotter)
        self._fit_journals: dict = {}
        self._snapshotter = None
        self._last_tick = {"at": 0.0, "docs": 0, "fast": 0, "seconds": 0.0}
        # last status logged per open job (pruned on terminal): open docs
        # are re-judged every poll, and re-asserting an unchanged status
        # at INFO would flood logs at fleet scale
        self._judged_status: dict[str, str] = {}
        self._JUDGED_STATUS_CAP = 16384
        # Graceful degradation: write-behind buffer for store outages,
        # per-tick deadline, breaker registry + shared counters. The
        # write-behind age cap is the stuck window, so a late replay can
        # never double-write a doc a peer's claim-CAS takeover re-judged.
        self._degrade = (
            degrade
            if degrade is not None
            else Degradation.from_env(
                max_stuck_seconds=self.config.max_stuck_seconds
            )
        )
        self._tick_deadline: float | None = None
        # the current tick's claim instant (monotonic): write-behind
        # entries are stamped with THIS, not with the write-failure
        # time — stuck-takeover eligibility runs off the claim's
        # modified_at, so the buffer's age cutoff must measure from it
        self._tick_claim_mono = time.monotonic()
        # one WARNING per degradation episode, not per buffered write
        self._write_degraded = False
        # Reactive plane: the receiver-fed dirty-series set. When wired,
        # `micro_tick()` drains it between full ticks, claiming JUST the
        # dirty documents through the same _tick body (columnar fast path
        # for warm docs, slow pipeline for cold), and full ticks demote to
        # sweeps that drain whatever arrivals the micro-ticks missed.
        # `_ledger` is the innermost live cycle's route-key -> arrival
        # stamp map; every judged doc whose route key is pending observes
        # the push->verdict latency (foremast_verdict_latency_seconds).
        self.dirty = dirty
        # Worker mesh (mesh/node.py): every claim cycle renews this worker's
        # lease and refreshes its rings, and the base claim filter (doc ->
        # bool) is the mesh's partition filter, None without a mesh; a
        # micro-tick's dirty-key restriction composes with it
        self.mesh = mesh
        self.claim_filter = mesh.claim_filter if mesh is not None else None
        self.microtick_seconds = microtick_seconds_from_env()
        self.microtick_docs = microtick_docs_from_env()
        self._ledger = _TickLedger("sweep")
        self._last_micro = {"at": 0.0, "docs": 0, "seconds": 0.0, "runs": 0}
        # Sliced, preemptible sweeps: claims above this size run as
        # bounded slices through the warm-path pipeline, with a
        # dirty-drain preemption point between slices; 0 = monolithic
        self.sweep_slice_docs = sweep_slice_docs_from_env()
        self._last_sweep: dict | None = None
        # True while a sliced sweep is in flight: pins _tick_claim_mono at
        # the sweep's claim instant (see _claim_cycle)
        self._sweep_active = False
        # Tenant QoS plane (FOREMAST_TENANTS): tenant resolution for the
        # verdict-latency histogram's bounded `tenant` label, per-tenant
        # claim accounting, and — with >= 2 tenants configured —
        # deficit-weighted fair slice ordering in the sweep pool. None
        # keeps every path untenanted and byte-identical (the parity pin).
        from foremast_tpu_torch.tenant.registry import get_tenancy

        self._tenancy = get_tenancy()
        self._tenant_acct = None
        if self._tenancy is not None:
            from foremast_tpu_torch.tenant.accounting import accounting_for
            from foremast_tpu_torch.tenant.collector import register_collector

            self._tenant_acct = accounting_for(self._tenancy)
            # export the ledger on this worker's scrape registry (the
            # receiver shares the same per-tenancy ledger, so its sheds
            # ride along); idempotent across co-registered workers
            if self.metrics is not None:
                register_collector(getattr(self.metrics, "registry", None), self._tenant_acct)
        # a mesh node carrying a handoff plane moves this worker's fit
        # caches with its partition on planned scale events
        if mesh is not None and getattr(mesh, "handoff", None) is not None:
            self.attach_handoff(mesh.handoff)

    # -- preprocess: document -> MetricTasks ----------------------------

    def _doc_meta(self, doc: Document):
        """Per-document decoded metadata, cached by document id.

        A document's id is the HMAC of its app/times/configs
        (`elasticsearchstore.go:29`), so the decoded config strings,
        per-alias metric types, historical end epochs and the parsed
        endTime are immutable per id. Entries: (aliases, end_epoch, ops)
        where aliases is a list of (alias, cur_url, metric_type,
        base_url, hist_url, key, hist_end_epoch, fullkey) and ops the
        [3, n] (threshold, bound, min_lower_bound) block of the doc's
        rows."""
        meta = self._meta_cache.peek(doc.id)
        if meta is not None:
            return meta
        cur = promql.decode_config(doc.current_config)
        base = promql.decode_config(doc.baseline_config)
        hist = promql.decode_config(doc.historical_config)
        aliases = []
        ops = np.empty((3, len(cur)), np.float32)
        for i, (alias, cur_url) in enumerate(cur.items()):
            hist_url = hist.get(alias)
            mtype = infer_metric_type(alias, self._eff_cfg)
            rule = self._eff_cfg.anomaly.rule_for(mtype)
            ops[0, i] = rule.threshold
            ops[1, i] = rule.bound
            ops[2, i] = rule.min_lower_bound
            # immutable history => the fitted model is immutable too;
            # key it per (app, alias, URL)
            key = f"{doc.app_name}|{alias}|{hist_url}" if hist_url else None
            aliases.append(
                (
                    alias,
                    cur_url,
                    mtype,
                    base.get(alias),
                    hist_url,
                    key,
                    _hist_end_epoch(hist_url) if hist_url else None,
                    # the full fit-cache key, prebuilt once
                    (self._eff_algo, self._eff_season, key) if key else None,
                )
            )
        meta = (aliases, parse_time(doc.end_time), ops)
        self._meta_cache.put(doc.id, meta)
        return meta

    def _fetch_tasks(self, doc: Document, now: float):
        """Fetch every window of every alias; None => preprocess failure
        (permanent), the RELEASED sentinel => transient dependency
        failure, give the doc back un-judged."""
        aliases, _, _ = self._doc_meta(doc)
        if not aliases:
            return None
        tasks = []
        # the history-free warm shortcut serves only the univariate judge:
        # joint models align histories across metrics and fit their own
        # state, so an empty-history task would collapse the joint fit
        may_skip_hist = not self._mv or len(aliases) == 1
        # aliases whose history came back as a PARTIAL ring slice this
        # fetch (short-history admission): noted in the refine book after
        # the loop so the fit they produce is tracked provisional
        partials: list[tuple] = []
        try:
            for (
                alias,
                cur_url,
                mtype,
                base_url,
                hist_url,
                key,
                hist_end,
                fullkey,
            ) in aliases:
                ct, cv = self.source.fetch(cur_url)
                fit_key = None
                step_kw = {}
                if hist_url is not None:
                    settled = (
                        hist_end is not None
                        and hist_end <= now - HIST_SETTLED_SECONDS
                    )
                    if settled:
                        fit_key = key
                        entry = self._fit_cache.get(fullkey) if may_skip_hist else None
                        gap = (
                            self._gap_meta.get(key)
                            if self._gap_sensitive
                            else None
                        )
                        if entry is not None and (
                            gap is not None or not self._gap_sensitive
                        ):
                            # warm: the fitted state is cached, so the
                            # task needs no history — skip the fetch and
                            # attach the ENTRY itself (it cannot be
                            # evicted from under the task) plus, for
                            # seasonal fits, the gap anchors
                            ht, hv = _EMPTY_TIMES, _EMPTY_VALUES
                            step_kw = dict(fit_entry=entry)
                            if gap is not None:
                                step_kw.update(
                                    hist_step=gap[0], hist_last_t=gap[1]
                                )
                        else:
                            ht, hv, prov = self._fetch_hist(hist_url, now)
                            if prov:
                                partials.append((fullkey, key, hist_url, len(ht)))
                            if len(ht) and self._gap_sensitive:
                                self._gap_meta.put(
                                    key, (infer_step(ht), float(ht[-1]))
                                )
                    else:
                        # mutable range: fetch fresh every tick, never
                        # cache the series or the fit
                        ht, hv = self.source.fetch(hist_url)
                else:
                    ht, hv = ct[:0], cv[:0]
                kw = {}
                if base_url is not None:
                    bt, bv = self.source.fetch(base_url)
                    kw = dict(base_times=bt, base_values=bv)
                tasks.append(
                    MetricTask(
                        job_id=doc.id,
                        alias=alias,
                        metric_type=mtype,
                        hist_times=ht,
                        hist_values=hv,
                        cur_times=ct,
                        cur_values=cv,
                        app=doc.app_name,
                        fit_key=fit_key,
                        **step_kw,
                        **kw,
                    )
                )
        except Exception as e:  # fetch failures fail the preprocess stage
            if is_transient_error(e):
                # dependency outage / breaker open: release un-judged
                # (claimable next tick) instead of terminal failure
                log.warning(
                    "preprocess released (transient) for %s: %s", doc.id, e
                )
                return RELEASED
            log.warning("preprocess failed for %s: %s", doc.id, e)
            return None
        if partials:
            if may_skip_hist:
                # univariate fits: one provisional record per fit key
                for fullkey, key, url, n in partials:
                    self._refine_book.note_uni(fullkey, key, url, n)
            else:
                # joint doc: one record for the doc (its joint cache keys
                # resolve through the admission cache, or by app when the
                # doc never warmed, at invalidation time)
                self._refine_book.note_joint(
                    doc.id, doc.app_name, tuple(u for _, _, u, _ in partials), sum(n for _, _, _, n in partials)
                )
        return tasks

    def _count_cold(self, source: str) -> None:
        """One historical-range read on the cold-fit path, by source
        (ring_full / ring_partial / http / cache / unserved). Fetch-pool
        threads land here, hence the lock."""
        with self._cold_lock:
            self._cold_counts[source] += 1
        if self.metrics is not None:
            self.metrics.cold_hist.labels(source=source).inc()

    def _fetch_hist(self, url: str, now: float):
        """Historical window for a cold fit: ring columns first, HTTP
        second. Returns (times, values, provisional): provisional is True
        when the window is a PARTIAL ring slice under short-history
        admission whose coverage can still grow inside the requested
        range (the caller notes it in the refine book).

        A ring read bypasses `_hist_cache` entirely: the ring IS the
        resident history (one slice copy under the shard lock, no JSON),
        and the bf16-delta fit packs straight off the returned columns.
        Only ranges the ring cannot serve go through the settled-range
        cache to the source's `fetch`, whose fallback result backfills
        the ring write-through, so the NEXT cold fit of the same series
        reads resident."""
        if self._ring_hist is not None:
            res = self._ring_hist(url, now)
            if res is not None:
                status, ht, hv, cov, window = res
                if status == "full":
                    self._count_cold("ring_full")
                    return ht, hv, False
                self._count_cold("ring_partial")
                t1 = window[1]
                # provisional iff in-window data can still arrive: the
                # window head is not yet covered. A slice whose head IS
                # covered is terminal; marking it provisional would re-note
                # every finalized refit back into the book
                return ht, hv, t1 is None or cov[1] < t1
        series, hit = self._fetch_hist_cached(url, now)
        self._count_cold("cache" if hit else "unserved" if self._cold_unserved else "http")
        return series[0], series[1], False

    def _fetch_hist_cached(self, url: str, now: float):
        """Fetch a settled historical window, memoized by URL; returns
        (series, cache_hit).

        Only called for provably immutable ranges (the caller checks the
        range's end against `now` - HIST_SETTLED_SECONDS: REST clients
        may supply arbitrary params, and a range whose end lies in the
        future or too close to `now` for ingestion to have settled is
        fetched fresh every tick and never cached, series or fit).
        `now` is the tick's injectable clock."""
        cached = self._hist_cache.get(url)
        if cached is not None:
            return cached, True
        series = self.source.fetch(url)
        # pure push: an unservable range comes back EMPTY, not fetched;
        # memoizing it would make every later read of the same URL count
        # "cache" (a served history) while the doc sits UNKNOWN
        if not (self._cold_unserved and len(series[0]) == 0):
            self._hist_cache.put(url, series)
        return series, False

    # -- postprocess: verdicts -> document status -----------------------

    def _decide_status(
        self,
        doc: Document,
        job_verdict: int,
        anomaly_values: dict,
        now: float,
        end: float,
    ) -> None:
        """Shared status transition for the object and columnar paths —
        one source of truth for the reference's state machine
        (`converter.go:13-26`, fail-fast per `design.md:43`). Mutates the
        doc; the caller persists."""
        # a missing/unparseable endTime must not make the job immortal:
        # finalize on the first judgment instead of re-checking forever
        past_end = end <= 0 or now >= end
        if job_verdict == UNHEALTHY:
            # fail fast (design.md:43)
            doc.status = STATUS_COMPLETED_UNHEALTH
            doc.status_code = "200"
            doc.reason = "anomaly detected"
            doc.anomaly_info = AnomalyInfo(
                tags="", values=anomaly_values
            ).to_json()
        elif past_end:
            # window closed with no anomaly: healthy unless nothing measured
            if job_verdict == UNKNOWN:
                doc.status = STATUS_COMPLETED_UNKNOWN
                doc.reason = "insufficient data"
            else:
                doc.status = STATUS_COMPLETED_HEALTH
                doc.reason = ""
            doc.status_code = "200"
        else:
            # keep re-checking until endTime (incremental re-check loop)
            doc.status = STATUS_PREPROCESS_COMPLETED

    def _write_back(
        self, doc: Document, verdicts: list[MetricVerdict], now: float
    ) -> Document:
        job_verdict = combine_verdicts(verdicts)
        end = self._doc_meta(doc)[1]  # parsed once per doc, not per tick
        values = {}
        if job_verdict == UNHEALTHY:
            values = {
                v.alias: v.anomaly_pairs for v in verdicts if v.anomaly_pairs
            }
        self._decide_status(doc, job_verdict, values, now, end)
        return self._store_update(doc)

    def warmup(self, hist_len: int = 10_080, cur_len: int = 30) -> None:
        """Build the kernels and run the tick's programs once — a cold
        fit, a warm object judgment and a columnar judgment of
        `_MIN_BUCKET` synthetic windows at the reference workload shape
        (10,080-pt history, 30-pt current, `metricsquery.go:43,75-77`) —
        on a separate judge with its own fit cache and arena, so the real
        caches and arenas stay untouched and the first production tick
        pays no build."""
        t_start = time.perf_counter()
        if self.judge.device.type == "cuda":
            from foremast_tpu_torch.ops import _build

            _build.build_all()
        trial = HealthJudge(self._eff_cfg, device=self.judge.device)
        trial.fit_cache = ModelCache(4 * _MIN_BUCKET)
        trial.band_mode = self._uni.band_mode
        rng = np.random.default_rng(0)
        t0 = int(time.time()) - 86_400 * 8
        ht = t0 + 60 * np.arange(hist_len, dtype=np.int64)
        ct = ht[-1] + 60 + 60 * np.arange(cur_len, dtype=np.int64)
        hv = rng.normal(1.0, 0.1, (_MIN_BUCKET, hist_len)).astype(np.float32)
        cv = rng.normal(1.0, 0.1, (_MIN_BUCKET, cur_len)).astype(np.float32)
        tasks = [
            MetricTask(
                job_id=f"__warmup__{i}",
                alias="__warmup__",
                metric_type=None,
                hist_times=ht,
                hist_values=hv[i],
                cur_times=ct,
                cur_values=cv[i],
                fit_key=f"__warmup__|{i}",
            )
            for i in range(_MIN_BUCKET)
        ]
        trial.judge(tasks)
        trial.judge(tasks)
        keys = [(self._eff_algo, self._eff_season, t.fit_key) for t in tasks]
        tc = bucket_length(cur_len)
        values = np.zeros((_MIN_BUCKET, tc), np.float32)
        mask = np.zeros((_MIN_BUCKET, tc), bool)
        values[:, :cur_len] = cv
        mask[:, :cur_len] = True
        thr, bnd, mlb = self.config.anomaly.gather([None] * _MIN_BUCKET)
        trial.judge_columnar(
            values,
            mask,
            keys,
            [trial.fit_cache.peek(k) for k in keys],
            np.full(_MIN_BUCKET, cur_len - 1, np.int32),
            thr,
            bnd,
            mlb,
            with_bands=self.on_verdict is not None,
        )
        trial.clear_device_state()
        log.info(
            "warmup ran the cold, warm and columnar programs (Th=%d Tc=%d, "
            "algorithm=%s) in %.1fs",
            hist_len, cur_len, self._eff_algo, time.perf_counter() - t_start,
        )

    # -- persistent thread pools -----------------------------------------

    def _fetch_pool_get(self):
        """The worker's persistent metric-fetch pool (sized by
        `FOREMAST_FETCH_WORKERS`). Tick-thread + prefetch-thread use
        only; lazy so sources with `concurrent_fetch = False` never
        spawn threads."""
        if self._fetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._fetch_pool = ThreadPoolExecutor(
                max_workers=self.fetch_workers,
                thread_name_prefix="foremast-fetch",
            )
        return self._fetch_pool

    def _prefetch_pool_get(self):
        """Chunk-level prefetch pool for the tick pipeline — separate
        executor from the per-doc fetch pool so a chunk job fanning its
        docs over `_fetch_pool` can never deadlock waiting on its own
        pool's slots."""
        if self._prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=max(1, self.pipeline_depth - 1),
                thread_name_prefix="foremast-prefetch",
            )
        return self._prefetch_pool

    def close(self) -> None:
        """Shut down the persistent thread pools and close the fit
        journals. Idempotent, and the worker stays usable afterwards
        (pools rebuild lazily)."""
        for attr in ("_fetch_pool", "_prefetch_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
                setattr(self, attr, None)
        for journal in self._fit_journals.values():
            journal.close()
        self._fit_journals = {}

    # -- durable fit state -----------------------------------------------

    def enable_fit_persistence(self, directory: str) -> dict:
        """Mount write-through fit journals under `directory`: restore
        each cache's persisted terminal states (staged for LAZY
        rehydration: the first claim of a document pulls its fits back
        in, so admission passes without an HTTP history re-fetch), then
        attach write-through so every completed fit persists the moment
        the judge caches it. Returns per-journal restore counts.

        Journaled caches: the univariate fit cache and its gap anchors,
        the provisional-fit refine book (the journals restore a
        short-history FIT warm, so the restored doc takes the fast path
        and nothing would ever re-note it: without its own journal the fit
        would stay parked at the admitted history instead of refining to
        the full window), and the joint entry cache and its warm
        metadata. NOT journaled: the history cache (re-fetchable), the
        per-doc meta cache (derived from immutable configs) and the device
        arena (it rehydrates row by row from the restored fit cache)."""
        from foremast_tpu_torch.models.cache import FitJournal

        os.makedirs(directory, exist_ok=True)
        pairs = [
            ("fits", self._fit_cache),
            ("gaps", self._gap_meta),
            ("refine", self._refine_book),
            ("joint", self._mvj.cache),
            ("jmeta", self._mvj.joint_meta),
        ]
        restored = {}
        for name, cache in pairs:
            journal = FitJournal(os.path.join(directory, f"fit-{name}"))
            restored[name] = cache.restore_lazy(journal.restore())
            journal.attach(cache)
            self._fit_journals[name] = journal
        if any(restored.values()):
            log.info("fit persistence: restored %s from %s (lazy rehydration)", restored, directory)
        return restored

    def attach_handoff(self, handoff) -> None:
        """Register this worker's fit caches with the mesh handoff plane:
        the caches `enable_fit_persistence` journals, because what must
        survive a restart and what must move with a partition are the same
        state (the univariate fits and their gap anchors, the refine book,
        the joint entries and their warm metadata). The device arena is not
        transferred: it rehydrates row by row from the moved fits on the new
        owner's first claim."""
        handoff.register_caches(
            {
                "fits": self._fit_cache,
                "gaps": self._gap_meta,
                "refine": self._refine_book,
                "joint": self._mvj.cache,
                "jmeta": self._mvj.joint_meta,
            }
        )

    def attach_ring_snapshotter(self, snapshotter) -> None:
        """Expose an ingest.snapshot.RingSnapshotter on /debug/state
        and fold its cadence into the tick loop (`_maybe_persist`)."""
        self._snapshotter = snapshotter

    def _maybe_persist(self) -> None:
        """Per-tick durability housekeeping: compact any fit journal whose
        log outgrew its budget, and let the ring snapshotter decide
        whether a snapshot pass is due. Failures are logged, never
        allowed to fail a tick that already judged its docs."""
        try:
            for journal in self._fit_journals.values():
                journal.maybe_compact()
            if self._snapshotter is not None:
                self._snapshotter.maybe_snapshot()
        except Exception:  # noqa: BLE001 - durability must not kill ticks
            log.exception("durability housekeeping failed")

    # -- background refinement of provisional fits ------------------------

    def _count_refine(self, result: str) -> None:
        if self.metrics is not None:
            self.metrics.refine_docs.labels(result=result).inc()

    def _refine_provisional(self, now: float) -> int:
        """Upgrade provisional fits whose ring coverage grew (idle and
        all-warm sweeps only: a busy slow-path tick already has cold fits
        to pay for). Bounded to `refine_docs_per_tick` records a pass;
        each upgrade is an INVALIDATION, so the next claim refits the doc
        from the (larger) ring window through the production slow path
        and a refined fit equals a from-scratch fit on the same columns.
        Returns #invalidated."""
        book = self._refine_book
        if not len(book) or self._ring_hist is None:
            return 0
        if self.mesh is not None and getattr(self.mesh, "draining", False):
            # a draining mesh member streams its fits to the new owners: an
            # invalidation now would hand them a hole to cold-refit. The
            # refine book moves with the handoff, so the new owner resumes
            # the pacing instead
            return 0
        probe = getattr(self.source, "hist_coverage", None)
        if probe is None:
            return 0
        upgraded = 0
        for bkey, rec in book.take(self.refine_docs_per_tick):
            states = [probe(u, now) for u in rec["urls"]]
            if any(s is None for s in states):
                # unresolvable URL: no series identity to ever pace
                book.drop(bkey, "dropped")
                continue
            if any(s[0] is None for s in states):
                # no serving span RIGHT NOW (pusher pause past the
                # staleness cutoff, eviction): pacing pauses but the
                # record STAYS, since the short-history fit is still warm
                # and no cold claim will re-note it. take() already
                # rotated the record to the back
                continue
            n_now = sum(s[1] for s in states)
            closed = all(s[0] == "full" or (s[3][1] is not None and s[2][1] >= s[3][1]) for s in states)
            if closed:
                # the window is fully covered (or its head is past: nothing
                # more can arrive inside it). A TERMINAL refit only when the
                # resident data grew past the admitted fit; either way the
                # record settles, and "finalized" counts only refits paid
                if n_now > rec["points"]:
                    self._invalidate_provisional(bkey, rec)
                    upgraded += 1
                    book.drop(bkey, "finalized")
                    self._count_refine("finalized")
                else:
                    book.drop(bkey, "settled")
                    self._count_refine("settled")
            elif book.due(rec["points"], n_now):
                self._invalidate_provisional(bkey, rec)
                book.refit(bkey, n_now)
                self._count_refine("refit")
                upgraded += 1
        if self.metrics is not None:
            self.metrics.provisional.set(len(book))
        if upgraded:
            log.info(
                "refinement: invalidated %d provisional fit(s) for refit from the ring (%d still pending)",
                upgraded, len(book),
            )
        return upgraded

    def _invalidate_provisional(self, bkey: tuple, rec: dict) -> None:
        """Drop a provisional fit's cached state so the next claim refits
        from the ring. The version bumps make the fast-path admission
        caches revalidate and demote the doc to the slow path for exactly
        one refit tick."""
        if rec["kind"] == "uni":
            self._fit_cache.pop(rec["fullkey"])
            if self._gap_sensitive:
                self._gap_meta.pop(rec["gap_key"])
            return
        # joint: resolve the cache keys through the admission cache
        jad = self._jadmit.pop(rec["doc_id"], None)
        if jad is not None:
            jinfo = jad[1]
            self._mvj.cache.pop(jinfo[3])
            self._mvj.joint_meta.pop(jinfo[5])
            return
        # never fast-path-admitted (columnar off, or refinement fired
        # before the doc's second claim): the slow path's joint cache key
        # carries no history content, so its short-history fit would be
        # served FOREVER unless popped; invalidate by app. Joint cache
        # keys are (mode, app, ...), meta keys ("jmeta", mode, app, ...);
        # over-matching sibling docs of the same app costs them one extra
        # refit, never a wrong verdict
        app = rec.get("app")
        if app is None:
            return
        self._mvj.cache.pop_where(lambda k: isinstance(k, tuple) and len(k) > 1 and k[1] == app)
        self._mvj.joint_meta.pop_where(
            lambda k: isinstance(k, tuple) and len(k) > 2 and k[0] == "jmeta" and k[2] == app
        )

    # -- degraded store writes -------------------------------------------

    def _store_update(
        self, doc: Document, claim_mono: float | None = None
    ) -> Document:
        """`store.update` with write-behind degradation: a TRANSIENT
        store failure (connection/timeout, 429/5xx, breaker open) parks
        the doc in the bounded buffer for replay instead of failing the
        tick; permanent errors propagate. `claim_mono` is the doc's
        claim instant for the write-behind age stamp: a sliced sweep
        passes each slice's own claim time so a late slice can never
        inherit a fresher stamp from a nested micro-tick's claim (default:
        this tick's, `_tick_claim_mono`)."""
        try:
            doc = self.store.update(doc)
            self._write_degraded = False
            return doc
        except Exception as e:
            if not is_transient_error(e):
                raise
            self._note_write_degraded(e)
            self._degrade.write_behind.add(
                [doc],
                now=(
                    self._tick_claim_mono
                    if claim_mono is None
                    else claim_mono
                ),
            )
            return doc

    def _store_update_many(
        self, docs: list[Document], claim_mono: float | None = None
    ) -> None:
        """Batched `_store_update` (the fast tick's write-back path)."""
        if not docs:
            return
        try:
            self.store.update_many(docs)
            self._write_degraded = False
        except Exception as e:
            if not is_transient_error(e):
                raise
            self._note_write_degraded(e)
            self._degrade.write_behind.add(
                docs,
                now=(
                    self._tick_claim_mono
                    if claim_mono is None
                    else claim_mono
                ),
            )

    def _note_write_degraded(self, e: BaseException) -> None:
        if not self._write_degraded:
            log.warning(
                "store write failed transiently (%s: %s); degrading to "
                "write-behind — verdicts buffer locally and replay when "
                "the store heals",
                type(e).__name__, e,
            )
            self._write_degraded = True
        self._degrade.stats.count_event("store", "write_error")

    def _flush_write_behind(self) -> None:
        """Replay the write-behind backlog (tick start). Entries that
        aged past the stuck window were dropped by `drain` — claim-CAS
        takeover owns those docs now."""
        buf = self._degrade.write_behind
        if not len(buf):
            return
        # headroom for the replay RPC itself: an entry that passes the
        # age check must also LAND inside the stuck window, so the
        # drain cutoff advances by the store's round-trip bound (capped
        # at a third of the window so tiny test windows keep working)
        margin = min(
            float(getattr(self.store, "timeout", 10.0) or 10.0),
            buf.max_age_seconds / 3.0,
        )
        entries = buf.drain(margin=margin)
        if not entries:
            return
        docs = [d for _, d in entries]
        try:
            self.store.update_many(docs)
        except Exception as e:
            buf.requeue(entries)
            if not is_transient_error(e):
                raise
            return
        self._write_degraded = False
        self._degrade.stats.count_docs(REASON_REPLAYED, len(docs))
        self._degrade.stats.count_event("store", "replay_flush")
        log.info(
            "write-behind replay: %d buffered doc(s) flushed to the "
            "recovered store", len(docs),
        )

    def _release_docs(
        self,
        docs: list[Document],
        reason: str,
        led: _TickLedger | None = None,
        claim_mono: float | None = None,
    ) -> None:
        """Partial-tick semantics: give docs back un-judged (status →
        preprocess_completed, claimable next tick) and count them —
        never wedge a tick behind a slow dependency, never terminally
        fail a doc for a dependency's transient sin."""
        if not docs:
            return
        led = self._ledger if led is None else led
        for doc in docs:
            doc.status = STATUS_PREPROCESS_COMPLETED
        self._store_update_many(docs, claim_mono=claim_mono)
        self._degrade.stats.count_docs(reason, len(docs))
        # reactive: a released doc's pending arrival goes BACK to the dirty
        # set with its ORIGINAL stamp, so a brownout mid-micro-tick does not
        # lose the arrival and the eventual verdict still measures from the
        # push's receive instant
        if led.pending and self.dirty is not None:
            for doc in docs:
                rk = doc_route_key(doc)
                stamp = led.pending.pop(rk, None)
                if stamp is not None:
                    self.dirty.mark(rk, stamp, requeue=True)
        log.warning(
            "released %d doc(s) un-judged (%s); they stay claimable "
            "for the next tick", len(docs), reason,
        )

    def _deadline_exceeded(self) -> bool:
        return (
            self._tick_deadline is not None
            and time.perf_counter() > self._tick_deadline
        )

    # -- columnar fast path ---------------------------------------------

    def _revalidate(self, cached, token) -> bool:
        """Per-row admission revalidation after a cache-version bump.

        The cached rowsinfo holds the ENTRY OBJECTS it was admitted
        with; the fit (and gap anchors, for seasonal fits) are still
        current iff the caches hold those same objects — one peek + `is`
        compare per row. Stamps the entry with the new token on success
        so the next stable tick is free again. Stale rows (refit under
        the same key, or evicted) fail and the caller re-walks just this
        document's admission."""
        peek = self._fit_cache.peek
        gpeek = self._gap_meta.peek if self._gap_sensitive else None
        for r in cached[1]:
            if peek(r[2]) is not r[3]:
                return False
            if gpeek is not None and gpeek(r[2][2]) is not r[4]:
                return False
        cached[3] = token
        return True

    def _account_fast_kinds(self, kind_counts: dict) -> None:
        """Fold one tick's columnar doc counts into the cumulative
        per-bucket counters (debug_state) and the WorkerMetrics family."""
        for kind, n in kind_counts.items():
            if not n:
                continue
            self._fast_kinds[kind] += n
            if self.metrics is not None:
                self.metrics.fast_docs.labels(kind=kind).inc(n)

    # -- joint (multi-alias) columnar path --------------------------------

    def _admit_joint(self, doc, aliases, end_epoch, now: float, jtoken):
        """Joint-doc admission: (doc, end_epoch, jinfo) when this
        multi-alias doc's joint fit and warm metadata are cached and every
        alias clears the univariate path's gates (no baseline, settled
        history); None routes it to the slow path.

        jinfo: (mode, alias names, cur urls, cache_key, entry, meta_key,
        meta) — the entry/meta OBJECTS, so revalidation after a version
        bump is one identity compare each."""
        if not self._joint_fast:
            return None
        cached = self._jadmit.get(doc.id)
        if cached is not None and (cached[2] == jtoken or self._revalidate_joint(cached, jtoken)):
            return (doc, cached[0], cached[1])
        mode = select_mode(self.config.algorithm, len(aliases))
        if mode == "univariate":
            # metric-count misfit (e.g. 3 aliases under bivariate_normal):
            # the object path scores these per alias
            return None
        names, urls, hkeys = [], [], []
        for alias, cur_url, _mtype, base_url, hist_url, key, hist_end, _fullkey in aliases:
            if (
                base_url is not None
                or hist_url is None
                or key is None
                or hist_end is None
                or hist_end > now - HIST_SETTLED_SECONDS
            ):
                return None
            names.append(alias)
            urls.append(cur_url)
            hkeys.append(key)
        peek = self._mvj.columnar_joint_peek(mode, doc.app_name, tuple(names), tuple(hkeys))
        if peek is None:
            return None
        jinfo = (mode, tuple(names), tuple(urls)) + peek
        self._jadmit[doc.id] = [end_epoch, jinfo, jtoken]
        return (doc, end_epoch, jinfo)

    def _revalidate_joint(self, cached, token) -> bool:
        """The cached jinfo still holds the entry/meta objects the judge's
        caches hold: restamp it with the new token."""
        jinfo = cached[1]
        if self._mvj.cache.peek(jinfo[3]) is not jinfo[4]:
            return False
        if self._mvj.joint_meta.peek(jinfo[5]) is not jinfo[6]:
            return False
        cached[2] = token
        return True

    def _demote_to_slow(self, slow: list, demoted: list, why: str) -> None:
        """Route fast-tick demotions (an admitted doc the columnar program
        can no longer score) back onto the slow path, counted on the
        degraded-docs counter."""
        if not demoted:
            return
        slow.extend(demoted)
        self._degrade.stats.count_docs(REASON_DEMOTED, len(demoted))
        log.info("fast path demoted %d doc(s) to the slow path (%s)", len(demoted), why)

    def _judge_joint_fast(self, ok_joint, now: float):
        """Columnar warm judgment of admitted joint docs.

        Aligns each doc's current windows (strictly increasing, identical
        stamps short-circuit the intersect), groups by (model kind,
        feature count), and runs ONE arena-gathered program per group
        (`MultivariateJudge.joint_columnar`). Statuses and anomaly pairs
        replicate the object path's `_emit`; an LSTM doc whose window
        bucket drifted from the fitted one is DEMOTED to the slow path
        (refit). Returns (updated_docs, demoted_docs, per-kind counts)."""
        hook = self.on_verdict
        judge = self._mvj
        thr = float(np.float32(judge.config.anomaly.rule_for(None).threshold))
        updated: list = []
        demoted: list = []
        counts = {"univariate": 0, "bivariate": 0, "lstm": 0}
        groups: dict = {}
        for (doc, end_epoch, jinfo), series in ok_joint:
            mode = jinfo[0]
            times = [s[0] for s in series]
            vals = [s[1] for s in series]
            t0 = np.asarray(times[0], np.int64)
            # the shortcut needs STRICTLY increasing stamps: align_series
            # dedups repeats and sorts, and both paths must agree
            if (
                len(t0) > 0
                and bool(np.all(np.diff(t0) > 0))
                and all(len(t) == len(t0) and np.array_equal(t, t0) for t in times[1:])
            ):
                ct = t0
                cv = np.stack([np.asarray(v, np.float32) for v in vals])
            else:
                ct, cv = align_series(times, vals)
            n = len(ct)
            if n == 0:
                # no joint observation: UNKNOWN, as the object path's
                # `_unknown` (baseline-less pairwise is (1.0, False))
                self._decide_status(doc, UNKNOWN, {}, now, end_epoch)
                self._log_judged(doc)
                updated.append(doc)
                counts[mode] += 1
                if self.metrics is not None:
                    self.metrics.observe_doc(doc.status, len(jinfo[1]))
                if hook:
                    vs = [
                        MetricVerdict(
                            job_id=doc.id,
                            alias=alias,
                            verdict=UNKNOWN,
                            anomaly_pairs=[],
                            upper=np.zeros(len(vals[f_i]), np.float32),
                            lower=np.zeros(len(vals[f_i]), np.float32),
                            p_value=1.0,
                            dist_differs=False,
                        )
                        for f_i, alias in enumerate(jinfo[1])
                    ]
                    try:
                        hook(doc, vs)
                    except Exception:
                        log.exception("on_verdict hook failed for %s", doc.id)
                continue
            if mode == "lstm" and bucket_length(n) != jinfo[6][0]:
                # the window bucket drifted from the one the AE was fitted
                # at: refit on the slow path rather than mis-score
                demoted.append(doc)
                continue
            groups.setdefault((mode, len(jinfo[1])), []).append((doc, end_epoch, jinfo, ct, cv, n))

        for (mode, f), items in groups.items():
            # ONE dispatch per group, padded to its widest window bucket
            # (lstm: the fitted buckets). Exact: the AE carries state
            # through masked steps and the decoder's step-t output never
            # depends on later steps, and the MVN d^2 is causal, so
            # suffix padding changes no real point's flag.
            if mode == "lstm":
                tcb = max(it[2][6][0] for it in items)
            else:
                tcb = bucket_length(max(it[5] for it in items))
            s = len(items)
            cur = np.zeros((s, f, tcb), np.float32)
            mask = np.zeros((s, tcb), bool)
            gaps = np.zeros(s, np.int32) if mode == "lstm" else None
            keys, entries, metas = [], [], []
            for i, (doc, end_epoch, jinfo, ct, cv, n) in enumerate(items):
                cur[i, :, :n] = cv[:, :n]
                mask[i, :n] = True
                keys.append(jinfo[3])
                entries.append(jinfo[4])
                metas.append(jinfo[6])
                if mode == "lstm":
                    meta = jinfo[6]
                    k = int(round((float(ct[0]) - meta[4]) / max(meta[3], 1.0)))
                    gaps[i] = max(k - 1, 0)
            flags = judge.joint_columnar(mode, keys, entries, metas, cur, mask, gaps)
            with span("worker.decide", stage="decide", docs=s):
                for i, (doc, end_epoch, jinfo, ct, cv, n) in enumerate(items):
                    fl = flags[i, :n]
                    jv = UNHEALTHY if fl.any() else HEALTHY
                    values_map = {}
                    if jv == UNHEALTHY:
                        ft = ct[fl]
                        for f_i, alias in enumerate(jinfo[1]):
                            pairs = np.empty(2 * len(ft), np.float64)
                            pairs[0::2] = ft
                            pairs[1::2] = cv[f_i][fl]
                            values_map[alias] = pairs.tolist()
                    self._decide_status(doc, jv, values_map, now, end_epoch)
                    self._log_judged(doc)
                    updated.append(doc)
                    counts[mode] += 1
                    if self.metrics is not None:
                        self.metrics.observe_doc(doc.status, f)
                    if hook:
                        try:
                            hook(doc, self._joint_verdicts(doc, jinfo, ct, cv, n, fl, jv, thr))
                        except Exception:
                            log.exception("on_verdict hook failed for %s", doc.id)
        return updated, demoted, counts

    def _joint_verdicts(self, doc, jinfo, ct, cv, n, fl, jv, thr):
        """Hook verdicts as the object path's `_emit` gives them: per-alias
        marginal bands from the cached meta moments, the doc-wide joint
        verdict, each alias's own values at the flagged timestamps;
        pairwise (1.0, False), baseline-less by admission."""
        meta = jinfo[6]
        mu, sd = meta[1], meta[2]
        width = max(n, 1)
        up = np.repeat((mu + thr * sd)[:, None], width, axis=1).astype(np.float32)
        lo = np.repeat(np.maximum(mu - thr * sd, 0.0)[:, None], width, axis=1).astype(np.float32)
        flagged_times = ct[fl]
        out = []
        for f_i, alias in enumerate(jinfo[1]):
            pairs: list[float] = []
            for ts, v in zip(flagged_times, cv[f_i][fl]):
                pairs.extend([float(ts), float(v)])
            out.append(
                MetricVerdict(
                    job_id=doc.id,
                    alias=alias,
                    verdict=jv,
                    anomaly_pairs=pairs,
                    upper=up[f_i],
                    lower=lo[f_i],
                    p_value=1.0,
                    dist_differs=False,
                )
            )
        return out

    def _fast_tick(self, docs, now: float):
        """Columnar processing of the all-warm re-check subset.

        The steady state of the whole system is: a stable fleet of jobs
        re-checked every tick against cached fits, new data only in the
        ~30-point current windows. For that subset this path skips every
        per-task object the slow path builds — no MetricTask, no
        MetricVerdict (unless a hook wants them), no ragged packing —
        writing current windows straight into [B, tc] buffers and
        decoding verdicts with segment reductions. Baseline-carrying
        (canary) docs form their own bucket whose baseline windows fill
        a second [B, tc] buffer judged by the pairwise-active program.
        Docs that don't qualify (unsettled or absent histories, cold
        fits, canary docs under FOREMAST_CANARY_COLUMNAR=0) are returned
        for the slow path. Returns (n_processed, slow_docs)."""
        fast, fastc, fastj, slow = self._admit_fast(docs, now)
        if not fast and not fastc and not fastj:
            return 0, slow
        ok_items, ok_citems, ok_joint, failed, released = self._fetch_fast(fast, fastc, fastj)
        for doc in failed:
            self._store_update(doc)
            if self.metrics is not None:
                self.metrics.observe_doc(doc.status, 0)
        self._release_docs(released, REASON_FETCH)
        if not ok_items and not ok_citems and not ok_joint:
            return len(failed) + len(released), slow
        updated_all: list = []
        n_joint = 0
        kind_counts = {"univariate": 0, "bivariate": 0, "lstm": 0, "baseline": 0}
        if ok_joint:
            j_updated, demoted, j_counts = self._judge_joint_fast(ok_joint, now)
            updated_all.extend(j_updated)
            n_joint = len(j_updated)
            self._demote_to_slow(slow, demoted, "joint window bucket drift")
            for kind, n in j_counts.items():
                kind_counts[kind] += n
        if ok_items:
            updated_all.extend(self._judge_uni_fast(ok_items, now))
            kind_counts["univariate"] += len(ok_items)
        if ok_citems:
            updated_all.extend(
                self._judge_uni_fast(ok_citems, now, canary=True)
            )
            kind_counts["baseline"] += len(ok_citems)
        self._account_fast_kinds(kind_counts)
        with span(
            "worker.write_back", stage="write_back", docs=len(updated_all)
        ):
            self._store_update_many(updated_all)
        self._observe_verdicts(updated_all)
        return (
            len(ok_items) + len(ok_citems) + n_joint + len(failed) + len(released),
            slow,
        )

    def _admit_fast(self, docs, now: float):
        """The fast-tick admission walk. Returns (fast, fastc, fastj,
        slow) — the baseline-less, canary, joint and object-path doc
        groups; an admitted univariate item is (doc, end_epoch, rowsinfo,
        ops), a joint one (doc, end_epoch, jinfo)."""
        fit_cache = self._fit_cache
        gap_sensitive = self._gap_sensitive
        token = (fit_cache.version, self._gap_meta.version)
        admit = self._admit
        if len(admit) > 8 * max(self.claim_limit, 512):
            admit.clear()  # crude bound; repopulates from caches
        jtoken = None
        if self._joint_fast:
            jtoken = (self._mvj.cache.version, self._mvj.joint_meta.version)
            if len(self._jadmit) > 8 * max(self.claim_limit, 512):
                self._jadmit.clear()
        fast = []
        fastc = []
        fastj = []
        slow = []
        for doc in docs:
            cached = admit.get(doc.id)
            if cached is not None and (
                cached[3] == token or self._revalidate(cached, token)
            ):
                (fastc if cached[4] else fast).append(
                    (doc, cached[0], cached[1], cached[2])
                )
                continue
            aliases, end_epoch, ops = self._doc_meta(doc)
            if not aliases:
                slow.append(doc)
                continue
            if self._mv and len(aliases) != 1:
                item = self._admit_joint(doc, aliases, end_epoch, now, jtoken)
                if item is None:
                    slow.append(doc)
                else:
                    fastj.append(item)
                continue
            rowsinfo = []
            has_base = False
            for (
                alias,
                cur_url,
                mtype,
                base_url,
                hist_url,
                key,
                hist_end,
                fullkey,
            ) in aliases:
                # baseline presence is a BUCKET dimension, not a
                # slow-path demotion — unless the canary columnar path
                # is opted out. The fit gates (settled history, cached
                # entry/gap) are identical for both buckets: the
                # baseline window, like the current window, is fetched
                # fresh every tick and never feeds the fit.
                if (
                    (base_url is not None and not self._canary_fast)
                    or hist_url is None
                    or hist_end is None
                    or hist_end > now - HIST_SETTLED_SECONDS
                ):
                    rowsinfo = None
                    break
                entry = fit_cache.peek(fullkey)
                if entry is None:
                    rowsinfo = None
                    break
                gap = None
                if gap_sensitive:
                    gap = self._gap_meta.peek(key)
                    if gap is None:
                        rowsinfo = None
                        break
                if base_url is not None:
                    has_base = True
                rowsinfo.append(
                    (alias, cur_url, fullkey, entry, gap, base_url)
                )
            if rowsinfo is None:
                slow.append(doc)
            else:
                admit[doc.id] = [end_epoch, rowsinfo, ops, token, has_base]
                (fastc if has_base else fast).append(
                    (doc, end_epoch, rowsinfo, ops)
                )
        return fast, fastc, fastj, slow

    def _fetch_fast(self, fast, fastc, fastj):
        """Fetch current windows for the admitted groups (thread pool
        only for blocking sources): univariate, canary and joint docs
        share one fan-out. Canary docs append their per-row baseline
        URLs after the current URLs (None for a baseline-less alias
        inside a canary doc: it fetches as an empty window, whose
        all-False mask gates every rank test off — the object path's
        exact semantics for that alias). Returns (ok_items, ok_citems,
        ok_joint, failed, released); failed docs carry their terminal
        marks but are NOT persisted here — the caller owns store
        writes."""
        fetch_items = [
            ("uni", item, [r[1] for r in item[2]]) for item in fast
        ]
        fetch_items += [
            (
                "canary",
                item,
                [r[1] for r in item[2]] + [r[5] for r in item[2]],
            )
            for item in fastc
        ]
        fetch_items += [("joint", item, list(item[2][2])) for item in fastj]

        def fetch_doc(entry):
            _kind, item, urls = entry
            try:
                return [
                    self.source.fetch(u)
                    if u is not None
                    else (_EMPTY_TIMES, _EMPTY_VALUES)
                    for u in urls
                ]
            except Exception as e:
                if is_transient_error(e):
                    # dependency outage (or breaker open): release the
                    # doc un-judged instead of terminally failing it
                    log.warning(
                        "preprocess released (transient) for %s: %s",
                        item[0].id, e,
                    )
                    return RELEASED
                log.warning("preprocess failed for %s: %s", item[0].id, e)
                return None

        with span(
            "worker.fetch", stage="metric_fetch", docs=len(fetch_items)
        ):
            if len(fetch_items) > 1 and getattr(
                self.source, "concurrent_fetch", True
            ):
                series = list(
                    self._fetch_pool_get().map(
                        inherit_span(fetch_doc), fetch_items
                    )
                )
            else:
                series = [fetch_doc(entry) for entry in fetch_items]

        failed = []
        released = []
        ok_items = []
        ok_citems = []
        ok_joint = []
        for (kind, item, _urls), s in zip(fetch_items, series):
            if s is None:
                doc = item[0]
                doc.status = STATUS_PREPROCESS_FAILED
                doc.status_code = "500"
                doc.reason = "metric fetch failed"
                failed.append(doc)
            elif s is RELEASED:
                released.append(item[0])
            elif kind == "uni":
                ok_items.append((item, s))
            elif kind == "canary":
                ok_citems.append((item, s))
            else:
                ok_joint.append((item, s))
        return ok_items, ok_citems, ok_joint, failed, released

    def _judge_uni_fast(self, ok_items, now: float, canary: bool = False) -> list:
        """Columnar warm judgment of admitted univariate rows: one
        [B, tc] buffer pair, one `judge_columnar` call, segment-reduction
        decode. `canary=True` is the baseline-carrying bucket: each
        item's fetched series carry the baseline windows AFTER the
        current windows (the `_fetch_fast` layout), which fill a second
        [B, tc] buffer pair judged by the pairwise-active variant — hook
        verdicts then carry the REAL device (p, differs). Returns the
        decided docs; the caller persists."""
        # pack -> dispatch -> gather + decode are separate helpers so the
        # sliced sweep can run them on different pipeline stages; this
        # wrapper composes the same pack and decode around
        # `judge_columnar` (itself the async dispatch + wait pair), which
        # is what pins sliced-vs-monolithic byte parity by construction
        packed = self._pack_uni(ok_items, canary)
        res = self._uni.judge_columnar(
            packed.values,
            packed.mask,
            packed.keys,
            packed.entries,
            packed.nidx,
            packed.thr,
            packed.bnd,
            packed.mlb,
            gap_steps=packed.gaps,
            with_bands=self.on_verdict is not None,
            base_values=packed.base_vals,
            base_mask=packed.base_m,
        )
        return self._decode_uni(packed, res, now)

    def _pack_uni(self, ok_items, canary: bool):
        """The host-side packing half (pure numpy + per-row reads of
        immutable admission tuples): fill the [B, tc] buffer pair (plus
        the canary bucket's baseline pair), gather per-row operands,
        keys, entries and gap steps. Returns a `_UniPacked`."""
        bv_flat = None
        if canary:
            # split each item's series back into (current, baseline)
            # halves; the decode must only ever see the currents
            split = []
            bv_flat = []
            for item, s in ok_items:
                rows = len(item[2])
                split.append((item, s[:rows]))
                bv_flat.extend(s[rows:])
            ok_items = split
        cv_flat = [cv for _, s in ok_items for _, cv in s]
        n_rows = len(cv_flat)
        lens = np.fromiter((len(cv) for cv in cv_flat), np.int64, count=n_rows)
        n_max = int(lens.max(initial=1))
        if canary:
            # the shared window bucket covers the baseline windows too —
            # the object path's per-task rule is bucket_length(max(cur,
            # base)) (judge.judge)
            n_max = max(
                n_max, max((len(bv) for _, bv in bv_flat), default=1)
            )
        tc = bucket_length(max(n_max, 1))
        nidx = np.maximum(lens - 1, 0).astype(np.int32)
        values = np.zeros((n_rows, tc), np.float32)
        maskarr = np.zeros((n_rows, tc), bool)
        n_min = int(lens.min(initial=0))
        if n_min == n_max and n_min > 0:
            # uniform window length (the common steady state): ONE
            # C-level stack instead of a per-row assignment loop
            values[:, :n_max] = np.stack(cv_flat)
            maskarr[:, :n_max] = True
        else:
            for i, cv in enumerate(cv_flat):
                n = min(len(cv), tc)
                if n:
                    values[i, :n] = cv[:n]
                    maskarr[i, :n] = True
        base_vals = base_m = None
        if canary:
            # second [B, tc] buffer: baseline windows, left-packed like
            # the currents; a baseline-less alias inside a canary doc
            # fetched empty, so its all-False mask row gates every rank
            # test off (the object path's exact outcome for it)
            base_vals = np.zeros((n_rows, tc), np.float32)
            base_m = np.zeros((n_rows, tc), bool)
            blens = np.fromiter(
                (len(bv) for _, bv in bv_flat), np.int64, count=n_rows
            )
            b_min, b_max = int(blens.min(initial=0)), int(blens.max(initial=0))
            if b_min == b_max and b_min > 0:
                base_vals[:, :b_max] = np.stack([bv for _, bv in bv_flat])
                base_m[:, :b_max] = True
            else:
                for i, (_, bv) in enumerate(bv_flat):
                    nb = min(len(bv), tc)
                    if nb:
                        base_vals[i, :nb] = np.asarray(bv, np.float32)[:nb]
                        base_m[i, :nb] = True
        opcat = np.concatenate([item[3] for item, _ in ok_items], axis=1)
        thr = opcat[0]
        bnd = opcat[1].astype(np.int32)
        mlb = opcat[2]
        keys = [r[2] for item, s in ok_items for r in item[2]]
        entries = [r[3] for item, s in ok_items for r in item[2]]
        gaps = None
        if self._gap_sensitive:
            gaps = np.zeros(n_rows, np.int32)
            i = 0
            for item, s in ok_items:
                for r, (ct, cv) in zip(item[2], s):
                    gap = r[4]
                    if gap is not None and len(ct):
                        k = int(
                            round((float(ct[0]) - gap[1]) / max(gap[0], 1.0))
                        )
                        gaps[i] = max(k - 1, 0)
                    i += 1
        return _UniPacked(
            ok_items, values, maskarr, keys, entries, nidx,
            thr, bnd, mlb, gaps, tc, canary, base_vals, base_m,
        )

    def _dispatch_uni(self, packed: _UniPacked):
        """The device-dispatch half (tick thread ONLY: arena assignment
        order is load-bearing): one async columnar program, returns the
        un-gathered `ColumnarPending`. Its one copy back records a CUDA
        event on this thread's stream, and `wait()` synchronizes that
        event from whichever thread gathers."""
        return self._uni.judge_columnar_async(
            packed.values,
            packed.mask,
            packed.keys,
            packed.entries,
            packed.nidx,
            packed.thr,
            packed.bnd,
            packed.mlb,
            gap_steps=packed.gaps,
            with_bands=self.on_verdict is not None,
            base_values=packed.base_vals,
            base_mask=packed.base_m,
        )

    def _decode_uni(self, packed: _UniPacked, res, now: float) -> list:
        """The decode half (any single consumer thread: the sliced sweep
        runs it on the writer after `ColumnarPending.wait()`):
        segment-reduce per-doc verdicts and decide statuses off the
        gathered result tuple. Returns the decided docs; the caller
        persists."""
        ok_items = packed.ok_items
        v8, anoms, ub, lb, ps, difs = res
        counts = np.fromiter(
            (len(s) for _, s in ok_items), np.int64, count=len(ok_items)
        )
        starts = np.zeros(len(ok_items), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        is_unh = v8 == UNHEALTHY
        seg_unh = np.maximum.reduceat(is_unh, starts)
        seg_min = np.minimum.reduceat(v8, starts)
        nz_r, nz_c = np.nonzero(anoms)

        def pairs_for(r, s_local, k2):
            lo_i = np.searchsorted(nz_r, r)
            hi_i = np.searchsorted(nz_r, r, side="right")
            cols = nz_c[lo_i:hi_i]
            if not len(cols):
                return []
            ct, cv = s_local[k2]
            flat = np.empty(2 * len(cols), np.float64)
            flat[0::2] = np.asarray(ct)[cols]
            flat[1::2] = np.asarray(cv)[cols]
            return flat.tolist()

        with span("worker.decide", stage="decide", docs=len(ok_items)):
            return self._decide_fast(
                ok_items, v8, seg_unh, seg_min, starts, pairs_for,
                ub, lb, packed.tc, now, ps, difs,
            )

    def _decide_fast(
        self, ok_items, v8, seg_unh, seg_min, starts, pairs_for,
        ub, lb, tc, now, ps=None, difs=None,
    ):
        """Fast-path status decisions + hook dispatch. `ps`/`difs` are
        the canary bucket's per-row device pairwise outcomes (None on
        the baseline-less bucket, whose hook verdicts carry the
        all-gates-failed constants)."""
        hook = self.on_verdict
        updated = []
        for j, ((doc, end_epoch, rowsinfo, _), s) in enumerate(ok_items):
            if seg_unh[j]:
                jv = UNHEALTHY
            elif seg_min[j] == UNKNOWN:
                jv = UNKNOWN
            else:
                jv = HEALTHY
            a = int(starts[j])
            values_map = {}
            if jv == UNHEALTHY:
                for k2 in range(len(s)):
                    p = pairs_for(a + k2, s, k2)
                    if p:
                        values_map[rowsinfo[k2][0]] = p
            self._decide_status(doc, jv, values_map, now, end_epoch)
            self._log_judged(doc)
            updated.append(doc)
            if self.metrics is not None:
                self.metrics.observe_doc(doc.status, len(s))
            if hook:
                vs = []
                full_bands = ub is not None and ub.ndim == 2
                for k2, (row, (ct, cv)) in enumerate(zip(rowsinfo, s)):
                    r = a + k2
                    n = min(len(cv), tc)
                    if full_bands:
                        # band_mode="full": whole [n] band per metric,
                        # same shape the slow path's hooks receive
                        up = ub[r, :n] if n else _EMPTY_VALUES
                        lo = lb[r, :n] if n else _EMPTY_VALUES
                    else:
                        up = ub[r : r + 1] if n else _EMPTY_VALUES
                        lo = lb[r : r + 1] if n else _EMPTY_VALUES
                    vs.append(
                        MetricVerdict(
                            job_id=doc.id,
                            alias=row[0],
                            verdict=int(v8[r]),
                            anomaly_pairs=pairs_for(r, s, k2),
                            upper=up,
                            lower=lo,
                            p_value=float(ps[r]) if ps is not None else 1.0,
                            dist_differs=(
                                bool(difs[r]) if difs is not None else False
                            ),
                        )
                    )
                try:
                    hook(doc, vs)
                except Exception:
                    log.exception("on_verdict hook failed for %s", doc.id)
        return updated

    # -- reactive plane: micro-ticks and verdict latency ------------------

    def micro_tick(self, now: float | None = None) -> int:
        """Drain up to `FOREMAST_MICROTICK_DOCS` dirty route keys through
        ONE claim-fetch-judge-write cycle restricted to their documents.
        The body is `_tick` itself: warm docs ride the columnar fast path,
        cold docs take the slow pipeline, and every degradation contract
        (write-behind, transient release, breakers) applies unchanged, so
        a micro-tick-judged doc's status is byte-identical to the same doc
        judged by a full tick. Housekeeping (refinement, snapshots) stays
        with the sweeps. Returns #docs processed."""
        dirty = self.dirty
        if dirty is None:
            return 0
        entries = dirty.take(self.microtick_docs)
        if not entries:
            return 0
        if self.tracer is None:
            return self._tick(now, micro=entries)
        with self.tracer.span("worker.microtick", worker=self.worker_id):
            return self._tick(now, micro=entries)

    def _begin_pending(self, micro) -> _TickLedger:
        """Set up this cycle's arrival-attribution ledger: a micro-tick
        owns exactly the entries it took; a full sweep drains the WHOLE
        dirty set (the catch-all: arrivals the micro-ticks missed, dropped
        keys' documents). `self._ledger` tracks the INNERMOST live cycle
        (a sweep's preemption point saves and restores it around the
        nested micro-tick)."""
        if micro is not None:
            led = _TickLedger("micro", micro)
        elif self.dirty is not None:
            led = _TickLedger("sweep", self.dirty.take_all())
        else:
            led = _TickLedger("sweep")
        self._ledger = led
        return led

    def _requeue_pending(self, led: _TickLedger) -> None:
        """Give every un-attributed arrival back to the dirty set with its
        original stamp (claim brownout: nothing was claimed, the docs stay
        claimable, the arrivals must survive)."""
        if led.pending and self.dirty is not None:
            for rk, stamp in led.pending.items():
                self.dirty.mark(rk, stamp, requeue=True)
        led.pending = {}

    def _finish_pending(self, led: _TickLedger) -> None:
        """Close out arrival attribution: pending keys no judged doc
        matched (terminal docs, apps claimed by a peer, sweep claims past
        the limit) are DROPPED and counted, never re-queued: a key with no
        claimable doc would cycle forever."""
        pending = led.pending
        if pending:
            missed = sum(1 for k in pending if k not in led.observed)
            if missed and self.dirty is not None:
                self.dirty.count("unattributed", missed)
        led.pending = {}
        led.observed = set()

    def _observe_verdicts(self, docs, led: _TickLedger | None = None) -> None:
        """Per-verdict latency: every just-written doc whose route key
        carries a pending arrival observes (now - receiver arrival stamp)
        on `foremast_verdict_latency_seconds{path, tenant}`. Called at the
        write-back points of both tick paths; a write-behind-buffered
        verdict observes too (the verdict exists; its persistence is the
        buffer's contract). `tenant` is the doc's tenant folded through
        the registry's cardinality cap, or the constant "default" on an
        untenanted worker."""
        led = self._ledger if led is None else led
        pending = led.pending
        if not pending or not docs:
            return
        hist = self.metrics.verdict_latency if self.metrics is not None else None
        observed = led.observed
        path = led.path
        now = time.time()
        tenancy = self._tenancy
        for doc in docs:
            rk = doc_route_key(doc)
            stamp = pending.get(rk)
            if stamp is None:
                continue
            observed.add(rk)
            if hist is not None:
                # bounded-cardinality tenant attribution: configured
                # tenants + up to FOREMAST_TENANT_LABEL_MAX observed values
                # get their own label, the rest fold into `other`
                tenant = tenancy.metric_tenant(tenancy.tenant_of_doc(doc)) if tenancy is not None else "default"
                hist.labels(path=path, tenant=tenant).observe(max(0.0, now - stamp))

    def _micro_claim_filter(self, base, led: _TickLedger):
        """The micro-tick's claim restriction: only documents whose route
        key is in this tick's pending set, composed with the base filter
        (claim-CAS stays the net beneath both)."""
        keys = led.pending

        def claim_filter(doc) -> bool:
            if base is not None and not base(doc):
                return False
            return doc_route_key(doc) in keys

        return claim_filter

    # -- main cycle ------------------------------------------------------

    def tick(self, now: float | None = None) -> int:
        """One claim-fetch-judge-write cycle. Returns #docs processed.

        Sweeps whose claim can exceed one slice run SLICED
        (`_sweep_sliced`): bounded slices through the warm-path pipeline
        with a dirty-drain preemption point between slices. Everything
        else, and `FOREMAST_SWEEP_SLICE_DOCS=0`, keeps the monolithic body
        (`_tick`), the byte-parity arm.

        With `FOREMAST_PROFILE` set, each sweep is recorded under
        `torch.profiler` and writes one Chrome trace into that directory
        (`observe.trace_scoring`); micro-ticks outside a sweep are not
        recorded."""
        with trace_scoring():
            if self.tracer is None:
                return self._cycle(now)
            # the root span mints the tick's trace ID: every stage span
            # below (and the judge spans nested inside them) shares it, as
            # do JSON log records emitted while the tick is open
            with self.tracer.span("worker.tick", worker=self.worker_id):
                return self._cycle(now)

    def _cycle(self, now: float | None) -> int:
        if self._sweep_sliceable():
            return self._sweep_sliced(now)
        return self._tick(now)

    def _sweep_sliceable(self) -> bool:
        """Sliced sweeps engage when a claim can outgrow one slice
        (FOREMAST_SWEEP_SLICE_DOCS > 0 and < claim_limit) and `_fast_tick`
        has not been replaced on the instance (tests forcing the object
        path get exactly the monolithic body they stubbed)."""
        return 0 < self.sweep_slice_docs < self.claim_limit and "_fast_tick" not in self.__dict__

    # -- sliced, preemptible sweeps --------------------------------------

    def _sweep_sliced(self, now: float | None = None) -> int:
        """One full sweep as a sequence of bounded slices through a
        warm-path pipeline: the prefetch thread takes slice N+1 from the
        claim pool and packs it while the tick thread async-dispatches
        slice N's columnar programs and the writer thread gathers,
        decodes and bulk-writes slice N-1. At every slice boundary the
        reactive drain gets a PREEMPTION POINT
        (`_preempt_between_slices`), so a pushed anomaly's latency is
        bounded by one slice's wall clock, not the sweep's.

        Contract preservation: the claim is ONE store round trip (the same
        claim and lease semantics as the monolithic tick); each slice's
        write-behind stamps carry the sweep's claim instant; the tick
        budget is checked per slice, with the still-pooled remainder
        released in one bulk write on expiry; per-doc judgment is
        byte-identical to the monolithic tick because both compose the
        same pack / dispatch / decode helpers."""
        t0 = time.perf_counter()
        self._tick_deadline = self._degrade.deadline(t0)
        now = time.time() if now is None else now
        self._flush_write_behind()
        led = self._begin_pending(None)
        docs = self._claim_cycle(led, None)
        claim_mono = self._tick_claim_mono
        if docs and self._deadline_exceeded():
            self._release_docs(docs, REASON_DEADLINE, led, claim_mono)
            docs = []
        if not docs:
            # idle sweep: the monolithic idle tick's housekeeping
            self._finish_pending(led)
            self._refine_provisional(now)
            self._maybe_persist()
            if self.metrics is not None:
                self.metrics.tick_seconds.observe(time.perf_counter() - t0)
            return 0

        pool = _SweepPool(docs, tenancy=self._tenancy)
        counters = {
            "slices": 0, "slow_docs": 0, "promoted": 0,
            "inflight_requeued": 0, "preempt_microticks": 0,
            "preempt_docs": 0,
        }
        totals = {"docs": 0, "fast": 0}
        # the SWEEP's deadline, captured like claim_mono: prepare runs on
        # the prefetch thread CONCURRENTLY with the boundary hook, and a
        # nested preemption micro-tick points self._tick_deadline at its
        # own (fresher) deadline while it runs
        sweep_deadline = self._tick_deadline

        def past_deadline() -> bool:
            return sweep_deadline is not None and time.perf_counter() > sweep_deadline

        def prepare(_i):
            # prefetch thread: deadline check FIRST, so an expired sweep
            # releases its pooled remainder in one bulk write instead of
            # fetching work it may not judge
            if past_deadline():
                rest = pool.drain()
                if not rest:
                    return END
                return _SlicePrep(rest, claim_mono, release_all=True)
            batch = pool.take(self.sweep_slice_docs)
            if not batch:
                return END
            return self._prepare_slice(batch, now, claim_mono)

        def judge(_i, prep):
            if not prep.release_all:
                # release bundles judge nothing: counting them would
                # overstate foremast_sweep_slices_total
                counters["slices"] += 1
                counters["slow_docs"] += len(prep.slow)
            return self._dispatch_slice(prep, now, led)

        def write(_i, res):
            n_docs, n_fast = self._finish_slice(res, now, led, pool)
            totals["docs"] += n_docs
            totals["fast"] += n_fast

        def boundary():
            self._preempt_between_slices(pool, led, now, counters)

        # _sweep_active pins _tick_claim_mono for nested micro-ticks (see
        # _claim_cycle); flipped back in the SAME finally that releases
        # the pool, so no setup failure can leave it stuck True
        self._sweep_active = True
        pipe = None
        try:
            use_threads = self.pipeline_depth > 1
            if use_threads:
                # materialize the fetch pool on the tick thread (see the
                # slow pipeline's rationale)
                self._fetch_pool_get()
            pipe = ChunkPipeline(
                inherit_span(prepare),
                judge,
                inherit_span(write),
                depth=self.pipeline_depth,
                prefetch_pool=self._prefetch_pool_get() if use_threads else None,
                boundary=boundary,
                on_drained=lambda _i, prep: self._abort_slice(prep, led),
            )
            pipe.run(itertools.count())
        finally:
            self._sweep_active = False
            rest = pool.drain()
            if rest:
                # abort path: claimed docs whose slice never ran go back
                # un-judged instead of waiting out stuck takeover
                try:
                    self._release_docs(rest, REASON_ABORT, led, claim_mono)
                except Exception:  # noqa: BLE001 - the primary error propagates
                    log.exception(
                        "failed to release %d pooled doc(s) after sweep abort; stuck-claim takeover will "
                        "net them", len(rest),
                    )
            stats = pipe.last_stats if pipe is not None else None
            pipe_state = stats.as_dict() if stats else None
            if pipe_state is not None:
                # chunk specs are opaque slice indices; the honest doc
                # count is what the writer retired
                pipe_state["docs"] = totals["docs"]
            self._last_sweep = {"slice_docs": self.sweep_slice_docs, **counters, "pipeline": pipe_state}
            if self.metrics is not None:
                self.metrics.observe_sweep(stats, counters)
        if counters["slow_docs"] == 0:
            # all-warm sweep: the cheap moment to upgrade provisional fits,
            # the monolithic tick's rule
            self._refine_provisional(now)
        if self.metrics is not None:
            self.metrics.observe_arena(self._uni.device_state_counters())
            self.metrics.tick_seconds.observe(time.perf_counter() - t0)
        self._tick_done(totals["docs"], totals["fast"], t0, led=led)
        return totals["docs"]

    def _prepare_slice(self, docs, now: float, claim_mono: float) -> _SlicePrep:
        """Pipeline stage 1 (prefetch thread): admission split, window
        fetch and columnar packing for one slice. No store writes and no
        device work: those belong to the writer and tick threads."""
        prep = _SlicePrep(docs, claim_mono)
        fast, fastc, fastj, prep.slow = self._admit_fast(docs, now)
        if fast or fastc or fastj:
            prep.ok_items, prep.ok_citems, prep.ok_joint, prep.failed, prep.released = self._fetch_fast(
                fast, fastc, fastj
            )
            if prep.ok_items:
                prep.uni_packed = self._pack_uni(prep.ok_items, False)
            if prep.ok_citems:
                prep.canary_packed = self._pack_uni(prep.ok_citems, True)
        return prep

    def _dispatch_slice(self, prep: _SlicePrep, now: float, led: _TickLedger) -> _SliceResult:
        """Pipeline stage 2 (tick thread, strict slice order: arena
        assignment and device dispatch order are load-bearing): judge the
        joint group synchronously, async-dispatch the univariate and
        canary columnar programs (no synchronization: the results come
        back through one pinned copy each, gathered on the writer), then
        run this slice's slow leftovers through the chunk pipeline. A
        dispatch failure raises StageError carrying the partial result so
        already-judged work still persists through the writer."""
        res = _SliceResult(prep)
        if prep.release_all:
            return res
        try:
            if prep.ok_joint:
                j_updated, demoted, j_counts = self._judge_joint_fast(prep.ok_joint, now)
                res.joint_updated = j_updated
                res.joint_counts = j_counts
                self._demote_to_slow(prep.slow, demoted, "joint window bucket drift")
            if prep.uni_packed is not None:
                res.uni_pending = self._dispatch_uni(prep.uni_packed)
            if prep.canary_packed is not None:
                res.canary_pending = self._dispatch_uni(prep.canary_packed)
        except BaseException as e:  # noqa: BLE001 - re-raised post-drain
            res.aborted = True
            raise StageError(e, res) from e
        if prep.slow:
            try:
                self._run_slow_chunks(prep.slow, now, led, prep.claim_mono)
                prep.slow_done = True
            except BaseException as e:  # noqa: BLE001 - re-raised post-drain
                # the warm dispatches above still owe their writes: ship
                # them through the writer before the error propagates (the
                # slow pipeline released or persisted its own partial work)
                prep.slow_done = True
                raise StageError(e, res) from e
        return res

    def _finish_slice(self, res: _SliceResult, now: float, led: _TickLedger, pool) -> tuple[int, int]:
        """Pipeline stage 3 (writer thread): gather + decode the pending
        columnar judgments, persist everything, observe the verdict
        latencies, and retire the slice's route keys from the in-flight
        set. Returns (docs_processed, fast_docs)."""
        prep = res.prep
        try:
            if prep.release_all:
                self._release_docs(prep.docs, REASON_DEADLINE, led, prep.claim_mono)
                return len(prep.docs), 0
            for doc in prep.failed:
                self._store_update(doc, claim_mono=prep.claim_mono)
                if self.metrics is not None:
                    self.metrics.observe_doc(doc.status, 0)
            if prep.released:
                self._release_docs(prep.released, REASON_FETCH, led, prep.claim_mono)
            updated = list(res.joint_updated)
            kind_counts = {"univariate": 0, "bivariate": 0, "lstm": 0, "baseline": 0}
            if res.joint_counts:
                for kind, n in res.joint_counts.items():
                    kind_counts[kind] += n
            drop: list = []
            if res.uni_pending is not None:
                updated += self._decode_uni(prep.uni_packed, res.uni_pending.wait(), now)
                kind_counts["univariate"] += len(prep.uni_packed.ok_items)
            elif res.aborted and prep.uni_packed is not None:
                drop += [it[0] for it, _ in prep.uni_packed.ok_items]
            if res.canary_pending is not None:
                updated += self._decode_uni(prep.canary_packed, res.canary_pending.wait(), now)
                kind_counts["baseline"] += len(prep.canary_packed.ok_items)
            elif res.aborted and prep.canary_packed is not None:
                drop += [it[0] for it, _ in prep.canary_packed.ok_items]
            if res.aborted:
                if not res.joint_updated and prep.ok_joint:
                    drop += [it[0] for it, _ in prep.ok_joint]
                if not prep.slow_done:
                    drop += list(prep.slow)
                self._release_docs(drop, REASON_ABORT, led, prep.claim_mono)
            self._account_fast_kinds(kind_counts)
            if updated:
                with span("worker.write_back", stage="write_back", docs=len(updated)):
                    self._store_update_many(updated, claim_mono=prep.claim_mono)
            self._observe_verdicts(updated, led)
            n_fast = len(updated) + len(prep.failed) + len(prep.released)
            return n_fast + len(prep.slow), n_fast
        finally:
            pool.done(prep.docs)

    def _abort_slice(self, prep: _SlicePrep, led: _TickLedger) -> None:
        """A prepared slice whose judgment never ran (pipeline abort):
        persist the fetch-failure marks and give every other claimed doc
        back un-judged. Best effort: a store that is itself the abort
        cause leaves the docs to stuck-claim takeover."""
        try:
            if prep.release_all:
                self._release_docs(prep.docs, REASON_DEADLINE, led, prep.claim_mono)
                return
            for doc in prep.failed:
                self._store_update(doc, claim_mono=prep.claim_mono)
            # fetch-released docs keep their honest reason: an abort
            # coinciding with a dependency brownout must not hide the
            # brownout from the fetch_released counter
            self._release_docs(list(prep.released), REASON_FETCH, led, prep.claim_mono)
            docs = [it[0] for it, _ in prep.ok_items]
            docs += [it[0] for it, _ in prep.ok_citems]
            docs += [it[0] for it, _ in prep.ok_joint]
            docs += list(prep.slow)
            self._release_docs(docs, REASON_ABORT, led, prep.claim_mono)
        except Exception:  # noqa: BLE001 - the primary error propagates
            log.exception("failed to release an unjudged slice after sweep abort; stuck-claim takeover will net its docs")

    def _preempt_between_slices(self, pool, led: _TickLedger, now: float, counters: dict) -> None:
        """The slice-boundary preemption point. Pending dirty arrivals are
        triaged against the sweep itself:

          * key matches POOLED docs (claimed, not yet fetched): the docs
            are PROMOTED to the front of the slice order; their slice
            fetches post-arrival samples, so the sweep's own write
            delivers the verdict within ~one slice, attributed through
            the sweep ledger (earliest stamp wins);
          * key matches an IN-FLIGHT slice (fetched or fetching: its
            windows may predate the arrival): requeued at the front of the
            dirty set with the ORIGINAL stamp; once the slice's write
            releases the doc, the next boundary claims it;
          * anything else (docs outside this sweep's claim: new jobs,
            already-written re-check docs): a NESTED micro-tick runs
            between slices, the unchanged `_tick` body on its own ledger.
        """
        dirty = self.dirty
        if dirty is None or not len(dirty):
            return
        entries = dirty.take(self.microtick_docs)
        if not entries:
            return
        micro_entries = []
        for rk, stamp in entries:
            if pool.promote(rk):
                cur = led.pending.get(rk)
                if cur is None or stamp < cur:
                    led.pending[rk] = stamp
                counters["promoted"] += 1
                dirty.count("promoted")
            elif pool.inflight(rk):
                dirty.mark(rk, stamp, requeue=True)
                counters["inflight_requeued"] += 1
                dirty.count("inflight_requeued")
            else:
                micro_entries.append((rk, stamp))
        if not micro_entries:
            return
        counters["preempt_microticks"] += 1
        # the nested cycle swaps the innermost-ledger pointer and the tick
        # deadline; restore both so the sweep's remaining slices keep
        # their budget and attribution. It takes a FRESH clock (the
        # micro-tick's contract), not the sweep's start `now`: a clock
        # stale by the sweep's duration would miss endTimes that elapsed
        # mid-sweep
        saved_deadline = self._tick_deadline
        saved_ledger = self._ledger
        try:
            counters["preempt_docs"] += self._tick(None, micro=micro_entries)
        finally:
            self._tick_deadline = saved_deadline
            self._ledger = saved_ledger

    def _claim_cycle(self, led: _TickLedger, micro) -> list[Document]:
        """Shared cycle head for the monolithic tick and the sliced sweep:
        compose the claim filter (the base filter, plus the dirty-key
        restriction for micro-ticks), stamp the claim instant and claim,
        degrading a transient store failure to an empty cycle with the
        pending arrivals requeued un-spent."""
        claim_kw = {}
        if self.mesh is not None:
            # idle ticks renew too: the lease must outlive quiet fleets
            # (lease and refresh timing run on the mesh's own clocks)
            self.mesh.on_tick()
        if self.claim_filter is not None:
            claim_kw["claim_filter"] = self.claim_filter
        if micro is not None:
            claim_kw["claim_filter"] = self._micro_claim_filter(self.claim_filter, led)
        # Write-behind age stamps measure from this instant. A sliced
        # sweep PINS it at its own claim time (`_sweep_active`): a nested
        # preemption micro-tick must never move it FORWARD, because the
        # sweep's writer thread stamps concurrently, and a fresher stamp
        # on an older claim would stretch the replay window past the
        # stuck-takeover boundary. The micro's own entries getting the
        # sweep's OLDER stamp is conservative: they age out earlier.
        if not self._sweep_active:
            self._tick_claim_mono = time.monotonic()
        with span("worker.claim", stage="claim", limit=self.claim_limit):
            try:
                docs = self.store.claim(
                    self.worker_id,
                    self.config.max_stuck_seconds,
                    self.claim_limit,
                    **claim_kw,
                )
                if self._tenant_acct is not None and docs:
                    # per-tenant claim attribution: counted at THE claim,
                    # so sweep, sliced-sweep and micro-tick paths all
                    # charge through one seam
                    by_tenant: dict[str, int] = {}
                    for d in docs:
                        t = self._tenancy.tenant_of_doc(d)
                        by_tenant[t] = by_tenant.get(t, 0) + 1
                    for t, c in by_tenant.items():
                        self._tenant_acct.count_claims(t, c)
                return docs
            except Exception as e:
                # a store outage must degrade to an idle tick, not kill
                # the worker loop: nothing was claimed, nothing is owed,
                # and the pending arrivals go back to the dirty set
                # un-spent (the push->verdict clock keeps running)
                if not is_transient_error(e):
                    raise
                self._degrade.stats.count_event("store", "claim_error")
                log.warning(
                    "claim degraded to empty tick (store transient "
                    "error: %s)", e,
                )
                self._requeue_pending(led)
                return []

    # An unexpected exception mid-judgment deliberately leaves this
    # cycle's claims to the stuck-claim takeover: a blanket release here
    # could reset docs whose terminal status the chunk pipeline's writer
    # already persisted, breaking the exactly-once ledger. The detectable
    # failures all have protected edges already (claim brownout -> empty
    # cycle, deadline -> _release_docs, pipeline abort -> _abort_slice,
    # judge error -> _judge_chunk's StageError write).
    def _tick(self, now: float | None = None, micro=None) -> int:
        t0 = time.perf_counter()
        self._tick_deadline = self._degrade.deadline(t0)
        now = time.time() if now is None else now
        # replay any write-behind backlog FIRST: the store may have
        # healed, and re-check docs buffered as preprocess_completed
        # must become claimable before this tick's claim
        self._flush_write_behind()
        # reactive: a micro-tick owns the dirty entries it took; a full
        # sweep drains the rest as its catch-all
        led = self._begin_pending(micro)
        docs = self._claim_cycle(led, micro)
        if docs and self._deadline_exceeded():
            # the claim alone blew the tick budget (store brownout):
            # give everything back un-judged
            self._release_docs(docs, REASON_DEADLINE, led)
            docs = []
        if not docs:
            # an idle worker is not an idle ring (receiver threads keep
            # pushing), so snapshot cadence and provisional-fit refinement
            # run here (sweeps only: micro-ticks stay lean)
            self._finish_pending(led)
            if micro is not None:
                self._tick_done(0, 0, t0, micro=True, led=led)
                return 0
            self._refine_provisional(now)
            self._maybe_persist()
            if self.metrics is not None:
                self.metrics.tick_seconds.observe(time.perf_counter() - t0)
            return 0
        # the all-warm re-check subset takes the columnar fast path;
        # whatever it returns (cold fits, unsettled histories) flows
        # through the object path below
        n_fast, docs = self._fast_tick(docs, now)
        if not docs:
            # all-warm steady tick: the cheap moment to upgrade provisional
            # fits; invalidations land their refits on the NEXT tick's slow
            # path, in bounded batches (sweeps only)
            if micro is None:
                self._refine_provisional(now)
        else:
            self._run_slow_chunks(docs, now, led, self._tick_claim_mono)
        if self.metrics is not None:
            self.metrics.observe_arena(self._uni.device_state_counters())
            if micro is None:
                self.metrics.tick_seconds.observe(time.perf_counter() - t0)
        self._tick_done(n_fast + len(docs), n_fast, t0, micro=micro is not None, led=led)
        return n_fast + len(docs)

    def _run_slow_chunks(self, docs, now: float, led: _TickLedger, claim_mono: float) -> None:
        """Progressive admission: the slow path — cold fits, unsettled
        histories — processes the claim set in bounded DOC CHUNKS
        (`FOREMAST_COLD_CHUNK_DOCS`), bounding time-to-first-verdict by
        one chunk's work and peak host memory for packed histories. The
        chunks run through a bounded-depth pipeline
        (`FOREMAST_PIPELINE_DEPTH`): chunk N+1's windows are prefetched
        while chunk N is judged on the card and chunk N-1's verdicts
        drain to the store on a writer thread. Under a sliced sweep each
        slice's leftovers run through their own bounded pass."""
        # Pool/pipeline only when the source actually blocks on I/O:
        # in-memory sources declare concurrent_fetch=False (threading
        # pure-Python dict lookups is pure GIL overhead) and run the
        # depth-1 serial loop.
        use_pool = len(docs) > 1 and getattr(
            self.source, "concurrent_fetch", True
        )
        chunk_docs = self.cold_chunk_docs
        chunks = [
            docs[c0 : c0 + chunk_docs]
            for c0 in range(0, len(docs), chunk_docs)
        ]
        depth = self.pipeline_depth if use_pool else 1
        if use_pool:
            # materialize the fetch pool on the tick thread: lazy
            # creation from concurrent prefetch threads could race into
            # two executors, leaking one
            self._fetch_pool_get()
        pipe = ChunkPipeline(
            # fetch/write run on pipeline threads: inherit_span re-seats
            # the tick's ambient span so their stage spans and log
            # records keep the tick's trace ID
            inherit_span(partial(self._fetch_chunk, now=now, use_pool=use_pool)),
            self._judge_chunk,
            inherit_span(
                partial(self._write_chunk, now=now, led=led, claim_mono=claim_mono)
            ),
            depth=depth,
            prefetch_pool=(
                self._prefetch_pool_get()
                if depth > 1 and len(chunks) > 1
                else None
            ),
        )
        try:
            pipe.run(chunks)
        finally:
            # surface occupancy on the abort path too (completed=False
            # marks the partial snapshot)
            self._last_pipeline = pipe.last_stats.as_dict()
            if self.metrics is not None:
                self.metrics.observe_pipeline(pipe.last_stats)

    # -- slow-path pipeline stages (jobs/pipeline.py) --------------------

    def _fetch_chunk(self, chunk, now: float, use_pool: bool):
        """Pipeline stage 1: every window of every doc in the chunk, on a
        prefetch thread when the pipeline is engaged. Per-doc failures
        come back as None entries or the RELEASED sentinel, never
        exceptions. A chunk whose turn comes after the tick deadline
        skips its fetches entirely — every doc releases."""
        if self._deadline_exceeded():
            return [RELEASED_DEADLINE] * len(chunk)
        with span("worker.fetch", stage="metric_fetch", docs=len(chunk)):
            if use_pool:
                return list(
                    self._fetch_pool_get().map(
                        inherit_span(partial(self._fetch_tasks, now=now)),
                        chunk,
                    )
                )
            return [self._fetch_tasks(doc, now) for doc in chunk]

    def _judge_chunk(self, chunk, fetched):
        """Pipeline stage 2 (tick thread, strict chunk order): ONE
        batched judgment for every window of the chunk's jobs. Returns
        (ok_docs, failed_docs, verdicts by job id, released (doc,
        reason) pairs); store writes belong to stage 3. A judge
        exception becomes a StageError carrying the failed/released
        partial result, so the chunk's fetch-failure markings still
        reach the store. A chunk reaching the judge after the tick
        deadline releases every fetched doc un-judged."""
        all_tasks: list[MetricTask] = []
        failed: list[Document] = []
        ok_docs: list[Document] = []
        released: list[tuple[Document, str]] = []
        past_deadline = self._deadline_exceeded()
        for doc, tasks in zip(chunk, fetched):
            # claim() already flipped + persisted preprocess_inprogress
            if tasks is None:
                doc.status = STATUS_PREPROCESS_FAILED
                doc.status_code = "500"
                doc.reason = "metric fetch failed"
                failed.append(doc)
            elif tasks is RELEASED:
                released.append((doc, REASON_FETCH))
            elif tasks is RELEASED_DEADLINE or past_deadline:
                released.append((doc, REASON_DEADLINE))
            else:
                ok_docs.append(doc)
                all_tasks.extend(tasks)
        try:
            verdicts = self.judge.judge(all_tasks)
        except BaseException as e:  # noqa: BLE001 — re-raised post-drain
            raise StageError(e, ([], failed, {}, released)) from e
        by_job: dict[str, list[MetricVerdict]] = {}
        for v in verdicts:
            by_job.setdefault(v.job_id, []).append(v)
        return ok_docs, failed, by_job, released

    def _write_chunk(
        self,
        chunk,
        result,
        now: float,
        led: _TickLedger | None = None,
        claim_mono: float | None = None,
    ) -> None:
        """Pipeline stage 3 (single writer thread, FIFO): status
        transitions + per-doc persistence + hooks. The store is only
        ever called from one thread at a time during the slow path,
        preserving the serial loop's write sequence one chunk behind
        the judgment."""
        ok_docs, failed, by_job, released = result
        if released:
            # one bulk write per reason group, not a round trip per doc
            by_reason: dict[str, list[Document]] = {}
            for doc, reason in released:
                by_reason.setdefault(reason, []).append(doc)
            for reason, docs_r in by_reason.items():
                self._release_docs(docs_r, reason, led, claim_mono=claim_mono)
        for doc in failed:
            self._store_update(doc, claim_mono=claim_mono)
            if self.metrics is not None:
                self.metrics.observe_doc(doc.status, 0)
        with span("worker.decide", stage="decide", docs=len(ok_docs)):
            for doc in ok_docs:
                vs = by_job.get(doc.id, [])
                self._write_back(doc, vs, now)
                self._log_judged(doc)
                if self.metrics is not None:
                    self.metrics.observe_doc(doc.status, len(vs))
                if self.on_verdict:
                    try:
                        self.on_verdict(doc, vs)
                    except Exception:
                        log.exception(
                            "on_verdict hook failed for %s", doc.id
                        )
        self._observe_verdicts(ok_docs, led)

    def _log_judged(self, doc) -> None:
        """One correlatable line per service-created judgment (docs
        carrying a stamped `trace_id`): INFO only on the first judgment
        or a status CHANGE; a re-judged open doc whose status held
        re-asserts at DEBUG, else a fleet of open jobs emits thousands
        of identical lines per poll."""
        if doc.trace_id:
            prev = self._judged_status.get(doc.id)
            level = logging.INFO if doc.status != prev else logging.DEBUG
            if doc.status in TERMINAL_STATUSES:
                self._judged_status.pop(doc.id, None)
            else:
                self._judged_status[doc.id] = doc.status
                # bound the map: a peer worker may land a job's terminal
                # judgment, leaving our entry orphaned forever
                while len(self._judged_status) > self._JUDGED_STATUS_CAP:
                    self._judged_status.pop(next(iter(self._judged_status)))
            ctx_log(
                log,
                level,
                "judgment",
                job_id=doc.id,
                status=doc.status,
                job_trace_id=doc.trace_id,
            )

    def _tick_done(
        self,
        n_docs: int,
        n_fast: int,
        t0: float,
        micro: bool = False,
        led: _TickLedger | None = None,
    ) -> None:
        """Record the finished busy tick for debug_state and emit one
        correlatable completion log. Micro-ticks keep their own record and
        counter and skip durability housekeeping (snapshot cadence and
        journal compaction belong to the sweeps: a sub-second judgment
        path must never absorb a snapshot pass)."""
        self._finish_pending(self._ledger if led is None else led)
        seconds = time.perf_counter() - t0
        if micro:
            self._last_micro = {
                "at": time.time(),
                "docs": n_docs,
                "seconds": seconds,
                "runs": self._last_micro.get("runs", 0) + 1,
            }
            if self.metrics is not None and n_docs:
                self.metrics.microtick_docs.inc(n_docs)
            if n_docs:
                ctx_log(log, logging.DEBUG, "micro-tick complete", docs=n_docs, seconds=round(seconds, 4))
            return
        self._maybe_persist()
        if self.metrics is not None and hasattr(self.metrics, "observe_device_mesh"):
            dm = self._device_mesh_state()
            if dm is not None:
                self.metrics.observe_device_mesh(dm)
        self._last_tick = {
            "at": time.time(),
            "docs": n_docs,
            "fast": n_fast,
            "seconds": seconds,
        }
        ctx_log(
            log,
            logging.INFO,
            "tick complete",
            docs=n_docs,
            fast_path=n_fast,
            seconds=round(seconds, 4),
        )

    def _device_mesh_state(self) -> dict | None:
        """The /debug/state `device_mesh` section: mesh shape, padded rows
        across the univariate AND joint columnar dispatches, arena device
        accounting and the placement / result-fetch counters. None when
        the judge is single-device.

        `arena_replica_bytes` is PER-DEVICE arena bytes in either layout
        (one replica when replicated, one row-space block when sharded);
        `arena_total_device_bytes` is the bytes of every distinct
        data-axis device's buffer: the replication tax when
        FOREMAST_ARENA_SHARDED=0, one logical copy (the shard sum) by
        default. A device listed several times holds one buffer, and a
        model-axis device none."""
        uni = self._uni
        if not hasattr(uni, "mesh_debug"):
            return None
        out = uni.mesh_debug()
        rows = out["batch_rows_total"] + self._mvj.batch_rows_total
        pads = out["pad_rows_total"] + self._mvj.pad_rows_total
        out["batch_rows_total"] = rows
        out["pad_rows_total"] = pads
        out["padded_row_fraction"] = round(pads / rows, 4) if rows else None
        arenas = list(uni._arenas.values()) + list(self._mvj._joint_arenas.values())
        replica = sum(a.device_bytes() for a in arenas)
        out["arena_layout"] = "sharded" if uni._arena_shards() > 1 else "replicated"
        out["arena_capacity_rows"] = sum(a.cap for a in arenas)
        out["arena_replica_bytes"] = replica
        out["arena_total_device_bytes"] = sum(a.total_device_bytes() for a in arenas)
        return out

    def debug_state(self) -> dict:
        """The worker's varz: queue depth, cache occupancy, arena
        counters with hit rate, columnar bucket counts and padding, the
        latest tick and slow-path pipeline, degradation, and the latest
        tick's stage breakdown."""
        try:
            queue_depth: int | None = self.store.count_open()
            store_ok = True
        except Exception:  # noqa: BLE001 - varz must not depend on store health
            queue_depth, store_ok = None, False
        arena = self._uni.device_state_counters()
        looked = arena.get("hits", 0) + arena.get("misses", 0)
        arena["hit_rate"] = (
            round(arena.get("hits", 0) / looked, 4) if looked else None
        )
        # padding across the univariate AND joint columnar dispatches
        rows = self._uni.batch_rows_total + self._mvj.batch_rows_total
        pads = self._uni.pad_rows_total + self._mvj.pad_rows_total
        with self._cold_lock:
            hist_reads = dict(self._cold_counts)
        # the push-based ingest plane (any source exposing
        # ingest_debug_state: ingest.RingSource)
        ingest_fn = getattr(self.source, "ingest_debug_state", None)
        try:
            ingest = ingest_fn() if ingest_fn is not None else None
        except Exception:  # noqa: BLE001 - varz must not depend on ingest
            ingest = None
        state = {
            "worker_id": self.worker_id,
            "device": str(self.judge.device),
            "config_fingerprint": self.config.fingerprint(),
            "claim_limit": self.claim_limit,
            "queue_depth": queue_depth,
            "store_ok": store_ok,
            "model_cache": {
                "fit_entries": len(self._fit_cache),
                "fit_capacity": self.config.max_cache_size,
                "hist_entries": len(self._hist_cache),
                "admission_entries": len(self._admit),
                "joint_entries": len(self._mvj.cache),
                "joint_admission_entries": len(self._jadmit),
            },
            # ring-first cold path: whether the history cache is bypassed
            # for resident ring columns (and shrunk), and where cold-fit
            # histories came from
            "cold_start": {
                "hist_bypass": self._hist_bypass,
                "hist_cache_cap": self._hist_cache.max_size,
                "hist_reads": hist_reads,
                "admit_floor_seconds": getattr(self.source, "admit_floor", None),
                "refine_docs_per_tick": self.refine_docs_per_tick,
                "refine": self._refine_book.debug_state(),
            },
            # FOREMAST_INGEST=1: series resident, bytes, evictions, hit
            # ratio, receiver lag, subscriptions; None when pure pull
            "ingest": ingest,
            "arena": arena,
            # the joint models' device arena (TreeArena rows)
            "joint_arena": self._mvj.joint_state_counters(),
            "fast_path_docs": dict(self._fast_kinds),
            # the judge's device mesh (None on a single-device judge)
            "device_mesh": self._device_mesh_state(),
            "columnar_pad": (
                {
                    "batch_rows_total": rows,
                    "pad_rows_total": pads,
                    "padded_row_fraction": round(pads / rows, 4),
                }
                if rows
                else None
            ),
            "last_tick": dict(self._last_tick),
            "pipeline": (
                dict(self._last_pipeline) if self._last_pipeline else None
            ),
            # sliced sweeps (FOREMAST_SWEEP_SLICE_DOCS): whether sweeps run
            # sliced, and the latest sliced sweep's ledger (slice count,
            # slow docs, promoted / requeued / micro-ticked preemptions,
            # the warm pipeline's occupancy)
            "sweep": {
                "slice_docs": self.sweep_slice_docs,
                "sliced": self._sweep_sliceable(),
                "last": dict(self._last_sweep) if self._last_sweep else None,
            },
            "degradation": self._degrade.debug_state(),
            # tenant QoS plane (FOREMAST_TENANTS): envelope config + the
            # per-tenant shed/eviction/claim/ring-byte attribution ledger;
            # None when the worker runs untenanted
            "tenants": self._debug_tenants(),
            # worker mesh (FOREMAST_MESH=1): live members with their states
            # and lease ages, claim-filter counts, redirect hints and the
            # handoff plane; None without a mesh
            "mesh": self.mesh.debug_state() if self.mesh is not None else None,
            # fit-journal and ring-snapshot counters; None when ephemeral
            "durability": (
                {
                    "fit_journals": {name: j.debug_state() for name, j in self._fit_journals.items()},
                    "ring": self._snapshotter.debug_state() if self._snapshotter is not None else None,
                }
                if self._fit_journals or self._snapshotter is not None
                else None
            ),
            # reactive plane: dirty-set occupancy and counters, micro-tick
            # budget and pacing, and the latest micro-tick's record; None
            # when the worker is purely tick-paced
            "reactive": (
                {
                    "dirty": self.dirty.debug_state(),
                    "microtick_seconds": self.microtick_seconds,
                    "microtick_docs_budget": self.microtick_docs,
                    "last_micro": dict(self._last_micro),
                }
                if self.dirty is not None
                else None
            ),
        }
        # registered knobs explicitly set in this process's env: with the
        # config fingerprint, the enumerable answer to "why do two workers
        # behave differently" (config.ENV_KNOBS, held by the env contract)
        state["env_overrides"] = env_overrides()
        if self.tracer is not None:
            state["trace"] = self.tracer.debug_state()
        return state

    def _debug_tenants(self) -> dict | None:
        if self._tenancy is None:
            return None
        from foremast_tpu_torch.tenant.collector import debug_tenants

        return debug_tenants(self._tenancy, self._tenant_acct)

    def run(
        self,
        poll_seconds: float = 5.0,
        stop: Callable[[], bool] | None = None,
        after_tick: Callable[[int], None] | None = None,
    ) -> None:
        """Poll until `stop()` says so: tick, and wait `poll_seconds`
        after an idle tick (the shared-nothing worker loop,
        design.md:35-43). `after_tick(n_processed)` runs after every
        sweep: the hook for periodic model-cache checkpoints; its failures
        are logged, never raised. Waits run in slices of a quarter second
        (of `microtick_seconds` in reactive mode), so a stop request is
        honored within one slice.

        Reactive mode (a `dirty` set wired AND `FOREMAST_MICROTICK_SECONDS`
        > 0): the wait between full ticks becomes the micro-tick drain
        window: every `microtick_seconds` the worker claims and judges
        just the dirty documents, so a pushed anomaly meets its verdict in
        ~`microtick_seconds` + judge time instead of waiting out the poll.
        Full ticks keep the poll cadence as SWEEPS; a saturated claim (n
        == claim_limit: more work is surely waiting) re-sweeps at once,
        ALTERNATING one micro drain with each sweep."""

        def hook(n: int) -> None:
            if after_tick is not None:
                try:
                    after_tick(n)
                except Exception:  # noqa: BLE001 - housekeeping must not kill the loop
                    log.exception("after_tick hook failed")

        def micro_drain() -> None:
            # one bounded micro drain, with the hook only when work
            # happened (sweeps keep the run-every-cycle contract the
            # idle-checkpoint logic relies on)
            if len(self.dirty):
                n_micro = self.micro_tick()
                if n_micro:
                    hook(n_micro)

        def wait(seconds: float, step: float, between=None) -> None:
            deadline = time.monotonic() + seconds
            while not (stop and stop()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if between is not None:
                    between()
                time.sleep(min(step, max(remaining, 0.0)))

        reactive = self.dirty is not None and self.microtick_seconds > 0
        while not (stop and stop()):
            n = self.tick()
            hook(n)
            if not reactive:
                if n == 0:
                    wait(poll_seconds, 0.25)
                continue
            if n >= self.claim_limit:
                # saturated sweep (backlog exceeds one claim): keep the
                # busy loop's drain rate, but ALTERNATE one micro drain
                # between sweeps, so a pushed anomaly's latency stays
                # bounded by one sweep, not by the whole backlog's drain
                micro_drain()
                continue
            wait(poll_seconds, self.microtick_seconds, micro_drain)
