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
(the seasonal and trended ones with the hist->cur gap advance); the
joint models raise. Not here yet, each waiting for its own
slice: sliced sweeps and micro-ticks (so `FOREMAST_SWEEP_SLICE_DOCS`
must not slice this worker's claims), joint models, ring-first cold
reads and refinement, fit journals, tenancy, the worker mesh and the
worker's Prometheus gauges.
"""

from __future__ import annotations

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
    REASON_DEADLINE,
    REASON_FETCH,
    REASON_REPLAYED,
    Degradation,
    is_transient_error,
)
from foremast_tpu_torch.config import BrainConfig
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
from foremast_tpu_torch.jobs.pipeline import ChunkPipeline, StageError
from foremast_tpu_torch.jobs.store import JobStore, parse_time
from foremast_tpu_torch.metrics.promql import decode_config
from foremast_tpu_torch.metrics.source import MetricSource
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.observe.logs import ctx_log
from foremast_tpu_torch.observe.spans import inherit_span, span

log = logging.getLogger("foremast_tpu_torch.worker")

# History-cache sizing and admission: entries are whole ~10k-point series
# (~120 KB), so the cap is independent of MAX_CACHE_SIZE (model params);
# a range's `end` must be at least this far in the past before its series
# is treated as immutable (covers the reference's 1-min Prometheus
# ingestion latency with margin, metricsquery.go:53-55).
HIST_CACHE_ENTRIES = 256
HIST_SETTLED_SECONDS = 120.0

# The joint-model selectors of the JAX package (`engine/multivariate.py`),
# whose models the port does not have yet.
MULTIVARIATE_ALGOS = frozenset({"bivariate_normal", "lstm_autoencoder", "auto"})

# The JAX worker slices a sweep whose claim can exceed this many docs
# (`FOREMAST_SWEEP_SLICE_DOCS`, 0 = monolithic); sliced results equal the
# monolithic body's by contract, and the port runs only the latter.
DEFAULT_SWEEP_SLICE_DOCS = 2_048

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


def sweep_slice_docs_from_env() -> int:
    """`FOREMAST_SWEEP_SLICE_DOCS` as the JAX worker resolves it: empty
    means the default, a malformed value warns and takes the default."""
    raw = os.environ.get("FOREMAST_SWEEP_SLICE_DOCS", "")
    if not raw:
        return DEFAULT_SWEEP_SLICE_DOCS
    try:
        return int(raw)
    except ValueError:
        log.warning(
            "ignoring malformed FOREMAST_SWEEP_SLICE_DOCS=%r; using %r",
            raw, DEFAULT_SWEEP_SLICE_DOCS,
        )
        return DEFAULT_SWEEP_SLICE_DOCS


class _UniPacked:
    """One packed univariate/canary columnar bucket: the [B, tc]
    buffers plus per-row operands, ready for `judge_columnar`.
    `ok_items` is the (canary-split) item list the decode walks."""

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
    ):
        """`band_mode` controls how much of the model band each verdict
        carries back from the device: "last" (default — only the final
        band point, what a gauge exporter publishes) or "full" (whole
        [Tc] band per metric, for on_verdict hooks that consume the band
        shape)."""
        self.store = store
        self.source = source
        self.config = config or BrainConfig()
        if self.config.algorithm in MULTIVARIATE_ALGOS:
            raise NotImplementedError(
                f"ML_ALGORITHM={self.config.algorithm!r} selects joint "
                "models, which the port does not have yet: ROADMAP.md "
                "Queue 1, 'joint models'"
            )
        self.claim_limit = claim_limit
        # Sliced sweeps are a later slice of the port: a claim that the
        # JAX worker would slice must not silently run another path here
        self.sweep_slice_docs = sweep_slice_docs_from_env()
        if 0 < self.sweep_slice_docs < claim_limit:
            raise NotImplementedError(
                f"claim_limit={claim_limit} exceeds "
                f"FOREMAST_SWEEP_SLICE_DOCS={self.sweep_slice_docs}, so the "
                "sweep would run sliced, which the port does not have yet "
                "(ROADMAP.md Queue 1); set FOREMAST_SWEEP_SLICE_DOCS=0 for "
                "the monolithic tick"
            )
        self.judge = HealthJudge(self.config, device=device)
        self.judge.band_mode = band_mode
        self.worker_id = worker_id or f"brain-{uuid.uuid4().hex[:8]}"
        self.on_verdict = on_verdict
        # Fitted-forecast cache (the reference's MAX_CACHE_SIZE model
        # cache, `foremast-brain/README.md:30`): terminal forecaster state
        # per (algorithm, season, app|alias|historical-URL), so a re-check
        # tick on an unchanged history skips the 7-day scan and re-runs
        # only the judgment tail.
        self._fit_cache = ModelCache(self.config.max_cache_size)
        self.judge.fit_cache = self._fit_cache
        self._eff_algo = self.config.algorithm
        self._eff_season = self.config.season_steps
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
        # cumulative columnar-path doc counts per bucket ("baseline" is
        # the canary bucket)
        self._fast_kinds = {"univariate": 0, "baseline": 0}
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
        # Historical-window cache for the re-check loop (SURVEY "hard
        # part" (d)): a job's historical URL is fixed for its lifetime,
        # so a job re-checked every tick until endTime need not re-fetch
        # ~10k-point histories each time. Only settled ranges are cached
        # (see _fetch_hist_cached).
        self._hist_cache = ModelCache(HIST_CACHE_ENTRIES)
        # cold-path historical-read accounting (fetch-pool threads write,
        # debug_state reads — lock-guarded)
        self._cold_lock = threading.Lock()
        self._cold_counts = {"http": 0, "cache": 0}
        # Span tracer: tick() opens a root span and every stage — claim,
        # fetch, fit, arena, score, decode, decide, write — parents to
        # it through the ambient-context helper. None = zero overhead.
        self.tracer = tracer
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
        cur = decode_config(doc.current_config)
        base = decode_config(doc.baseline_config)
        hist = decode_config(doc.historical_config)
        aliases = []
        ops = np.empty((3, len(cur)), np.float32)
        for i, (alias, cur_url) in enumerate(cur.items()):
            hist_url = hist.get(alias)
            mtype = infer_metric_type(alias, self.config)
            rule = self.config.anomaly.rule_for(mtype)
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
                        entry = self._fit_cache.get(fullkey)
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
                            ht, hv = self._fetch_hist(hist_url, now)
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
        return tasks

    def _count_cold(self, source: str) -> None:
        """One historical-range read on the cold-fit path, by source
        (http / cache). Fetch-pool threads land here, hence the lock."""
        with self._cold_lock:
            self._cold_counts[source] += 1

    def _fetch_hist(self, url: str, now: float):
        """Historical window (times, values) for a cold fit, through the
        settled-range cache."""
        series, hit = self._fetch_hist_cached(url, now)
        self._count_cold("cache" if hit else "http")
        return series

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
        trial = HealthJudge(self.config, device=self.judge.device)
        trial.fit_cache = ModelCache(4 * _MIN_BUCKET)
        trial.band_mode = self.judge.band_mode
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
        """Shut down the persistent thread pools. Idempotent, and the
        worker stays usable afterwards (pools rebuild lazily)."""
        for attr in ("_fetch_pool", "_prefetch_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
                setattr(self, attr, None)

    # -- degraded store writes -------------------------------------------

    def _store_update(
        self, doc: Document, claim_mono: float | None = None
    ) -> Document:
        """`store.update` with write-behind degradation: a TRANSIENT
        store failure (connection/timeout, 429/5xx, breaker open) parks
        the doc in the bounded buffer for replay instead of failing the
        tick; permanent errors propagate. `claim_mono` is the doc's
        claim instant for the write-behind age stamp (default: this
        tick's)."""
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
        claim_mono: float | None = None,
    ) -> None:
        """Partial-tick semantics: give docs back un-judged (status →
        preprocess_completed, claimable next tick) and count them —
        never wedge a tick behind a slow dependency, never terminally
        fail a doc for a dependency's transient sin."""
        if not docs:
            return
        for doc in docs:
            doc.status = STATUS_PREPROCESS_COMPLETED
        self._store_update_many(docs, claim_mono=claim_mono)
        self._degrade.stats.count_docs(reason, len(docs))
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
        per-bucket counters (debug_state)."""
        for kind, n in kind_counts.items():
            self._fast_kinds[kind] += n

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
        fast, fastc, slow = self._admit_fast(docs, now)
        if not fast and not fastc:
            return 0, slow
        ok_items, ok_citems, failed, released = self._fetch_fast(fast, fastc)
        for doc in failed:
            self._store_update(doc)
        self._release_docs(released, REASON_FETCH)
        if not ok_items and not ok_citems:
            return len(failed) + len(released), slow
        updated_all: list = []
        if ok_items:
            updated_all.extend(self._judge_uni_fast(ok_items, now))
        if ok_citems:
            updated_all.extend(
                self._judge_uni_fast(ok_citems, now, canary=True)
            )
        self._account_fast_kinds(
            {"univariate": len(ok_items), "baseline": len(ok_citems)}
        )
        with span(
            "worker.write_back", stage="write_back", docs=len(updated_all)
        ):
            self._store_update_many(updated_all)
        return (
            len(ok_items) + len(ok_citems) + len(failed) + len(released),
            slow,
        )

    def _admit_fast(self, docs, now: float):
        """The fast-tick admission walk. Returns (fast, fastc, slow) —
        the baseline-less, canary and object-path doc groups; an
        admitted item is (doc, end_epoch, rowsinfo, ops)."""
        fit_cache = self._fit_cache
        gap_sensitive = self._gap_sensitive
        token = (fit_cache.version, self._gap_meta.version)
        admit = self._admit
        if len(admit) > 8 * max(self.claim_limit, 512):
            admit.clear()  # crude bound; repopulates from caches
        fast = []
        fastc = []
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
        return fast, fastc, slow

    def _fetch_fast(self, fast, fastc):
        """Fetch current windows for the admitted groups (thread pool
        only for blocking sources). Canary docs append their per-row
        baseline URLs after the current URLs (None for a baseline-less
        alias inside a canary doc: it fetches as an empty window, whose
        all-False mask gates every rank test off — the object path's
        exact semantics for that alias). Returns (ok_items, ok_citems,
        failed, released); failed docs carry their terminal marks but
        are NOT persisted here — the caller owns store writes."""
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
            else:
                ok_citems.append((item, s))
        return ok_items, ok_citems, failed, released

    def _judge_uni_fast(self, ok_items, now: float, canary: bool = False) -> list:
        """Columnar warm judgment of admitted univariate rows: one
        [B, tc] buffer pair, one `judge_columnar` call, segment-reduction
        decode. `canary=True` is the baseline-carrying bucket: each
        item's fetched series carry the baseline windows AFTER the
        current windows (the `_fetch_fast` layout), which fill a second
        [B, tc] buffer pair judged by the pairwise-active variant — hook
        verdicts then carry the REAL device (p, differs). Returns the
        decided docs; the caller persists."""
        packed = self._pack_uni(ok_items, canary)
        res = self.judge.judge_columnar(
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

    def _decode_uni(self, packed: _UniPacked, res, now: float) -> list:
        """The decode half: segment-reduce per-doc verdicts and decide
        statuses off the gathered result tuple. Returns the decided
        docs; the caller persists."""
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

    # -- main cycle ------------------------------------------------------

    def tick(self, now: float | None = None) -> int:
        """One claim-fetch-judge-write cycle. Returns #docs processed."""
        if self.tracer is None:
            return self._tick(now)
        # the root span mints the tick's trace ID: every stage span
        # below (and the judge spans nested inside them) shares it, as
        # do JSON log records emitted while the tick is open
        with self.tracer.span("worker.tick", worker=self.worker_id):
            return self._tick(now)

    def _claim_cycle(self) -> list[Document]:
        """Stamp the claim instant and claim — degrading a transient
        store failure to an empty cycle."""
        self._tick_claim_mono = time.monotonic()
        with span("worker.claim", stage="claim", limit=self.claim_limit):
            try:
                return self.store.claim(
                    self.worker_id,
                    self.config.max_stuck_seconds,
                    self.claim_limit,
                )
            except Exception as e:
                # a store outage must degrade to an idle tick, not kill
                # the worker loop: nothing was claimed, nothing is owed
                if not is_transient_error(e):
                    raise
                self._degrade.stats.count_event("store", "claim_error")
                log.warning(
                    "claim degraded to empty tick (store transient "
                    "error: %s)", e,
                )
                return []

    # An unexpected exception mid-judgment deliberately leaves this
    # cycle's claims to the stuck-claim takeover: a blanket release here
    # could reset docs whose terminal status the chunk pipeline's writer
    # already persisted, breaking the exactly-once ledger. The detectable
    # failures all have protected edges already (claim brownout -> empty
    # cycle, deadline -> _release_docs, judge error -> _judge_chunk's
    # StageError write).
    def _tick(self, now: float | None = None) -> int:
        t0 = time.perf_counter()
        self._tick_deadline = self._degrade.deadline(t0)
        now = time.time() if now is None else now
        # replay any write-behind backlog FIRST: the store may have
        # healed, and re-check docs buffered as preprocess_completed
        # must become claimable before this tick's claim
        self._flush_write_behind()
        docs = self._claim_cycle()
        if docs and self._deadline_exceeded():
            # the claim alone blew the tick budget (store brownout):
            # give everything back un-judged
            self._release_docs(docs, REASON_DEADLINE)
            docs = []
        if not docs:
            return 0
        # the all-warm re-check subset takes the columnar fast path;
        # whatever it returns (cold fits, unsettled histories) flows
        # through the object path below
        n_fast, docs = self._fast_tick(docs, now)
        if docs:
            self._run_slow_chunks(docs, now, self._tick_claim_mono)
        self._tick_done(n_fast + len(docs), n_fast, t0)
        return n_fast + len(docs)

    def _run_slow_chunks(self, docs, now: float, claim_mono: float) -> None:
        """Progressive admission: the slow path — cold fits, unsettled
        histories — processes the claim set in bounded DOC CHUNKS
        (`FOREMAST_COLD_CHUNK_DOCS`), bounding time-to-first-verdict by
        one chunk's work and peak host memory for packed histories. The
        chunks run through a bounded-depth pipeline
        (`FOREMAST_PIPELINE_DEPTH`): chunk N+1's windows are prefetched
        while chunk N is judged on the card and chunk N-1's verdicts
        drain to the store on a writer thread."""
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
                partial(self._write_chunk, now=now, claim_mono=claim_mono)
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
        self, chunk, result, now: float, claim_mono: float | None = None
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
                self._release_docs(docs_r, reason, claim_mono=claim_mono)
        for doc in failed:
            self._store_update(doc, claim_mono=claim_mono)
        with span("worker.decide", stage="decide", docs=len(ok_docs)):
            for doc in ok_docs:
                vs = by_job.get(doc.id, [])
                self._write_back(doc, vs, now)
                self._log_judged(doc)
                if self.on_verdict:
                    try:
                        self.on_verdict(doc, vs)
                    except Exception:
                        log.exception(
                            "on_verdict hook failed for %s", doc.id
                        )

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

    def _tick_done(self, n_docs: int, n_fast: int, t0: float) -> None:
        """Record the finished busy tick for debug_state and emit one
        correlatable completion log."""
        seconds = time.perf_counter() - t0
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
        arena = self.judge.device_state_counters()
        looked = arena.get("hits", 0) + arena.get("misses", 0)
        arena["hit_rate"] = (
            round(arena.get("hits", 0) / looked, 4) if looked else None
        )
        rows, pads = self.judge.batch_rows_total, self.judge.pad_rows_total
        with self._cold_lock:
            hist_reads = dict(self._cold_counts)
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
            },
            "cold_start": {
                "hist_cache_cap": self._hist_cache.max_size,
                "hist_reads": hist_reads,
            },
            "arena": arena,
            "fast_path_docs": dict(self._fast_kinds),
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
            "sweep": {"slice_docs": self.sweep_slice_docs, "sliced": False},
            "degradation": self._degrade.debug_state(),
        }
        if self.tracer is not None:
            state["trace"] = self.tracer.debug_state()
        return state

    def run(
        self,
        poll_seconds: float = 5.0,
        stop: Callable[[], bool] | None = None,
    ) -> None:
        """Poll until `stop()` says so: tick, and sleep `poll_seconds`
        after an idle tick (the shared-nothing worker loop,
        design.md:35-43)."""
        while not (stop and stop()):
            if self.tick() == 0:
                time.sleep(poll_seconds)
