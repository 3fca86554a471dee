"""Prometheus exposition of the worker: the `foremastbrain_*` model
gauges and the engine's own counters.

The port's copy of the JAX package's `foremast_tpu/observe/gauges.py`,
with the same family names, label names and semantics, so dashboards and
alert rules read the port's worker unchanged. The reference brain
re-publishes its model outputs as Prometheus series scraped from
:8000/metrics (`deploy/foremast/3_brain/foremast-brain.yaml:87-122`):
`foremastbrain:<metric>_upper`, `_lower`, `_anomaly` with
`exported_namespace`/`app` labels (`foremast-browser/src/config/metrics.js:15-23`).
prometheus_client forbids ':' in exposition names, so the worker exports
the sanitized form `foremastbrain_namespace_app_per_pod_<metric>_<suffix>`
and the recording rules republish every family under the reference
spelling.

`prometheus_client` is imported when a class is built, never when this
module is imported (the card's machine may not have it). Only families
with a producer are registered: those of planes the port does not have
yet come with them.

The ingest plane's families are custom collectors that read their
planes' own counters at scrape time, with the JAX package's names, types
and labels, registered by the CLI when `--gauge-port` is live:

    ingest.IngestCollector (FOREMAST_INGEST=1)
        foremast_ingest_fetches_total{result}  counter: hit / partial /
            miss / stale / uncovered ring reads
        foremast_ingest_samples_total, foremast_ingest_evictions_total
        foremast_ingest_series_resident, foremast_ingest_bytes_resident,
        foremast_ingest_receiver_lag_seconds  gauges
        foremast_ingest_requests_total{codec},
        foremast_ingest_stage_seconds_total{codec,stage}  (with a receiver)
    ingest.SnapshotCollector (FOREMAST_SNAPSHOT_DIR set)
        foremast_snapshot_discards_total{reason}, foremast_snapshot_writes_total
        foremast_snapshot_restored_{series,samples,fits},
        foremast_snapshot_age_seconds  gauges

and `WorkerMetrics.cold_hist` counts ring-served cold histories under
`source="ring_full"`, and pure-push reads the ring could not serve
under `source="unserved"`.
"""

from __future__ import annotations

import logging
import os
import re
import threading

log = logging.getLogger("foremast_tpu_torch.gauges")

_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

# Gauge-family cap default: each family is 3 Gauge collectors held
# forever in the registry, and metric names arrive from job configs
# (REST-supplied), so an unbounded set is a memory + scrape-size leak
# an adversarial or merely churning client can drive.
DEFAULT_MAX_FAMILIES = 512


def _san(name: str) -> str:
    return _SANITIZE.sub("_", name)


class BrainGauges:
    """Lazily-created per-metric gauge triplets with a bounded family set.

    The bound is real (it was only a docstring promise before this):
    at most `max_families` distinct metric families are ever created
    (env `FOREMAST_MAX_GAUGE_FAMILIES`, default 512). Past the cap,
    publishes for NEW metric names are dropped — counted on
    `foremastbrain_gauge_families_dropped_total` and warned once —
    while every already-created family keeps updating normally.
    """

    def __init__(
        self,
        registry=None,
        namespace: str = "foremastbrain",
        max_families: int | None = None,
    ):
        from prometheus_client import REGISTRY, Gauge

        from foremast_tpu_torch.observe.spans import counter

        self._Gauge = Gauge
        self.registry = registry if registry is not None else REGISTRY
        self.ns = namespace
        self._fams: dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.max_families = (
            max_families
            if max_families is not None
            else int(
                os.environ.get("FOREMAST_MAX_GAUGE_FAMILIES", "")
                or DEFAULT_MAX_FAMILIES
            )
        )
        # shared-family helper, not a bare Counter: a second BrainGauges
        # on the same registry must reuse the family, not explode on
        # prometheus_client's duplicate-registration check
        self.dropped = counter(
            f"{self.ns}_gauge_families_dropped_total",
            "distinct metric families dropped because the gauge-family "
            "cap was hit",
            registry=self.registry,
        )
        # counted once per distinct family, not per publish — the name
        # says "families dropped" and a per-publish count would read as
        # thousands shed when exactly one metric is over the cap. The
        # dedup set is itself bounded: names arrive from REST-supplied
        # job configs (the very leak the family cap defends against), so
        # past the tracking bound the counter saturates instead of the
        # set growing forever.
        self._dropped_names: set[str] = set()
        self._dropped_track_limit = max(4 * self.max_families, 1024)
        self._cap_warned = False

    def _family(self, metric: str):
        key = _san(metric)
        with self._lock:
            fam = self._fams.get(key)
            if fam is not None:
                return fam
            if len(self._fams) >= self.max_families:
                if (
                    key not in self._dropped_names
                    and len(self._dropped_names) < self._dropped_track_limit
                ):
                    self._dropped_names.add(key)
                    self.dropped.inc()
                if not self._cap_warned:
                    self._cap_warned = True
                    log.warning(
                        "gauge-family cap (%d) hit; dropping new metric "
                        "families from exposition (first dropped: %r) — "
                        "raise FOREMAST_MAX_GAUGE_FAMILIES if the fleet "
                        "legitimately carries more distinct series",
                        self.max_families,
                        metric,
                    )
                return None
            mk = lambda suffix, doc: self._Gauge(
                f"{self.ns}_{key}_{suffix}",
                doc,
                ["exported_namespace", "app"],
                registry=self.registry,
            )
            fam = (
                mk("upper", f"model upper bound for {metric}"),
                mk("lower", f"model lower bound for {metric}"),
                mk("anomaly", f"last anomalous value for {metric}"),
            )
            self._fams[key] = fam
            return fam

    def publish(
        self,
        metric: str,
        namespace: str,
        app: str,
        upper: float,
        lower: float,
        anomaly_value: float | None = None,
    ) -> None:
        fam = self._family(metric)
        if fam is None:  # over the family cap; counted in self.dropped
            return
        up, lo, an = fam
        labels = dict(exported_namespace=namespace, app=app)
        up.labels(**labels).set(upper)
        lo.labels(**labels).set(lower)
        if anomaly_value is not None:
            an.labels(**labels).set(anomaly_value)


# base series name of a BARE-selector PromQL query, e.g.
# `query=namespace_app_per_pod:http_server_requests_latency{...}`. The
# lookahead rejects wrapped expressions (`query=sum(rate(...))` must NOT
# name a gauge "sum" — such jobs fall back to the alias), and the
# leading anchor requires a real parameter boundary (a REST-supplied URL
# with `subquery=foo` must not derive a gauge name from it).
_SERIES_RE = re.compile(r"(?:^|[?&])query=([a-zA-Z_:][a-zA-Z0-9_:]*)(?=\{|&|$)")


def _series_names(config: str) -> dict[str, str]:
    """alias -> base series name from a job config string's queries.

    Uses the canonical config-string codec (`metrics.promql.decode_config`
    — the same strings the brain fetches) and extracts the series from
    each URL; aliases whose query is not a bare selector are omitted, and
    so are aliases whose queries resolve to the SAME base series (two
    colliding aliases publishing one gauge family would silently
    last-write-win each other's verdicts) — in both cases the caller
    falls back to the alias-named gauge."""
    import urllib.parse

    from foremast_tpu_torch.metrics.promql import decode_config

    out: dict[str, str] = {}
    for alias, url in decode_config(config or "").items():
        m = _SERIES_RE.search(urllib.parse.unquote(url))
        if m:
            out[alias] = m.group(1)
    counts: dict[str, int] = {}
    for series in out.values():
        counts[series] = counts.get(series, 0) + 1
    return {a: s for a, s in out.items() if counts[s] == 1}


def make_verdict_hook(gauges: BrainGauges, namespace: str | None = None):
    """BrainWorker.on_verdict adapter: publish the latest band edge and
    anomalous value per metric after each judgment.

    Gauge names follow the reference contract
    (`foremast-browser/src/config/metrics.js:15-23`): the gauge is named
    after the BASE SERIES of the job's historical query — e.g.
    `foremastbrain:namespace_app_per_pod:http_server_requests_latency_upper`
    (exported with '_' for ':'; the generated recording rules restore the
    colon spelling) — NOT after the job's short alias, so the UI, Grafana
    dashboard, and alert rules can all address the band without knowing
    per-app alias conventions. Jobs whose queries carry no parsable series
    name (arbitrary REST clients) fall back to the alias.

    The `exported_namespace` label is derived per-document from the job's
    PromQL selector (`namespace="..."` inside currentConfig) so the gauge
    lands next to the base series it models; the static `namespace`
    argument (default: NAMESPACE env, then "default") is only the
    fallback for jobs whose queries carry no namespace selector."""
    import os
    import urllib.parse

    default_ns = namespace or os.environ.get("NAMESPACE", "default")
    ns_re = re.compile(r'namespace="([^"]+)"')

    def hook(doc, verdicts):
        m = ns_re.search(urllib.parse.unquote(doc.current_config or ""))
        namespace = m.group(1) if m else default_ns
        # historical queries always use the per-app family the browser
        # charts (metricsquery.go:73-78); fall back to the current config
        names = _series_names(doc.historical_config) or _series_names(
            doc.current_config
        )
        for v in verdicts:
            if len(v.upper) == 0:
                continue
            gauges.publish(
                metric=names.get(v.alias, v.alias),
                namespace=namespace,
                app=doc.app_name,
                upper=float(v.upper[-1]),
                lower=float(v.lower[-1]),
                anomaly_value=(
                    float(v.anomaly_pairs[-1]) if v.anomaly_pairs else None
                ),
            )

    return hook


class WorkerMetrics:
    """Engine self-telemetry counters (alongside the foremastbrain gauges):

        foremast_worker_jobs_total{status}   — documents finalized/updated
        foremast_worker_windows_total        — metric windows judged
        foremast_worker_tick_seconds         — claim-fetch-judge-write time
        foremast_worker_arena_{hits,misses,evictions}_total — device
            state-arena traffic: a rising miss/eviction rate under a
            stable fleet means claim churn is re-paying state scatters
        foremast_worker_fast_docs_total{kind} — documents scored on the
            columnar fast path, by model kind
        foremast_worker_pipeline_* {path} — chunk pipeline occupancy
            (slow = cold chunk pipeline, warm = sliced sweep)
        foremast_sweep_slices_total, foremast_sweep_preempt_events_total
            {action} — sliced sweeps and their boundary preemptions
        foremast_cold_hist_reads_total{source} — cold-fit history
            serving source (ring_full / ring_partial / http / cache /
            unserved)
        foremast_refine_docs_total{result}, foremast_provisional_fits —
            refinement of short-history fits and its backlog
        foremast_verdict_latency_seconds{path,tenant},
        foremast_microtick_docs_total — the reactive plane
        foremast_device_mesh_devices, foremast_device_mesh_rows_total
            {kind}, foremast_device_mesh_arena_bytes,
            foremast_device_mesh_transfer_{seconds,bytes}_total{leg} —
            the judge's device mesh (fed only by a mesh worker)

    The families, types and labels are the JAX worker's, and only those
    that this worker feeds.
    """

    def __init__(self, registry=None):
        from prometheus_client import REGISTRY, Counter, Gauge, Histogram

        reg = registry if registry is not None else REGISTRY
        # exposed so late-bound custom collectors (tenant attribution)
        # can join this worker's exposition registry
        self.registry = reg
        self.jobs = Counter(
            "foremast_worker_jobs_total",
            "documents processed, by resulting status",
            ["status"],
            registry=reg,
        )
        self.windows = Counter(
            "foremast_worker_windows_total",
            "metric windows judged",
            registry=reg,
        )
        self.tick_seconds = Histogram(
            "foremast_worker_tick_seconds",
            "duration of one claim-fetch-judge-write cycle",
            registry=reg,
        )
        self.arena = Counter(
            "foremast_worker_arena_events_total",
            "device state-arena row events (hit=gathered warm, "
            "miss=scattered, eviction=row recycled under pressure, "
            "shard_move=row re-homed when its batch shard changed)",
            ["event"],
            registry=reg,
        )
        # per-kind columnar-path doc counts: joint kinds
        # (bivariate/lstm) > 0 is the observable proof that multi-alias
        # docs ride the fast tick instead of the per-task object path
        self.fast_docs = Counter(
            "foremast_worker_fast_docs_total",
            "documents scored on the columnar fast path, by model kind "
            "(univariate / bivariate / lstm)",
            ["kind"],
            registry=reg,
        )
        self._arena_last = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "shard_moves": 0,
            "fallbacks": 0,
        }
        # chunk-pipeline occupancy (jobs/pipeline.py), by path: the
        # "slow" path is the cold chunk pipeline, the "warm"
        # path is the sliced sweep's claim-pool pipeline —
        # warm-tick host stalls were invisible before the label. The
        # idle counter answers "how long did the judge stage sit
        # waiting on its inputs", the gauges snapshot the latest run.
        self.pipeline_idle = Counter(
            "foremast_worker_pipeline_idle_seconds_total",
            "seconds the judge stage (the tick thread) sat stalled "
            "waiting for a chunk's inputs, by pipeline path (slow = cold "
            "chunk pipeline, warm = sliced-sweep pipeline)",
            ["path"],
            registry=reg,
        )
        self.pipeline_overlap = Gauge(
            "foremast_worker_pipeline_overlap_ratio",
            "latest tick per path: fraction of stage-busy seconds "
            "hidden by fetch/judge/write overlap (0 = serial, ~0.67 = "
            "perfect three-stage overlap)",
            ["path"],
            registry=reg,
        )
        self.pipeline_queue = Gauge(
            "foremast_worker_pipeline_write_queue_peak",
            "latest tick per path: peak depth of the verdict "
            "write-back queue",
            ["path"],
            registry=reg,
        )
        # sliced, preemptible sweeps
        self.sweep_slices = Counter(
            "foremast_sweep_slices_total",
            "bounded slices executed by sliced sweeps "
            "(FOREMAST_SWEEP_SLICE_DOCS)",
            registry=reg,
        )
        self.sweep_preempt = Counter(
            "foremast_sweep_preempt_events_total",
            "slice-boundary preemption outcomes (promoted = pooled "
            "docs pulled into the next slice, inflight_requeued = "
            "arrival retried behind an in-flight slice, microtick = "
            "nested micro-tick ran between slices)",
            ["action"],
            registry=reg,
        )
        # where each cold fit's historical range was served from,
        # refinement outcomes, and the provisional-fit backlog: the
        # Prometheus twins of the /debug/state `cold_start` section
        self.cold_hist = Counter(
            "foremast_cold_hist_reads_total",
            "historical-range reads on the cold-fit path, by serving "
            "source (ring_full / ring_partial / http / cache / "
            "unserved)",
            ["source"],
            registry=reg,
        )
        self.refine_docs = Counter(
            "foremast_refine_docs_total",
            "background-refinement outcomes for provisional "
            "short-history fits (refit / finalized / settled)",
            ["result"],
            registry=reg,
        )
        self.provisional = Gauge(
            "foremast_provisional_fits",
            "provisional (short-history) fits awaiting background "
            "refinement",
            registry=reg,
        )
        # reactive plane: the push->verdict histogram (receiver arrival
        # stamp, on the RECEIVER's clock, to verdict write) by the tick
        # path that wrote it (micro = ingest-triggered micro-tick, sweep =
        # full tick catch-all), plus the micro-tick doc count. `tenant` is
        # bounded-cardinality: configured tenants + up to
        # FOREMAST_TENANT_LABEL_MAX observed label values, everything past
        # the cap folded into `other`; untenanted workers export one
        # constant `default` series per path (worker._observe_verdicts
        # owns the folding)
        self.verdict_latency = Histogram(
            "foremast_verdict_latency_seconds",
            "push receive-instant to verdict write, by judging path "
            "(micro = ingest-triggered micro-tick, sweep = full tick) "
            "and tenant (bounded by FOREMAST_TENANT_LABEL_MAX + the "
            "`other` overflow bucket)",
            ["path", "tenant"],
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 15.0, 60.0, 300.0),
            registry=reg,
        )
        self.microtick_docs = Counter(
            "foremast_microtick_docs_total",
            "documents judged by ingest-triggered micro-ticks",
            registry=reg,
        )
        # device mesh (BrainWorker._device_mesh_state): shape, padded
        # rows (bucket + data-axis rounding), arena device bytes
        # (per-device bytes x device count — the shard sum under the
        # default sharded layout), and the placement / result-fetch legs
        self.mesh_devices = Gauge(
            "foremast_device_mesh_devices",
            "devices in the judge's (data x model) mesh (1 family "
            "absent = single-device judge)",
            registry=reg,
        )
        self.mesh_rows = Counter(
            "foremast_device_mesh_rows_total",
            "columnar batch rows dispatched over the mesh, real vs "
            "padding (bucket + data-axis rounding)",
            ["kind"],
            registry=reg,
        )
        self.mesh_arena_bytes = Gauge(
            "foremast_device_mesh_arena_bytes",
            "state-arena device bytes across the mesh (each distinct "
            "data-axis device's buffer once: a replica each, or its "
            "shard blocks)",
            registry=reg,
        )
        self.mesh_transfer_seconds = Counter(
            "foremast_device_mesh_transfer_seconds_total",
            "host<->device transfer wall-clock on the sharded judge, "
            "by leg (h2d = NamedSharding placement, gather = sharded-"
            "result fetch incl. the deferred device execution it waits "
            "on)",
            ["leg"],
            registry=reg,
        )
        self.mesh_transfer_bytes = Counter(
            "foremast_device_mesh_transfer_bytes_total",
            "bytes moved by the sharded judge's host<->device legs",
            ["leg"],
            registry=reg,
        )
        self._mesh_last = {
            "rows_real": 0, "rows_pad": 0,
            "h2d_s": 0.0, "h2d_b": 0,
            "gather_s": 0.0, "gather_b": 0,
        }

    def observe_pipeline(self, stats, path: str = "slow") -> None:
        """Feed one ChunkPipeline run's stats (jobs/pipeline.py
        PipelineStats) — path "slow" for the cold chunk pipeline,
        "warm" for the sliced sweep's."""
        self.pipeline_idle.labels(path=path).inc(
            max(0.0, stats.judge_stall_seconds)
        )
        self.pipeline_overlap.labels(path=path).set(stats.overlap_ratio())
        self.pipeline_queue.labels(path=path).set(stats.write_queue_peak)

    def observe_sweep(self, stats, counters: dict) -> None:
        """Feed one sliced sweep's pipeline stats + preemption counters
        (BrainWorker._sweep_sliced)."""
        if stats is not None:
            self.observe_pipeline(stats, path="warm")
        self.sweep_slices.inc(counters.get("slices", 0))
        for action, key in (
            ("promoted", "promoted"),
            ("inflight_requeued", "inflight_requeued"),
            ("microtick", "preempt_microticks"),
        ):
            n = counters.get(key, 0)
            if n:
                self.sweep_preempt.labels(action=action).inc(n)

    def observe_doc(self, status: str, n_windows: int) -> None:
        self.jobs.labels(status=status).inc()
        self.windows.inc(n_windows)

    def observe_device_mesh(self, state: dict) -> None:
        """Feed the worker's cumulative device_mesh varz section
        (BrainWorker._device_mesh_state); deltas keep the counters
        monotone, and a negative delta (a new judge) clamps to zero."""
        self.mesh_devices.set(state.get("devices", 1))
        self.mesh_arena_bytes.set(state.get("arena_total_device_bytes", 0))
        last = self._mesh_last
        pad = state.get("pad_rows_total", 0)
        real = state.get("batch_rows_total", 0) - pad
        cur = {
            "rows_real": real,
            "rows_pad": pad,
            "h2d_s": state.get("place_seconds", 0.0),
            "h2d_b": state.get("place_bytes", 0),
            "gather_s": state.get("fetch_seconds", 0.0),
            "gather_b": state.get("fetch_bytes", 0),
        }
        sinks = {
            "rows_real": (self.mesh_rows, {"kind": "real"}),
            "rows_pad": (self.mesh_rows, {"kind": "pad"}),
            "h2d_s": (self.mesh_transfer_seconds, {"leg": "h2d"}),
            "h2d_b": (self.mesh_transfer_bytes, {"leg": "h2d"}),
            "gather_s": (self.mesh_transfer_seconds, {"leg": "gather"}),
            "gather_b": (self.mesh_transfer_bytes, {"leg": "gather"}),
        }
        for k, (family, labels) in sinks.items():
            delta = cur[k] - last[k]
            if delta > 0:
                family.labels(**labels).inc(delta)
            last[k] = cur[k]

    def observe_arena(self, counters: dict) -> None:
        """Feed cumulative judge.device_state_counters(); deltas are
        exported so the Prometheus counters stay monotone. The source is
        itself monotone across arena rebuilds (retired arenas fold into
        HealthJudge._counters_base), so no re-baseline heuristic is
        needed — a negative delta can only mean a new judge instance and
        is clamped to zero rather than guessed at."""
        for event in (
            "hits",
            "misses",
            "evictions",
            "shard_moves",
            "fallbacks",
        ):
            cur = counters.get(event, 0)
            delta = cur - self._arena_last[event]
            if delta > 0:
                self.arena.labels(event=event).inc(delta)
            self._arena_last[event] = cur
