"""Metric naming-convention lint: the dashboard contract, for the port.

The port's own copy of `foremast_tpu/observe/metrics_lint.py`. Every
family the port exports must match ``foremast(brain)?_[a-z0-9_]+`` (the
two prefixes the deployed dashboards, recording rules and alert rules
key on), and the core families must carry exactly their documented label
sets, the same table as the JAX package's, so one dashboard reads either
engine. A renamed family or an added label fails this lint instead of
silently breaking every dashboard built on it.

`prometheus_client` is imported inside the functions that build a
registry, never when this module is imported.

Usage:
    lint_registry(registry) -> list of violation strings (empty = clean)
    python -m foremast_tpu_torch.observe.metrics_lint   # lints the default set
"""

from __future__ import annotations

import re

NAME_RE = re.compile(r"^foremast(brain)?_[a-z0-9_]+$")
LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# prometheus_client-internal sample labels that are not family labels
_SYNTHETIC_LABELS = frozenset({"le", "quantile"})

# family name (as collected — counters are collected WITHOUT the _total
# suffix) -> exact allowed label set. Families not listed here only need
# the name/label regexes.
ALLOWED_LABELS: dict[str, frozenset[str]] = {
    "foremast_tick_stage_seconds": frozenset({"stage"}),
    "foremast_worker_jobs": frozenset({"status"}),
    "foremast_worker_windows": frozenset(),
    "foremast_worker_tick_seconds": frozenset(),
    "foremast_worker_arena_events": frozenset({"event"}),
    "foremast_worker_fast_docs": frozenset({"kind"}),
    # chunk-pipeline occupancy (observe/gauges.py WorkerMetrics), by
    # path: "slow" = the cold chunk pipeline, "warm" = the sliced
    # sweep's claim-pool pipeline
    "foremast_worker_pipeline_idle_seconds": frozenset({"path"}),
    "foremast_worker_pipeline_overlap_ratio": frozenset({"path"}),
    "foremast_worker_pipeline_write_queue_peak": frozenset({"path"}),
    # sliced, preemptible sweeps (observe/gauges.py WorkerMetrics)
    "foremast_sweep_slices": frozenset(),
    "foremast_sweep_preempt_events": frozenset({"action"}),
    # ring-first cold start + background refinement (observe/gauges.py
    # WorkerMetrics)
    "foremast_cold_hist_reads": frozenset({"source"}),
    "foremast_refine_docs": frozenset({"result"}),
    "foremast_provisional_fits": frozenset(),
    # reactive plane: push→verdict SLO + micro-tick traffic
    # (worker: observe/gauges.py; dirty set: reactive/dirty.py
    # ReactiveCollector; watch stream: reactive/watchstream.py)
    "foremast_verdict_latency_seconds": frozenset({"path", "tenant"}),
    # device mesh (observe/gauges.py WorkerMetrics)
    "foremast_device_mesh_devices": frozenset(),
    "foremast_device_mesh_rows": frozenset({"kind"}),
    "foremast_device_mesh_arena_bytes": frozenset(),
    "foremast_device_mesh_transfer_seconds": frozenset({"leg"}),
    "foremast_device_mesh_transfer_bytes": frozenset({"leg"}),
    "foremast_microtick_docs": frozenset(),
    "foremast_microtick_dirty_events": frozenset({"event"}),
    "foremast_microtick_dirty_pending": frozenset(),
    "foremast_watch_stream_events": frozenset({"type"}),
    "foremast_watch_stream_restarts": frozenset({"reason"}),
    "foremast_service_requests": frozenset({"route", "code"}),
    "foremast_controller_transitions": frozenset({"phase"}),
    "foremastbrain_gauge_families_dropped": frozenset(),
    # ingest plane (ingest/receiver.py IngestCollector)
    "foremast_ingest_fetches": frozenset({"result"}),
    "foremast_ingest_samples": frozenset(),
    "foremast_ingest_evictions": frozenset(),
    "foremast_ingest_series_resident": frozenset(),
    "foremast_ingest_bytes_resident": frozenset(),
    "foremast_ingest_receiver_lag_seconds": frozenset(),
    "foremast_ingest_requests": frozenset({"codec"}),
    "foremast_ingest_stage_seconds": frozenset({"codec", "stage"}),
    # worker mesh (mesh/node.py MeshCollector)
    "foremast_mesh_members": frozenset({"state"}),
    "foremast_mesh_rebalances": frozenset(),
    "foremast_mesh_redirect_hints": frozenset(),
    "foremast_mesh_claim_docs": frozenset({"result"}),
    # planned handoff (mesh/node.py MeshCollector)
    "foremast_handoff_state": frozenset({"kind", "direction"}),
    "foremast_handoff_transfers": frozenset({"role", "result"}),
    # chaos plane + degradation (chaos/collector.py)
    "foremast_chaos_injections": frozenset({"edge", "kind"}),
    "foremast_breaker_state": frozenset({"edge"}),
    "foremast_breaker_transitions": frozenset({"edge", "state"}),
    "foremast_breaker_short_circuits": frozenset({"edge"}),
    "foremast_degraded_docs": frozenset({"reason"}),
    "foremast_degraded_events": frozenset({"edge", "action"}),
    # multi-tenant QoS plane (tenant/collector.py TenantCollector) — `tenant` is bounded-cardinality: configured
    # tenants + up to FOREMAST_TENANT_LABEL_MAX observed values, the
    # rest folded into `other`
    "foremast_tenant_shed": frozenset({"tenant"}),
    "foremast_tenant_evictions": frozenset({"tenant"}),
    "foremast_tenant_claims": frozenset({"tenant"}),
    "foremast_tenant_ring_bytes": frozenset({"tenant"}),
    # durable data plane (ingest/snapshot.py SnapshotCollector)
    "foremast_snapshot_discards": frozenset({"reason"}),
    "foremast_snapshot_restored_series": frozenset(),
    "foremast_snapshot_restored_samples": frozenset(),
    "foremast_snapshot_restored_fits": frozenset(),
    "foremast_snapshot_writes": frozenset(),
    "foremast_snapshot_age_seconds": frozenset(),
}

# one-line operator meaning per family: the help index, the JAX
# package's word for word (its docs/observability.md table renders from
# it). Keys match ALLOWED_LABELS (collected names: counters WITHOUT
# their `_total` suffix).
FAMILY_DOCS: dict[str, str] = {
    "foremast_tick_stage_seconds": (
        "histogram of one judgment-tick stage (worker stages: claim … "
        "write_back; controller stages: poll … pause)"
    ),
    "foremast_worker_jobs": "documents finalized, by resulting status",
    "foremast_worker_windows": "metric windows judged",
    "foremast_worker_tick_seconds": (
        "histogram of the whole claim-fetch-judge-write cycle"
    ),
    "foremast_worker_arena_events": (
        "device state-arena traffic (hits/misses/evictions/"
        "shard_moves/fallbacks)"
    ),
    "foremast_worker_fast_docs": (
        "documents scored on the columnar fast path, by model kind "
        "(univariate/bivariate/lstm, plus `baseline` — the canary "
        "bucket: baseline-carrying univariate docs judged through the "
        "pairwise-active columnar program)"
    ),
    "foremast_worker_pipeline_idle_seconds": (
        "seconds the judge stage sat stalled waiting on a chunk's "
        "inputs, by path (slow = cold chunk pipeline, warm = "
        "sliced-sweep pipeline)"
    ),
    "foremast_worker_pipeline_overlap_ratio": (
        "latest tick per path: fraction of stage-busy seconds hidden "
        "by fetch/judge/write overlap"
    ),
    "foremast_worker_pipeline_write_queue_peak": (
        "latest tick per path: peak verdict write-back queue depth"
    ),
    "foremast_sweep_slices": (
        "bounded slices executed by sliced sweeps "
        "(FOREMAST_SWEEP_SLICE_DOCS)"
    ),
    "foremast_sweep_preempt_events": (
        "slice-boundary preemption outcomes (promoted / "
        "inflight_requeued / microtick)"
    ),
    "foremast_cold_hist_reads": (
        "historical-range reads on the cold-fit path, by serving "
        "source (ring_full/ring_partial/http/cache/unserved)"
    ),
    "foremast_refine_docs": (
        "background-refinement outcomes for provisional short-history "
        "fits (refit/finalized/settled)"
    ),
    "foremast_provisional_fits": (
        "provisional (short-history) fits awaiting background "
        "refinement"
    ),
    "foremast_verdict_latency_seconds": (
        "push receive-instant (receiver clock) to verdict write, by "
        "judging path (micro/sweep) and tenant (bounded by "
        "FOREMAST_TENANT_LABEL_MAX + the `other` overflow bucket) — "
        "the reactive plane's SLO"
    ),
    "foremast_microtick_docs": (
        "documents judged by ingest-triggered micro-ticks"
    ),
    "foremast_device_mesh_devices": (
        "devices in the judge's (data x model) mesh"
    ),
    "foremast_device_mesh_rows": (
        "columnar batch rows dispatched over the mesh, real vs pad "
        "(bucket + data-axis rounding)"
    ),
    "foremast_device_mesh_arena_bytes": (
        "state-arena HBM: per-device bytes x device count (shard-sum "
        "under the default sharded layout; the replication tax with "
        "FOREMAST_ARENA_SHARDED=0)"
    ),
    "foremast_device_mesh_transfer_seconds": (
        "sharded-judge host<->device wall-clock by leg (h2d placement "
        "/ sharded-result gather)"
    ),
    "foremast_device_mesh_transfer_bytes": (
        "bytes moved by the sharded judge's host<->device legs"
    ),
    "foremast_microtick_dirty_events": (
        "dirty-set traffic (marked/coalesced/dropped/foreign/"
        "requeued/unattributed/promoted/inflight_requeued)"
    ),
    "foremast_microtick_dirty_pending": (
        "route keys currently pending in the dirty set"
    ),
    "foremast_watch_stream_events": (
        "deployment watch-stream events dispatched, by type"
    ),
    "foremast_watch_stream_restarts": (
        "watch-stream reconnects (gone/stall/error/end)"
    ),
    "foremast_service_requests": (
        "gateway requests by route pattern and status code"
    ),
    "foremast_controller_transitions": (
        "DeploymentMonitor phase transitions observed by the poller"
    ),
    "foremastbrain_gauge_families_dropped": (
        "distinct metric families dropped past the gauge-family cap"
    ),
    "foremast_ingest_fetches": (
        "ring TSDB fetch outcomes (hit/miss/stale/uncovered)"
    ),
    "foremast_ingest_samples": (
        "samples accepted by the ingest plane (receiver + direct push)"
    ),
    "foremast_ingest_evictions": (
        "whole series evicted under FOREMAST_INGEST_BUDGET_BYTES"
    ),
    "foremast_ingest_series_resident": (
        "series currently resident in the ring TSDB"
    ),
    "foremast_ingest_bytes_resident": (
        "column bytes currently allocated by resident series"
    ),
    "foremast_ingest_receiver_lag_seconds": (
        "now minus the newest sample timestamp of the latest push"
    ),
    "foremast_ingest_requests": (
        "push requests decoded by the receiver, by wire codec "
        "(json=compat codec, binary=columnar frame)"
    ),
    "foremast_ingest_stage_seconds": (
        "wall-clock seconds per receiver pipeline stage "
        "(read/decompress/decode/apply), by wire codec"
    ),
    "foremast_mesh_members": (
        "live mesh members (fresh leases, including this worker), by "
        "lifecycle state (active/draining/joining)"
    ),
    "foremast_mesh_rebalances": (
        "hash-ring swaps after membership changes"
    ),
    "foremast_handoff_state": (
        "ring series and fit entries moved by planned handoff, by "
        "payload kind and direction"
    ),
    "foremast_handoff_transfers": (
        "planned-handoff transfer outcomes by role (send/receive); "
        "failed/torn/rejected degrade to cold refits, never a wedge"
    ),
    "foremast_mesh_redirect_hints": (
        "receiver responses pointing a pusher at a series' owner"
    ),
    "foremast_mesh_claim_docs": (
        "documents seen by the partition claim filter (owned/skipped)"
    ),
    "foremast_chaos_injections": (
        "faults injected by the active FOREMAST_CHAOS_PLAN, by "
        "dependency edge and fault kind"
    ),
    "foremast_breaker_state": (
        "circuit-breaker state per dependency edge "
        "(0=closed, 1=half-open, 2=open)"
    ),
    "foremast_breaker_transitions": (
        "circuit-breaker state transitions, by edge and target state"
    ),
    "foremast_breaker_short_circuits": (
        "calls rejected without touching the dependency (breaker open)"
    ),
    "foremast_degraded_docs": (
        "documents handled by degradation machinery (released "
        "un-judged, buffered/replayed/dropped write-backs), by reason"
    ),
    "foremast_degraded_events": (
        "non-per-document degradation events (claim errors survived, "
        "receiver sheds, replay flushes), by edge and action"
    ),
    "foremast_tenant_shed": (
        "pushes shed by per-tenant ingest admission (429 + "
        "Retry-After), charged to the flooding tenant; label bounded "
        "by FOREMAST_TENANT_LABEL_MAX + the `other` overflow bucket"
    ),
    "foremast_tenant_evictions": (
        "ring series / arena rows evicted under a tenant's budget "
        "envelope, charged to the tenant causing the pressure; label "
        "bounded by FOREMAST_TENANT_LABEL_MAX + `other`"
    ),
    "foremast_tenant_claims": (
        "documents claimed for judgment, by owning tenant; label "
        "bounded by FOREMAST_TENANT_LABEL_MAX + `other`"
    ),
    "foremast_tenant_ring_bytes": (
        "ring TSDB column bytes currently resident, by owning tenant; "
        "label bounded by FOREMAST_TENANT_LABEL_MAX + `other`"
    ),
    "foremast_snapshot_discards": (
        "state discarded during snapshot restore, by reason"
    ),
    "foremast_snapshot_restored_series": (
        "ring series restored by the last startup restore"
    ),
    "foremast_snapshot_restored_samples": (
        "ring samples restored by the last startup restore"
    ),
    "foremast_snapshot_restored_fits": (
        "fit-cache entries restored (lazily rehydrated on first claim)"
    ),
    "foremast_snapshot_writes": (
        "ring snapshot passes completed (all shards, atomic rename)"
    ),
    "foremast_snapshot_age_seconds": (
        "seconds since the last completed ring snapshot"
    ),
}


def lint_registry(registry) -> list[str]:
    """Walk a CollectorRegistry and return naming/label violations."""
    problems: list[str] = []
    for family in registry.collect():
        name = family.name
        if not NAME_RE.match(name):
            problems.append(
                f"family {name!r} does not match foremast(brain)?_[a-z0-9_]+"
            )
        labels: set[str] = set()
        for sample in family.samples:
            labels.update(sample.labels)
        labels -= _SYNTHETIC_LABELS
        allowed = ALLOWED_LABELS.get(name)
        if allowed is not None:
            if labels - allowed:
                problems.append(
                    f"family {name!r} carries undocumented labels "
                    f"{sorted(labels - allowed)} (allowed: {sorted(allowed)})"
                )
        else:
            for lb in labels:
                if not LABEL_RE.match(lb):
                    problems.append(
                        f"family {name!r} label {lb!r} does not match "
                        "[a-z][a-z0-9_]*"
                    )
    return problems


def default_registry_families():
    """Instantiate every standard family on a fresh registry — the set a
    deployed worker+service+controller exports — and exercise each once
    so every label combination appears in the exposition."""
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.observe.gauges import BrainGauges, WorkerMetrics
    from foremast_tpu_torch.observe.spans import Tracer, counter

    registry = CollectorRegistry()
    gauges = BrainGauges(registry=registry)
    gauges.publish("error5xx", "ns", "app", upper=1.0, lower=0.0, anomaly_value=2.0)
    metrics = WorkerMetrics(registry=registry)
    metrics.observe_doc("completed_health", 1)
    metrics.observe_arena({"hits": 1, "misses": 1, "evictions": 0, "fallbacks": 0})
    metrics.tick_seconds.observe(0.01)
    for kind in ("univariate", "bivariate", "lstm"):
        metrics.fast_docs.labels(kind=kind).inc()
    for path in ("micro", "sweep"):
        metrics.verdict_latency.labels(path=path, tenant="default").observe(
            0.1
        )
    metrics.microtick_docs.inc()
    for path in ("slow", "warm"):
        metrics.pipeline_idle.labels(path=path).inc(0.0)
        metrics.pipeline_overlap.labels(path=path).set(0.0)
        metrics.pipeline_queue.labels(path=path).set(0)
    metrics.sweep_slices.inc()
    for action in ("promoted", "inflight_requeued", "microtick"):
        metrics.sweep_preempt.labels(action=action).inc()
    tracer = Tracer(service="lint", registry=registry, trace_dir=None)
    from foremast_tpu_torch.observe.spans import TICK_STAGES

    for stage in TICK_STAGES:
        with tracer.span(f"lint.{stage}", stage=stage):
            pass
    counter(
        "foremast_service_requests_total",
        "service requests by route and status code",
        ("route", "code"),
        registry,
    ).labels(route="/healthz", code="200").inc()
    counter(
        "foremast_controller_transitions_total",
        "monitor phase transitions observed by the controller",
        ("phase",),
        registry,
    ).labels(phase="Healthy").inc()
    # ingest plane: exercise every outcome so each label value appears
    from foremast_tpu_torch.ingest import IngestCollector, RingStore, WireStats

    ring = RingStore(budget_bytes=1 << 20, shards=1)
    ring.push("lint_series", [60, 120], [1.0, 2.0], start=0.0, now=180.0)
    ring.query("lint_series", 0.0, 120.0, now=180.0)  # hit
    ring.query("lint_absent", 0.0, 120.0, now=180.0)  # miss
    wire = WireStats()  # both codecs, every stage label
    for codec in ("json", "binary"):
        wire.record(
            codec,
            {"read": 0.001, "decompress": 0.0, "decode": 0.002,
             "apply": 0.001},
            samples=2,
            ok=True,
        )
    registry.register(IngestCollector(ring, wire=wire))
    # worker mesh: a one-member node with both claim outcomes exercised
    from foremast_tpu_torch.jobs.models import Document
    from foremast_tpu_torch.jobs.store import InMemoryStore
    from foremast_tpu_torch.mesh import MeshCollector, MeshNode, Membership, MeshRouter

    membership = Membership(InMemoryStore(), "lint-worker", lease_seconds=60)
    node = MeshNode(membership, MeshRouter(membership))
    node.start()
    node.claim_filter(Document(id="lint-doc", app_name="lint-app"))
    node.claim_counts["skipped"] += 1  # both label values must appear
    registry.register(MeshCollector(node))
    # chaos plane: a plan with one fired rule, a breaker walked through
    # its states, and one counter of each degradation family
    from foremast_tpu_torch.chaos import ChaosCollector, Degradation, FaultPlan

    plan = FaultPlan(
        rules=({"edge": "lint", "error_rate": 1.0},), seed=1
    ).activate()
    try:
        plan.edge("lint").perturb("lint-op")
    except ConnectionError:
        pass
    degrade = Degradation(chaos_plan=plan)
    br = degrade.breakers.get("lint")
    for _ in range(br.failure_threshold):
        br.record_failure()
    degrade.stats.count_docs("deadline_released")
    degrade.stats.count_event("receiver", "shed")
    registry.register(ChaosCollector(degrade))
    # reactive plane: dirty-set traffic + the watch-stream families
    from foremast_tpu_torch.reactive import DirtySet, ReactiveCollector
    from foremast_tpu_torch.reactive.watchstream import WatchStreamMetrics

    dirty = DirtySet(max_keys=2)
    dirty.mark_series('up{app="lint"}')
    dirty.mark_series('up{app="lint"}')  # coalesced
    dirty.mark("lint-requeue", 1.0, requeue=True)
    dirty.mark("lint-extra")  # overflows max_keys=2: dropped
    dirty.count("unattributed")
    registry.register(ReactiveCollector(dirty))
    # multi-tenant QoS plane: a two-tenant registry with one nonzero
    # sample per family so every foremast_tenant_* series is exported
    from foremast_tpu_torch.tenant import (
        TenantAccounting,
        TenantCollector,
        TenantRegistry,
        TenantSpec,
    )

    tenancy = TenantRegistry(
        {
            "default": TenantSpec(name="default"),
            "lint": TenantSpec(name="lint", weight=2.0),
        }
    )
    acct = TenantAccounting(tenancy)
    acct.count_shed("lint")
    acct.count_eviction("lint")
    acct.count_claims("default")
    acct.add_ring_bytes("lint", 1024)
    registry.register(TenantCollector(acct))
    ws = WatchStreamMetrics(registry=registry)
    for etype in ("added", "modified", "deleted", "error"):
        ws.events.labels(type=etype).inc()
    for reason in ("gone", "stall", "error", "end"):
        ws.restarts.labels(reason=reason).inc()
    return registry


def main() -> int:
    problems = lint_registry(default_registry_families())
    if problems:
        for p in problems:
            print(f"metrics-lint: {p}")
        return 1
    print("metrics-lint: all exported families conform")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
