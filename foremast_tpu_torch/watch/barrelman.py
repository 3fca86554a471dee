"""Deployment watcher — the core controller of the watch plane.

Behavior parity with `foremast-barrelman/pkg/controller/Barrelman.go`:

* add/update/delete handling for labeled Deployments (the ``app`` label is
  required, Barrelman.go:310-313); canary detected by the
  ``-foremast-canary`` name suffix (Barrelman.go:62,326-328).
* update trigger = container image or env diff (EnvArrayEquals,
  Barrelman.go:127-137,224-234).
* namespace gating: hard blacklist {kube-public, kube-system, opa,
  monitoring} + ``foremast.ai/monitoring: "false"`` namespace annotation,
  cached 5 min (Barrelman.go:93-101,477-494).
* metadata fallback chain: app name -> ``appType`` label in the app's
  namespace -> ``appType`` in the watcher's own namespace; lookup errors
  negative-cached 1 min (Barrelman.go:139-174).
* rollback-loop suppression: skip when the new revision equals the
  monitor's rollbackRevision or the legacy rollback annotation is set
  (Barrelman.go:238-253).
* pod/RS discovery: ReplicaSets owned by the Deployment with replicas>0;
  newest revision = current pods, older = baseline pods; bounded
  sleep-retries (Barrelman.go:632-780).
* monitor window: 10 min analysis (watchTime), 30 min expiry
  (waitUntilMax) (Barrelman.go:52-54).
* continuous mode re-arms through ``monitor_continuously``
  (Barrelman.go:176-203) using app-aggregated queries with no pod pinning
  (metricsquery.go:56-58).

Structure differs deliberately: no goroutines/workqueues — the plane is a
single-threaded event loop over the pluggable KubeClient, and all blocking
retries take an injectable sleep/clock so tests run instantly.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Callable

from foremast_tpu_torch.jobs.models import AnalyzeRequest
from foremast_tpu_torch.jobs.store import now_rfc3339
from foremast_tpu_torch.metrics.promql import (
    STRATEGY_CANARY,
    STRATEGY_CONTINUOUS,
    STRATEGY_ROLLING_UPDATE,
    create_metrics_info,
)
from foremast_tpu_torch.watch.analyst import AnalystClient, HttpAnalyst
from foremast_tpu_torch.watch.crds import (
    CANARY_SUFFIX,
    MONITOR_OPT_OUT_ANNOTATION,
    ROLLBACK_ANNOTATION,
    DeploymentMetadata,
    DeploymentMonitor,
    MonitorPhase,
    MonitorStatus,
    Remediation,
)
from foremast_tpu_torch.watch.kubeapi import (
    KubeClient,
    NotFound,
    deployment_containers,
    deployment_revision,
    owner_uids,
    record_event,
)

log = logging.getLogger("foremast_tpu_torch.watch")

NAMESPACE_BLACKLIST = frozenset({"kube-public", "kube-system", "opa", "monitoring"})
NAMESPACE_CACHE_TTL = 300.0  # 5 min, Barrelman.go:99-101
METADATA_NEG_CACHE_TTL = 60.0  # 1 min, Barrelman.go:139-174
WATCH_TIME_SECONDS = 600  # 10 min analysis window, Barrelman.go:52
WAIT_UNTIL_MAX_SECONDS = 1800  # 30 min expiry, Barrelman.go:54
POD_RETRY_COUNT = 3  # Barrelman.go:632-780
POD_RETRY_SLEEP = 5.0

APP_TYPE_LABEL = "appType"


def _rfc3339(ts: float) -> str:
    return _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(ts))


def env_equals(a: list[dict] | None, b: list[dict] | None) -> bool:
    """Order-insensitive env-var list equality (EnvArrayEquals,
    Barrelman.go:127-137)."""

    def norm(env):
        return sorted(
            (e.get("name", ""), e.get("value", ""), str(e.get("valueFrom", "")))
            for e in (env or [])
        )

    return norm(a) == norm(b)


def containers_changed(old: dict, new: dict) -> bool:
    """True when any container image or env changed (Barrelman.go:224-234)."""
    olds = {c.get("name"): c for c in deployment_containers(old)}
    news = {c.get("name"): c for c in deployment_containers(new)}
    if set(olds) != set(news):
        return True
    for name, nc in news.items():
        oc = olds[name]
        if oc.get("image") != nc.get("image"):
            return True
        if not env_equals(oc.get("env"), nc.get("env")):
            return True
    return False


class Barrelman:
    def __init__(
        self,
        kube: KubeClient,
        own_namespace: str = "foremast",
        analyst_factory: Callable[[str], AnalystClient] | None = None,
        clock: Callable[[], float] = _time.time,
        sleep: Callable[[float], None] = _time.sleep,
    ) -> None:
        self.kube = kube
        self.own_namespace = own_namespace
        self.analyst_factory = analyst_factory or HttpAnalyst
        self.clock = clock
        self.sleep = sleep
        self._ns_cache: dict[str, tuple[float, bool]] = {}
        self._md_neg_cache: dict[str, float] = {}

    # ------------------------------------------------------------------
    # informer-equivalent entry points
    # ------------------------------------------------------------------

    def handle_deployment(self, event: str, dep: dict, old: dict | None) -> None:
        """Dispatch an add/update/delete Deployment event
        (Barrelman.go:310-464)."""
        meta = dep.get("metadata", {})
        namespace, name = meta.get("namespace", ""), meta.get("name", "")
        app = (meta.get("labels", {}) or {}).get("app")
        if not app:
            return  # app label required, Barrelman.go:310-313
        if not self.namespace_monitored(namespace):
            return

        if event == "delete":
            try:
                self.kube.delete_monitor(namespace, name)
            except NotFound:
                pass
            return

        if name.endswith(CANARY_SUFFIX):
            # canary Deployment created/changed -> monitor against the
            # primary; status-only churn (replica counts, conditions) must
            # not restart the analysis window
            if event == "add" or (old is not None and containers_changed(old, dep)):
                self.monitor_deployment(dep, old, strategy=STRATEGY_CANARY)
        elif event == "add":
            # ensure a monitor CR exists for every labeled Deployment
            self._ensure_monitor(dep)
        elif event == "update" and old is not None and containers_changed(old, dep):
            self.monitor_deployment(dep, old, strategy=STRATEGY_ROLLING_UPDATE)

    # ------------------------------------------------------------------
    # gating + metadata resolution
    # ------------------------------------------------------------------

    def namespace_monitored(self, namespace: str) -> bool:
        """Blacklist + annotation opt-out with a 5-min TTL cache
        (Barrelman.go:93-101,477-494)."""
        if namespace in NAMESPACE_BLACKLIST:
            return False
        now = self.clock()
        cached = self._ns_cache.get(namespace)
        if cached and now - cached[0] < NAMESPACE_CACHE_TTL:
            return cached[1]
        monitored = True
        try:
            ns = self.kube.get_namespace(namespace)
            ann = ns.get("metadata", {}).get("annotations", {}) or {}
            monitored = ann.get(MONITOR_OPT_OUT_ANNOTATION, "true") != "false"
        except NotFound:
            pass
        self._ns_cache[namespace] = (now, monitored)
        return monitored

    def get_metadata(self, dep: dict) -> DeploymentMetadata | None:
        """app name -> appType label (same ns) -> appType (own ns), with a
        1-min negative cache (Barrelman.go:139-174)."""
        meta = dep.get("metadata", {})
        namespace = meta.get("namespace", "")
        labels = meta.get("labels", {}) or {}
        app = labels.get("app", "")
        app_type = labels.get(APP_TYPE_LABEL, "")
        candidates = [(namespace, app)]
        if app_type:
            candidates.append((namespace, app_type))
            candidates.append((self.own_namespace, app_type))
        now = self.clock()
        for ns, name in candidates:
            if not name:
                continue
            key = f"{ns}/{name}"
            neg = self._md_neg_cache.get(key)
            if neg and now - neg < METADATA_NEG_CACHE_TTL:
                continue
            try:
                return self.kube.get_metadata(ns, name)
            except NotFound:
                self._md_neg_cache[key] = now
        return None

    # ------------------------------------------------------------------
    # monitoring
    # ------------------------------------------------------------------

    def monitor_deployment(self, dep: dict, old: dict | None, strategy: str) -> None:
        """Validate, suppress rollback loops, then start an analysis job
        (monitorDeployment, Barrelman.go:205-263)."""
        meta = dep.get("metadata", {})
        namespace, name = meta.get("namespace", ""), meta.get("name", "")
        metadata = self.get_metadata(dep)
        if metadata is None:
            log.info("no DeploymentMetadata for %s/%s; skipping", namespace, name)
            return
        ann = meta.get("annotations", {}) or {}
        if ann.get(ROLLBACK_ANNOTATION):
            # rollback in flight (Barrelman.go:245-253). The v1beta1 API
            # server consumed this annotation; on apps/v1 our controller
            # sets it, so consume it here (null deletes under strategic
            # merge) or the app would never be monitored again.
            self.kube.patch_deployment(
                namespace, name, {"metadata": {"annotations": {ROLLBACK_ANNOTATION: None}}}
            )
            return
        revision = deployment_revision(dep)
        try:
            monitor = self.kube.get_monitor(namespace, self._monitor_name(name))
            if monitor.rollback_revision and revision == monitor.rollback_revision:
                return  # this update IS our own rollback
        except NotFound:
            monitor = None
        self.monitor_new_deployment(dep, old, strategy, metadata)

    def monitor_continuously(self, monitor: DeploymentMonitor) -> None:
        """Re-arm a continuous watch: app-aggregated queries, no pod
        pinning (Barrelman.go:176-203, metricsquery.go:56-58)."""
        try:
            dep = self.kube.get_deployment(monitor.namespace, monitor.name)
        except NotFound:
            return
        metadata = self.get_metadata(dep)
        if metadata is None:
            return
        self.monitor_new_deployment(dep, None, STRATEGY_CONTINUOUS, metadata)

    def monitor_new_deployment(
        self,
        dep: dict,
        old: dict | None,
        strategy: str,
        metadata: DeploymentMetadata,
    ) -> None:
        """Discover pods, start the analyst job (retry once), upsert the
        DeploymentMonitor (monitorNewDeployment, Barrelman.go:783-899)."""
        meta = dep.get("metadata", {})
        namespace, name = meta.get("namespace", ""), meta.get("name", "")
        app = (meta.get("labels", {}) or {}).get("app", name)

        current_pods: list[str] = []
        baseline_pods: list[str] = []
        if strategy != STRATEGY_CONTINUOUS:
            current_pods, baseline_pods = self.get_pod_names(dep)
            if not current_pods:
                log.warning("no pods found for %s/%s; aborting monitor", namespace, name)
                return
            if strategy == STRATEGY_CANARY and not baseline_pods:
                # a canary Deployment owns only its own ReplicaSet; the
                # baseline population is the PRIMARY Deployment's pods
                # (reference walks the old Deployment's ReplicaSets,
                # Barrelman.go:632-780)
                try:
                    primary = self.kube.get_deployment(
                        namespace, name.removesuffix(CANARY_SUFFIX)
                    )
                    primary_cur, primary_old = self.get_pod_names(primary)
                    baseline_pods = primary_cur + primary_old
                except NotFound:
                    pass

        now = self.clock()
        start = now
        end = now + WATCH_TIME_SECONDS
        info = create_metrics_info(
            strategy=strategy,
            metric_names=metadata.metric_names(),
            namespace=namespace,
            app=app,
            start=int(start),
            end=int(end),
            endpoint=metadata.metrics_endpoint,
            new_pods=current_pods,
            old_pods=baseline_pods,
        )
        req = AnalyzeRequest(
            app_name=app,
            start_time=_rfc3339(start),
            end_time=_rfc3339(end),
            metrics=info,
            strategy=strategy,
            namespace=namespace,
        )
        job_id = self._start_job(metadata.analyst_endpoint, req)
        if job_id is None:
            phase, reason = MonitorPhase.FAILED, "analyst create failed"
        else:
            phase, reason = MonitorPhase.RUNNING, ""

        monitor = self._get_or_new_monitor(namespace, name, app)
        monitor.analyst_endpoint = metadata.analyst_endpoint
        monitor.start_time = _rfc3339(start)
        monitor.wait_until = _rfc3339(now + WAIT_UNTIL_MAX_SECONDS)
        monitor.continuous = monitor.continuous or strategy == STRATEGY_CONTINUOUS
        if old is not None:
            monitor.rollback_revision = deployment_revision(old)
        monitor.status = MonitorStatus(
            job_id=job_id or "",
            phase=phase,
            timestamp=now_rfc3339(),
        )
        if reason:
            monitor.status.anomaly = {"reason": reason}
        self.kube.upsert_monitor(monitor)
        record_event(
            self.kube,
            namespace,
            name,
            reason="MonitoringStarted" if job_id else "AnalystUnavailable",
            message=(
                f"health analysis job {job_id} started ({strategy})"
                if job_id
                else "could not create analysis job"
            ),
            event_type="Normal" if job_id else "Warning",
        )

    def _start_job(self, endpoint: str, req: AnalyzeRequest) -> str | None:
        """StartAnalyzing with the reference's retry-once
        (Barrelman.go:819-826)."""
        client = self.analyst_factory(endpoint)
        for attempt in (1, 2):
            try:
                return client.start_analyzing(req)
            except Exception as e:  # noqa: BLE001 - parity: any failure retried once
                log.warning("StartAnalyzing attempt %d failed: %s", attempt, e)
        return None

    # ------------------------------------------------------------------
    # pod / ReplicaSet discovery
    # ------------------------------------------------------------------

    def get_pod_names(self, dep: dict) -> tuple[list[str], list[str]]:
        """(current_pods, baseline_pods) via ReplicaSet ownership.

        The reference walks ReplicaSets owned by the old/new Deployment
        with replicas>0, disambiguating via DeploymentCondition messages
        and sleeping between retries (Barrelman.go:632-780). Equivalent
        rule here: among live owned ReplicaSets, the highest
        ``deployment.kubernetes.io/revision`` is current, the rest are
        baseline.
        """
        meta = dep.get("metadata", {})
        namespace = meta.get("namespace", "")
        dep_uid = meta.get("uid", "")
        for attempt in range(POD_RETRY_COUNT):
            live = [
                rs
                for rs in self.kube.list_replicasets(namespace)
                if dep_uid in owner_uids(rs)
                and (rs.get("status", {}).get("replicas") or rs.get("spec", {}).get("replicas") or 0) > 0
            ]
            if live:
                live.sort(key=deployment_revision)
                new_rs, old_rs = live[-1], live[:-1]
                pods = self.kube.list_pods(namespace)
                current = self._pods_of(pods, new_rs["metadata"].get("uid", ""))
                baseline = [
                    p
                    for rs in old_rs
                    for p in self._pods_of(pods, rs["metadata"].get("uid", ""))
                ]
                if current:
                    return current, baseline
            if attempt < POD_RETRY_COUNT - 1:
                self.sleep(POD_RETRY_SLEEP)
        return [], []

    @staticmethod
    def _pods_of(pods: list[dict], rs_uid: str) -> list[str]:
        return [
            p["metadata"]["name"]
            for p in pods
            if rs_uid in owner_uids(p)
        ]

    # ------------------------------------------------------------------
    # monitor CR helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _monitor_name(dep_name: str) -> str:
        """Monitor CR is named after the primary Deployment: canary
        deployments map onto the primary's monitor (Barrelman.go:326-328)."""
        return dep_name.removesuffix(CANARY_SUFFIX)

    def _get_or_new_monitor(self, namespace: str, dep_name: str, app: str) -> DeploymentMonitor:
        name = self._monitor_name(dep_name)
        try:
            return self.kube.get_monitor(namespace, name)
        except NotFound:
            return DeploymentMonitor(
                name=name,
                namespace=namespace,
                selector={"app": app},
                remediation=Remediation(),
            )

    def _ensure_monitor(self, dep: dict) -> None:
        meta = dep.get("metadata", {})
        namespace, name = meta.get("namespace", ""), meta.get("name", "")
        app = (meta.get("labels", {}) or {}).get("app", name)
        try:
            self.kube.get_monitor(namespace, self._monitor_name(name))
        except NotFound:
            self.kube.upsert_monitor(
                DeploymentMonitor(
                    name=self._monitor_name(name),
                    namespace=namespace,
                    selector={"app": app},
                )
            )
