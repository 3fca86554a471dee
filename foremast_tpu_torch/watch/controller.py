"""Status poller + remediation — the MonitorController equivalent.

Parity with `foremast-barrelman/pkg/controller/`:

* 10-second poll tick (Barrelman.go:467-472): for every Running monitor,
  GET job status from the analyst, map to a phase, decode the anomaly
  payload, expire jobs past waitUntil as Healthy+expired
  (checkRunningStatus, Barrelman.go:496-591).
* anomaly decoding: flat [t1,v1,t2,v2,...] pairs -> typed
  [{"time": t, "value": v}] lists (convertToAnomaly, Barrelman.go:593-620).
* remediation on transition to Unhealthy with remediationTaken==false,
  dispatched by spec.remediation.option (MonitorController.go:85-148):
  AutoRollback -> roll the Deployment's pod template back to the
  rollbackRevision ReplicaSet (the reference used the long-removed
  extensions/v1beta1 DeploymentRollback, MonitorController.go:214-229;
  the template-patch below is the apps/v1 equivalent); AutoPause -> set
  spec.paused (MonitorController.go:254-281); Auto -> no-op
  (MonitorController.go:283-286).
* continuous re-arm each tick while phase != Running, with a 60 s backoff
  after Unhealthy (Barrelman.go:576-586, MonitorController.go:138-147).
"""

from __future__ import annotations

import logging
import time as _time
from typing import Callable

from foremast_tpu_torch.jobs.store import now_rfc3339, parse_time
from foremast_tpu_torch.observe.logs import ctx_log
from foremast_tpu_torch.observe.spans import counter, span
from foremast_tpu_torch.watch.analyst import AnalystClient, HttpAnalyst
from foremast_tpu_torch.watch.barrelman import Barrelman
from foremast_tpu_torch.watch.crds import (
    ROLLBACK_ANNOTATION,
    DeploymentMonitor,
    MonitorPhase,
    RemediationOption,
)
from foremast_tpu_torch.watch.kubeapi import (
    KubeClient,
    NotFound,
    deployment_revision,
    owner_uids,
    record_event,
)

log = logging.getLogger("foremast_tpu_torch.watch")

POLL_PERIOD_SECONDS = 10.0  # Barrelman.go:467
UNHEALTHY_REARM_BACKOFF = 60.0  # MonitorController.go:138-147


def convert_to_anomaly(payload: dict) -> dict:
    """Flat-pair wire form -> typed form (Barrelman.go:593-620).

    In:  {"tags": t, "values": {alias: [t1, v1, t2, v2, ...]}}
         (AnomalyInfo, models.go:60-80)
    Out: {alias: {"tags": t, "values": [{"time": t1, "value": v1}, ...]}}
    """
    out: dict = {}
    tags = (payload or {}).get("tags", "")
    for alias, flat in ((payload or {}).get("values") or {}).items():
        flat = flat or []
        pairs = [
            {"time": flat[i], "value": flat[i + 1]}
            for i in range(0, len(flat) - 1, 2)
        ]
        out[alias] = {"tags": tags, "values": pairs}
    return out




class MonitorController:
    def __init__(
        self,
        kube: KubeClient,
        barrelman: Barrelman | None = None,
        analyst_factory: Callable[[str], AnalystClient] | None = None,
        clock: Callable[[], float] = _time.time,
        tracer=None,
        registry=None,
    ) -> None:
        self.kube = kube
        self.barrelman = barrelman
        self.analyst_factory = analyst_factory or (
            barrelman.analyst_factory if barrelman else HttpAnalyst
        )
        self.clock = clock
        self._unhealthy_since: dict[tuple[str, str], float] = {}
        # span tracer (observe/spans.py): each monitor poll opens a root
        # span; transition/rollback/pause spans nest under it so a
        # remediation's latency is attributable on the same timeline as
        # the worker's judgment stages
        self.tracer = tracer
        self.transitions = counter(
            "foremast_controller_transitions_total",
            "DeploymentMonitor phase transitions observed by the poller",
            ("phase",),
            registry,
        )

    # ------------------------------------------------------------------
    # poll tick (checkRunningStatus)
    # ------------------------------------------------------------------

    def tick(self) -> None:
        for monitor in self.kube.list_monitors():
            try:
                self._check_monitor(monitor)
            except Exception:  # noqa: BLE001 - one bad monitor must not stop the tick
                log.exception(
                    "poll failed for %s/%s", monitor.namespace, monitor.name
                )

    def _check_monitor(self, monitor: DeploymentMonitor) -> None:
        phase = monitor.status.phase
        if phase == MonitorPhase.RUNNING and monitor.status.job_id:
            self._poll_running(monitor)
        elif monitor.continuous:
            self._rearm_continuous(monitor)

    def _poll_running(self, monitor: DeploymentMonitor) -> None:
        if self.tracer is None:
            return self._poll_running_inner(monitor)
        with self.tracer.span(
            "controller.poll",
            stage="poll",
            namespace=monitor.namespace,
            monitor=monitor.name,
            job_id=monitor.status.job_id,
        ):
            return self._poll_running_inner(monitor)

    def _poll_running_inner(self, monitor: DeploymentMonitor) -> None:
        now = self.clock()
        wait_until = parse_time(monitor.wait_until)
        try:
            with span(
                "controller.get_status",
                stage="get_status",
                job_id=monitor.status.job_id,
            ):
                status = self.analyst_factory(
                    monitor.analyst_endpoint
                ).get_status(monitor.status.job_id)
            new_phase = status.phase
        except Exception as e:  # noqa: BLE001 - analyst down must not stall expiry
            log.warning(
                "get_status failed for %s/%s: %s", monitor.namespace, monitor.name, e
            )
            status, new_phase = None, MonitorPhase.RUNNING
        if new_phase == MonitorPhase.RUNNING:
            if wait_until and now > wait_until:
                # expiry defaults the job to Healthy (Barrelman.go:556-565)
                monitor.status.phase = MonitorPhase.HEALTHY
                monitor.status.expired = True
                monitor.status.timestamp = now_rfc3339()
                self.transitions.labels(phase=MonitorPhase.HEALTHY).inc()
                self.kube.upsert_monitor(monitor)
            return
        old_phase = monitor.status.phase
        # "update", not "transition": this span times every poll's
        # status write-back + remediation dispatch, most of which merely
        # re-assert the current phase
        with span(
            "controller.update",
            stage="update",
            phase=new_phase,
            changed=new_phase != old_phase,
            namespace=monitor.namespace,
            monitor=monitor.name,
        ):
            monitor.status.phase = new_phase
            monitor.status.timestamp = now_rfc3339()
            # count/log PHASE CHANGES only — every poll re-asserts the
            # current phase, and a rate() over re-assertions would just
            # measure poll frequency
            if new_phase != old_phase:
                self.transitions.labels(phase=new_phase).inc()
                ctx_log(
                    log,
                    logging.INFO,
                    "monitor transition",
                    namespace=monitor.namespace,
                    monitor=monitor.name,
                    phase=new_phase,
                    from_phase=old_phase,
                    job_id=monitor.status.job_id,
                )
            if status.anomaly:
                monitor.status.anomaly = convert_to_anomaly(status.anomaly)
            self.kube.upsert_monitor(monitor)
            self.handle_transition(monitor)

    # ------------------------------------------------------------------
    # remediation (MonitorController informer UpdateFunc)
    # ------------------------------------------------------------------

    def handle_transition(self, monitor: DeploymentMonitor) -> None:
        if monitor.status.phase != MonitorPhase.UNHEALTHY:
            return
        self._unhealthy_since[(monitor.namespace, monitor.name)] = self.clock()
        record_event(
            self.kube,
            monitor.namespace,
            monitor.name,
            reason="Unhealthy",
            message=f"health analysis job {monitor.status.job_id} detected anomalies",
            event_type="Warning",
        )
        if monitor.status.remediation_taken:
            return
        option = monitor.remediation.option
        if option == RemediationOption.AUTO_ROLLBACK:
            self.rollback(monitor)
        elif option == RemediationOption.AUTO_PAUSE:
            self.pause(monitor)
        elif option == RemediationOption.AUTO:
            pass  # reference leaves Auto unimplemented (MonitorController.go:283-286)
        else:
            return
        if option in (RemediationOption.AUTO_ROLLBACK, RemediationOption.AUTO_PAUSE):
            monitor.status.remediation_taken = True
            self.kube.upsert_monitor(monitor)

    def rollback(self, monitor: DeploymentMonitor) -> None:
        """Roll the Deployment back to spec.rollbackRevision by patching
        its pod template from that revision's ReplicaSet
        (MonitorController.go:172-238, apps/v1 form)."""
        with span(
            "controller.rollback",
            stage="rollback",
            namespace=monitor.namespace,
            monitor=monitor.name,
        ):
            self._rollback_inner(monitor)

    def _rollback_inner(self, monitor: DeploymentMonitor) -> None:
        try:
            dep = self.kube.get_deployment(monitor.namespace, monitor.name)
        except NotFound:
            log.warning("rollback target %s/%s gone", monitor.namespace, monitor.name)
            return
        target = monitor.rollback_revision
        dep_uid = dep.get("metadata", {}).get("uid", "")
        candidates = [
            rs
            for rs in self.kube.list_replicasets(monitor.namespace)
            if dep_uid in owner_uids(rs)
            and (target == 0 or deployment_revision(rs) == target)
            and deployment_revision(rs) != deployment_revision(dep)
        ]
        if not candidates:
            log.warning(
                "no ReplicaSet at revision %s for %s/%s; rollback skipped",
                target, monitor.namespace, monitor.name,
            )
            return
        candidates.sort(key=deployment_revision)
        rs = candidates[-1]
        template = rs.get("spec", {}).get("template", {})
        # drop the RS-only pod-template-hash label before reuse
        labels = dict(template.get("metadata", {}).get("labels", {}) or {})
        labels.pop("pod-template-hash", None)
        patch = {
            "metadata": {"annotations": {ROLLBACK_ANNOTATION: str(target or deployment_revision(rs))}},
            "spec": {
                "template": {
                    "metadata": {**template.get("metadata", {}), "labels": labels},
                    "spec": template.get("spec", {}),
                }
            },
        }
        self.kube.patch_deployment(monitor.namespace, monitor.name, patch)
        record_event(
            self.kube,
            monitor.namespace,
            monitor.name,
            reason="AutoRollback",
            message=f"rolled back to revision {deployment_revision(rs)} "
            "after unhealthy analysis",
        )
        log.info(
            "rolled back %s/%s to revision %s",
            monitor.namespace, monitor.name, deployment_revision(rs),
        )

    def pause(self, monitor: DeploymentMonitor) -> None:
        """Set spec.paused=true (MonitorController.go:254-281)."""
        with span(
            "controller.pause",
            stage="pause",
            namespace=monitor.namespace,
            monitor=monitor.name,
        ):
            try:
                self.kube.patch_deployment(
                    monitor.namespace, monitor.name, {"spec": {"paused": True}}
                )
                record_event(
                    self.kube,
                    monitor.namespace,
                    monitor.name,
                    reason="AutoPause",
                    message="paused rollout after unhealthy analysis",
                )
            except NotFound:
                log.warning(
                    "pause target %s/%s gone", monitor.namespace, monitor.name
                )

    # ------------------------------------------------------------------
    # continuous re-arm
    # ------------------------------------------------------------------

    def _rearm_continuous(self, monitor: DeploymentMonitor) -> None:
        if self.barrelman is None:
            return
        key = (monitor.namespace, monitor.name)
        since = self._unhealthy_since.get(key)
        if since is not None and self.clock() - since < UNHEALTHY_REARM_BACKOFF:
            return
        self._unhealthy_since.pop(key, None)
        self.barrelman.monitor_continuously(monitor)

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------

    def run_forever(self, stop: Callable[[], bool] = lambda: False) -> None:
        while not stop():
            self.tick()
            _time.sleep(POLL_PERIOD_SECONDS)
