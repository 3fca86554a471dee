"""Custom-resource types for the watch plane.

Parity with the reference CRD Go types
(`foremast-barrelman/pkg/apis/deployment/v1alpha1/types.go`):

* ``DeploymentMetadata`` (types.go:14-156) — per-app / per-app-type config:
  analyst endpoint, metric source + endpoint + the list of monitored
  metrics ({metricName, metricType, metricAlias}), log config, descriptor.
* ``DeploymentMonitor`` (types.go:175-295) — per-deployment runtime state:
  spec {selector, analyst, startTime, waitUntil, metrics, continuous,
  remediation{option, parameters}, rollbackRevision} and status {jobId,
  phase, remediationTaken, anomaly, timestamp, expired}.
* Phases Healthy/Running/Failed/Unhealthy/Warning/Expired/Abort
  (types.go:241-255); remediation options None/AutoRollback/AutoPause/Auto
  (types.go:258-269).

Both types round-trip to the K8s CR wire form (apiVersion
``deployment.foremast.ai/v1alpha1``) so HttpKube can CRUD them against a
real API server and manifests stay compatible with reference CRs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

GROUP = "deployment.foremast.ai"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"

CANARY_SUFFIX = "-foremast-canary"  # Barrelman.go:62
MONITOR_OPT_OUT_ANNOTATION = "foremast.ai/monitoring"  # Barrelman.go:93-101
ROLLBACK_ANNOTATION = "deprecated.deployment.rollback.to"  # Barrelman.go:245-253


class MonitorPhase:
    """DeploymentMonitor.status.phase enum (types.go:241-255)."""

    HEALTHY = "Healthy"
    RUNNING = "Running"
    FAILED = "Failed"
    UNHEALTHY = "Unhealthy"
    WARNING = "Warning"
    EXPIRED = "Expired"
    ABORT = "Abort"


class RemediationOption:
    """spec.remediation.option enum (types.go:258-269)."""

    NONE = "None"
    AUTO_ROLLBACK = "AutoRollback"
    AUTO_PAUSE = "AutoPause"
    AUTO = "Auto"


@dataclasses.dataclass
class MonitoredMetric:
    """One entry of DeploymentMetadata.spec.metrics.monitoring
    (types.go:74-90): the metric to watch plus its brain-side type (keys
    the per-type threshold table) and its alias in the job payload."""

    metric_name: str
    metric_type: str = ""
    metric_alias: str = ""

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "MonitoredMetric":
        return MonitoredMetric(
            metric_name=d.get("metricName", ""),
            metric_type=d.get("metricType", ""),
            metric_alias=d.get("metricAlias", "") or d.get("metricName", ""),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "metricName": self.metric_name,
            "metricType": self.metric_type,
            "metricAlias": self.metric_alias or self.metric_name,
        }


@dataclasses.dataclass
class DeploymentMetadata:
    """Per-app configuration CR (types.go:14-156)."""

    name: str
    namespace: str
    analyst_endpoint: str = ""
    metrics_source: str = "prometheus"  # only supported source, metricsquery.go:96
    metrics_endpoint: str = ""
    monitoring: list[MonitoredMetric] = dataclasses.field(default_factory=list)
    logs: dict[str, Any] = dataclasses.field(default_factory=dict)
    descriptor: dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "DeploymentMetadata":
        meta = obj.get("metadata", {})
        spec = obj.get("spec", {})
        metrics = spec.get("metrics", {})
        return DeploymentMetadata(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            analyst_endpoint=(spec.get("analyst") or {}).get("endpoint", ""),
            metrics_source=metrics.get("source", "prometheus"),
            metrics_endpoint=metrics.get("endpoint", ""),
            monitoring=[
                MonitoredMetric.from_json(m) for m in metrics.get("monitoring", []) or []
            ],
            logs=dict(spec.get("logs", {}) or {}),
            descriptor=dict(spec.get("descriptor", {}) or {}),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": "DeploymentMetadata",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "analyst": {"endpoint": self.analyst_endpoint},
                "metrics": {
                    "source": self.metrics_source,
                    "endpoint": self.metrics_endpoint,
                    "monitoring": [m.to_json() for m in self.monitoring],
                },
                "logs": self.logs,
                "descriptor": self.descriptor,
            },
        }

    def metric_names(self) -> dict[str, str]:
        """alias -> metricName map, as `create_metrics_info` takes it."""
        return {(m.metric_alias or m.metric_name): m.metric_name for m in self.monitoring}


@dataclasses.dataclass
class Remediation:
    option: str = RemediationOption.NONE
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MonitorStatus:
    """DeploymentMonitor.status (types.go:223-240)."""

    job_id: str = ""
    phase: str = ""
    remediation_taken: bool = False
    # alias -> {"tags": str, "values": [{"time": t, "value": v}, ...]} —
    # the typed form barrelman decodes from the flat pairs
    # (Barrelman.go:593-620).
    anomaly: dict[str, Any] = dataclasses.field(default_factory=dict)
    timestamp: str = ""
    expired: bool = False

    def to_json(self) -> dict[str, Any]:
        return {
            "jobId": self.job_id,
            "phase": self.phase,
            "remediationTaken": self.remediation_taken,
            "anomaly": self.anomaly,
            "timestamp": self.timestamp,
            "expired": self.expired,
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "MonitorStatus":
        return MonitorStatus(
            job_id=d.get("jobId", ""),
            phase=d.get("phase", ""),
            remediation_taken=bool(d.get("remediationTaken", False)),
            anomaly=dict(d.get("anomaly", {}) or {}),
            timestamp=d.get("timestamp", ""),
            expired=bool(d.get("expired", False)),
        )


@dataclasses.dataclass
class DeploymentMonitor:
    """Per-deployment monitoring CR (types.go:175-295)."""

    name: str
    namespace: str
    selector: dict[str, str] = dataclasses.field(default_factory=dict)
    analyst_endpoint: str = ""
    start_time: str = ""
    wait_until: str = ""
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    continuous: bool = False
    remediation: Remediation = dataclasses.field(default_factory=Remediation)
    rollback_revision: int = 0
    status: MonitorStatus = dataclasses.field(default_factory=MonitorStatus)

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "DeploymentMonitor":
        meta = obj.get("metadata", {})
        spec = obj.get("spec", {})
        rem = spec.get("remediation", {}) or {}
        return DeploymentMonitor(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            selector=dict(spec.get("selector", {}) or {}),
            analyst_endpoint=(spec.get("analyst") or {}).get("endpoint", ""),
            start_time=spec.get("startTime", ""),
            wait_until=spec.get("waitUntil", ""),
            metrics=dict(spec.get("metrics", {}) or {}),
            continuous=bool(spec.get("continuous", False)),
            remediation=Remediation(
                option=rem.get("option", RemediationOption.NONE),
                parameters=dict(rem.get("parameters", {}) or {}),
            ),
            rollback_revision=int(spec.get("rollbackRevision", 0) or 0),
            status=MonitorStatus.from_json(obj.get("status", {}) or {}),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": "DeploymentMonitor",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "selector": self.selector,
                "analyst": {"endpoint": self.analyst_endpoint},
                "startTime": self.start_time,
                "waitUntil": self.wait_until,
                "metrics": self.metrics,
                "continuous": self.continuous,
                "remediation": {
                    "option": self.remediation.option,
                    "parameters": self.remediation.parameters,
                },
                "rollbackRevision": self.rollback_revision,
            },
            "status": self.status.to_json(),
        }
