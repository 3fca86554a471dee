"""Wire + storage models, byte-compatible with the reference service.

Mirrors `foremast-service/pkg/models/models.go:6-146` (request/response and
ES document structs) and `pkg/converter/converter.go:11-30` (the brain's
internal status machine and its external translation). These contracts are
preserved exactly so reference clients (barrelman) interoperate
(SURVEY.md section 5, "contracts worth preserving byte-for-byte").
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import Any, Mapping

# ---------------------------------------------------------------------------
# Status state machine (converter.go:13-26; design.md:47-51)
# ---------------------------------------------------------------------------

STATUS_INITIAL = "initial"
STATUS_PREPROCESS_INPROGRESS = "preprocess_inprogress"
STATUS_PREPROCESS_COMPLETED = "preprocess_completed"
STATUS_PREPROCESS_FAILED = "preprocess_failed"
STATUS_POSTPROCESS_INPROGRESS = "postprocess_inprogress"
STATUS_COMPLETED_HEALTH = "completed_health"
STATUS_COMPLETED_UNHEALTH = "completed_unhealth"
STATUS_COMPLETED_UNKNOWN = "completed_unknown"
STATUS_ABORT = "abort"

TERMINAL_STATUSES = frozenset(
    {
        STATUS_COMPLETED_HEALTH,
        STATUS_COMPLETED_UNHEALTH,
        STATUS_COMPLETED_UNKNOWN,
        STATUS_PREPROCESS_FAILED,
        STATUS_ABORT,
    }
)

# in-progress statuses: claimable only via stuck-job takeover
# (modified_at older than MAX_STUCK_IN_SECONDS, design.md:39)
INPROGRESS_STATUSES = (
    STATUS_PREPROCESS_INPROGRESS,
    STATUS_POSTPROCESS_INPROGRESS,
)

# one source of truth with the store's server-side claimability query:
# fresh work + the in-progress family (the latter claimable only when stuck)
CLAIMABLE_STATUSES = (
    STATUS_INITIAL,
    STATUS_PREPROCESS_COMPLETED,
    *INPROGRESS_STATUSES,
)

# External view (converter.go:11-30): internal -> {new, inprogress,
# success, anomaly, abort}.
_EXTERNAL = {
    STATUS_INITIAL: "new",
    STATUS_PREPROCESS_INPROGRESS: "inprogress",
    STATUS_POSTPROCESS_INPROGRESS: "inprogress",
    STATUS_PREPROCESS_COMPLETED: "inprogress",
    STATUS_COMPLETED_HEALTH: "success",
    STATUS_COMPLETED_UNHEALTH: "anomaly",
    STATUS_COMPLETED_UNKNOWN: "abort",
    STATUS_PREPROCESS_FAILED: "abort",
}


def status_to_external(status: str) -> str:
    """converter.ConvertStatusToExternal parity; unknown statuses pass
    through unchanged (the Go switch's default branch)."""
    return _EXTERNAL.get(status, status)


# ---------------------------------------------------------------------------
# Request / response wire structs (models.go:35-80)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MetricQuery:
    """{dataSourceType, parameters} — models.go:6-17."""

    data_source_type: str
    parameters: dict[str, Any]

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "MetricQuery":
        return MetricQuery(
            data_source_type=d.get("dataSourceType", "prometheus"),
            parameters=dict(d.get("parameters", {})),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "dataSourceType": self.data_source_type,
            "parameters": self.parameters,
        }


@dataclasses.dataclass
class MetricsInfo:
    """{current, baseline, historical}: alias -> MetricQuery maps."""

    current: dict[str, MetricQuery] = dataclasses.field(default_factory=dict)
    baseline: dict[str, MetricQuery] = dataclasses.field(default_factory=dict)
    historical: dict[str, MetricQuery] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "MetricsInfo":
        def conv(m):
            return {k: MetricQuery.from_json(v) for k, v in (m or {}).items()}

        return MetricsInfo(
            current=conv(d.get("current")),
            baseline=conv(d.get("baseline")),
            historical=conv(d.get("historical")),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "current": {k: v.to_json() for k, v in self.current.items()},
            "baseline": {k: v.to_json() for k, v in self.baseline.items()},
            "historical": {k: v.to_json() for k, v in self.historical.items()},
        }


@dataclasses.dataclass
class AnalyzeRequest:
    """ApplicationHealthAnalyzeRequest — models.go:35-49."""

    app_name: str
    start_time: str
    end_time: str
    metrics: MetricsInfo
    strategy: str  # rollingUpdate | canary | continuous (metricsquery.go:16-19)
    namespace: str = ""
    pods: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "AnalyzeRequest":
        return AnalyzeRequest(
            app_name=d.get("appName", ""),
            start_time=d.get("startTime", ""),
            end_time=d.get("endTime", ""),
            metrics=MetricsInfo.from_json(d.get("metrics", {})),
            strategy=d.get("strategy", ""),
            namespace=d.get("namespace", ""),
            pods=list(d.get("podCountURL", []) or []),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "appName": self.app_name,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "metrics": self.metrics.to_json(),
            "strategy": self.strategy,
        }


@dataclasses.dataclass
class AnomalyInfo:
    """{tags, values} with values the flat [t1,v1,t2,v2,...] pairs decoded
    by barrelman's convertToAnomaly (Barrelman.go:593-620)."""

    tags: str = ""
    values: dict[str, list[float]] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {"tags": self.tags, "values": self.values}


# ---------------------------------------------------------------------------
# ES document (models.go:96-146)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Document:
    id: str
    app_name: str
    created_at: str = ""
    modified_at: str = ""
    start_time: str = ""
    end_time: str = ""
    current_config: str = ""
    baseline_config: str = ""
    historical_config: str = ""
    current_metric_store: str = ""
    baseline_metric_store: str = ""
    historical_metric_store: str = ""
    status: str = STATUS_INITIAL
    status_code: str = "201"
    strategy: str = ""
    reason: str = ""
    processing_content: str = ""
    anomaly_info: dict[str, Any] | None = None
    # correlation ID minted by the service at create time (observe/spans):
    # carried through the store so worker/controller logs and traces can
    # join back to the originating request. Additive — serialized only
    # when set, so reference clients see an unchanged document shape.
    trace_id: str = ""

    def to_json(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "appName": self.app_name,
            "createdAt": self.created_at,
            "modifiedAt": self.modified_at,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "currentConfig": self.current_config,
            "baselineConfig": self.baseline_config,
            "historicalConfig": self.historical_config,
            "currentMetricStore": self.current_metric_store,
            "baselineMetricStore": self.baseline_metric_store,
            "historicalMetricStore": self.historical_metric_store,
            "status": self.status,
            "statusCode": self.status_code,
            "strategy": self.strategy,
            "reason": self.reason,
            "processingContent": self.processing_content,
            **({"traceId": self.trace_id} if self.trace_id else {}),
            **({"anomalyInfo": self.anomaly_info} if self.anomaly_info else {}),
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Document":
        return Document(
            id=d.get("id", ""),
            app_name=d.get("appName", ""),
            created_at=d.get("createdAt", ""),
            modified_at=d.get("modifiedAt", ""),
            start_time=d.get("startTime", ""),
            end_time=d.get("endTime", ""),
            current_config=d.get("currentConfig", ""),
            baseline_config=d.get("baselineConfig", ""),
            historical_config=d.get("historicalConfig", ""),
            current_metric_store=d.get("currentMetricStore", ""),
            baseline_metric_store=d.get("baselineMetricStore", ""),
            historical_metric_store=d.get("historicalMetricStore", ""),
            status=d.get("status", STATUS_INITIAL),
            status_code=str(d.get("statusCode", "201")),
            strategy=d.get("strategy", ""),
            reason=d.get("reason", ""),
            processing_content=d.get("processingContent", ""),
            anomaly_info=d.get("anomalyInfo"),
            trace_id=d.get("traceId", ""),
        )


def document_response(doc: Document) -> dict[str, Any]:
    """GET /v1/healthcheck/id/:id body: external status view + anomaly
    (converter.ConvertESToResp, converter.go:33-73)."""
    return {
        "jobId": doc.id,
        "appName": doc.app_name,
        "status": status_to_external(doc.status),
        "statusCode": doc.status_code,
        "reason": doc.reason,
        **({"anomalyInfo": doc.anomaly_info} if doc.anomaly_info else {}),
    }


# ---------------------------------------------------------------------------
# Idempotent job ids (common/stringutils.go:11-18; elasticsearchstore.go:29)
# ---------------------------------------------------------------------------


def job_id(
    app_name: str,
    start_time: str,
    end_time: str,
    configs: tuple[str, str, str],
    sources: tuple[str, str, str],
    strategy: str,
) -> str:
    """hex(HMAC-SHA256(key="", msg=appName+times+configs+sources+strategy)).

    Identical requests hash to the same id, making job creation idempotent
    and retries safe (reference UUIDGen + CreateNewDoc search-first).
    """
    msg = "".join((app_name, start_time, end_time, *configs, *sources, strategy))
    return hmac.new(b"", msg.encode("utf-8"), hashlib.sha256).hexdigest()
