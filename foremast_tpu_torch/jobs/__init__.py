"""Job plane: wire models, idempotent ids, the in-memory store, the chunk
pipeline and the brain worker.

The worker (and with it torch) is imported on first use of `BrainWorker`
or `infer_metric_type`, so the gateway and the watch plane, which use
only the wire models, the converter and the store, start without torch."""

from foremast_tpu_torch.jobs.models import (
    CLAIMABLE_STATUSES,
    STATUS_ABORT,
    STATUS_COMPLETED_HEALTH,
    STATUS_COMPLETED_UNHEALTH,
    STATUS_COMPLETED_UNKNOWN,
    STATUS_INITIAL,
    STATUS_POSTPROCESS_INPROGRESS,
    STATUS_PREPROCESS_COMPLETED,
    STATUS_PREPROCESS_FAILED,
    STATUS_PREPROCESS_INPROGRESS,
    TERMINAL_STATUSES,
    AnalyzeRequest,
    AnomalyInfo,
    Document,
    MetricQuery,
    MetricsInfo,
    document_response,
    job_id,
    status_to_external,
)
from foremast_tpu_torch.jobs.store import InMemoryStore, JobStore, now_rfc3339, parse_time

__all__ = [
    "CLAIMABLE_STATUSES",
    "STATUS_ABORT",
    "STATUS_COMPLETED_HEALTH",
    "STATUS_COMPLETED_UNHEALTH",
    "STATUS_COMPLETED_UNKNOWN",
    "STATUS_INITIAL",
    "STATUS_POSTPROCESS_INPROGRESS",
    "STATUS_PREPROCESS_COMPLETED",
    "STATUS_PREPROCESS_FAILED",
    "STATUS_PREPROCESS_INPROGRESS",
    "TERMINAL_STATUSES",
    "AnalyzeRequest",
    "AnomalyInfo",
    "Document",
    "MetricQuery",
    "MetricsInfo",
    "document_response",
    "job_id",
    "status_to_external",
    "InMemoryStore",
    "JobStore",
    "now_rfc3339",
    "parse_time",
    "BrainWorker",
    "infer_metric_type",
]


def __getattr__(name: str):
    if name in ("BrainWorker", "infer_metric_type"):
        from foremast_tpu_torch.jobs import worker

        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
