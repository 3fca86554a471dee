"""Job plane: wire models, idempotent ids, the in-memory store, the chunk
pipeline and the brain worker."""

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
from foremast_tpu_torch.jobs.worker import BrainWorker, infer_metric_type

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
