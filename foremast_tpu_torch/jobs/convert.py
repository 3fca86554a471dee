"""Request -> ES document conversion (service RegisterEntry logic).

The port's copy of the JAX package's `foremast_tpu/jobs/convert.py`:
validate appName and non-empty `metrics.current`, flatten each window's
alias->MetricQuery map into the config string + parallel metric-source
string, derive the idempotent job id, and fill the Document
(`foremast-service/cmd/manager/main.go:33-168`).
"""

from __future__ import annotations

from foremast_tpu_torch.jobs.models import AnalyzeRequest, Document, job_id
from foremast_tpu_torch.metrics.promql import encode_config


class InvalidRequest(ValueError):
    pass


def request_to_document(req: AnalyzeRequest) -> Document:
    if not req.app_name:
        raise InvalidRequest("appName is required")
    if not req.metrics.current:
        raise InvalidRequest("metrics.current must not be empty")
    cur_cfg, cur_src = encode_config(req.metrics.current)
    base_cfg, base_src = encode_config(req.metrics.baseline)
    hist_cfg, hist_src = encode_config(req.metrics.historical)
    jid = job_id(
        req.app_name,
        req.start_time,
        req.end_time,
        (cur_cfg, base_cfg, hist_cfg),
        (cur_src, base_src, hist_src),
        req.strategy,
    )
    return Document(
        id=jid,
        app_name=req.app_name,
        start_time=req.start_time,
        end_time=req.end_time,
        current_config=cur_cfg,
        baseline_config=base_cfg,
        historical_config=hist_cfg,
        current_metric_store=cur_src,
        baseline_metric_store=base_src,
        historical_metric_store=hist_src,
        strategy=req.strategy,
    )
