"""Analyst client — watcher-side REST client for the job gateway.

Parity with `foremast-barrelman/pkg/client/analyst/analystclient.go`:
``start_analyzing`` POSTs an ApplicationHealthAnalyzeRequest to
``<endpoint>create`` (analystclient.go:84-144; the retry-once wrapper lives
at Barrelman.go:819-826 and here in ``Barrelman._start_job``), and
``get_status`` GETs ``id/<jobId>`` then maps the service's external
statuses onto monitor phases (analystclient.go:211-230).

Two implementations: HTTP against a running gateway, and ``LocalAnalyst``
directly over a JobStore — the in-process path used by tests and by
single-binary deployments where watcher + brain share a process.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request
from typing import Any, Protocol

from foremast_tpu_torch.jobs.convert import request_to_document
from foremast_tpu_torch.jobs.models import AnalyzeRequest, document_response, status_to_external
from foremast_tpu_torch.jobs.store import JobStore
from foremast_tpu_torch.watch.crds import MonitorPhase

# external service status -> DeploymentMonitor phase (analystclient.go:211-230)
_PHASE = {
    "new": MonitorPhase.RUNNING,
    "inprogress": MonitorPhase.RUNNING,
    "success": MonitorPhase.HEALTHY,
    "anomaly": MonitorPhase.UNHEALTHY,
    "abort": MonitorPhase.ABORT,
}


def status_to_phase(external_status: str) -> str:
    return _PHASE.get(external_status, MonitorPhase.FAILED)


@dataclasses.dataclass
class JobStatus:
    """GetStatus result: phase + reason + the anomaly payload in the flat
    [t1,v1,t2,v2,...] wire form (models.go:60-80)."""

    phase: str
    reason: str = ""
    anomaly: dict[str, Any] = dataclasses.field(default_factory=dict)


class AnalystClient(Protocol):
    def start_analyzing(self, req: AnalyzeRequest) -> str: ...
    def get_status(self, job_id: str) -> JobStatus: ...


class HttpAnalyst:
    """REST client against a foremast-service-compatible gateway."""

    def __init__(self, endpoint: str, timeout: float = 10.0) -> None:
        # endpoint as stored in DeploymentMetadata.spec.analyst.endpoint,
        # e.g. "http://foremast-api-service:8099/v1/healthcheck/"
        self.endpoint = endpoint if endpoint.endswith("/") else endpoint + "/"
        self.timeout = timeout

    def start_analyzing(self, req: AnalyzeRequest) -> str:
        body = json.dumps(req.to_json()).encode()
        r = urllib.request.Request(
            self.endpoint + "create",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(r, timeout=self.timeout) as resp:
            payload = json.loads(resp.read())
        job_id = payload.get("jobId", "")
        if not job_id:
            raise RuntimeError(f"analyst create returned no jobId: {payload}")
        return job_id

    def get_status(self, job_id: str) -> JobStatus:
        try:
            with urllib.request.urlopen(
                self.endpoint + "id/" + job_id, timeout=self.timeout
            ) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:  # contract parity with LocalAnalyst
                return JobStatus(phase=MonitorPhase.FAILED, reason="job not found")
            raise
        return JobStatus(
            phase=status_to_phase(payload.get("status", "")),
            reason=payload.get("reason", ""),
            anomaly=payload.get("anomalyInfo") or payload.get("anomaly") or {},
        )


class LocalAnalyst:
    """In-process analyst over a JobStore — no HTTP hop.

    Functionally identical to HttpAnalyst + the gateway's RegisterEntry /
    SearchByID handlers; used by tests and single-process deployments.
    """

    def __init__(self, store: JobStore) -> None:
        self.store = store

    def start_analyzing(self, req: AnalyzeRequest) -> str:
        doc, _created = self.store.create(request_to_document(req))
        return doc.id

    def get_status(self, job_id: str) -> JobStatus:
        doc = self.store.get(job_id)
        if doc is None:
            return JobStatus(phase=MonitorPhase.FAILED, reason="job not found")
        resp = document_response(doc)
        return JobStatus(
            phase=status_to_phase(status_to_external(doc.status)),
            reason=resp.get("reason", ""),
            anomaly=resp.get("anomalyInfo") or {},
        )
