"""Watcher / remediation control plane — the foremast-barrelman equivalent.

The port's copy of the JAX package's `foremast_tpu/watch/`. The reference
implements this layer as a Go Kubernetes controller
(`foremast-barrelman/`, SURVEY.md section 2.1). Here it is a
single-threaded control loop over a pluggable kube API, so the same logic
runs against a real cluster (HttpKube) or an in-memory fake
(InMemoryKube) in tests. The scoring engine on the card is reached only
through the analyst REST contract, so this plane stays a thin
pure-control layer.
"""

from foremast_tpu_torch.watch.crds import (
    DeploymentMetadata,
    DeploymentMonitor,
    MonitorPhase,
    MonitorStatus,
    RemediationOption,
)
from foremast_tpu_torch.watch.kubeapi import InMemoryKube, KubeClient
from foremast_tpu_torch.watch.analyst import AnalystClient
from foremast_tpu_torch.watch.barrelman import Barrelman
from foremast_tpu_torch.watch.controller import MonitorController

__all__ = [
    "AnalystClient",
    "Barrelman",
    "DeploymentMetadata",
    "DeploymentMonitor",
    "InMemoryKube",
    "KubeClient",
    "MonitorController",
    "MonitorPhase",
    "MonitorStatus",
    "RemediationOption",
]
