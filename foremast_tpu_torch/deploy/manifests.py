"""Deploy manifests of the port, generated: the `deploy_torch/` tree as
code.

The port's own copy of `foremast_tpu/deploy/manifests.py`: the same tree
(numbered install-order dirs, CRD schemas, env matrix, ports, RBAC
verbs, the monitoring stack, the demo), derived from the port's own
`watch/crds.py`, `config.BrainConfig`, `metrics/rules.py` and
`ui/metrics.py`, so it cannot drift from what the port runs.
`python -m foremast_tpu_torch.deploy deploy_torch/` re-renders the
committed tree; a test asserts it is current and that each file renders
byte for byte as the JAX package's does for the same content.

It departs from the JAX tree only where the port does:
  * the image is `foremast/foremast-tpu-torch:0.1.0`, whose console
    script is `foremast-tpu-torch`, and the demo runs
    `python -m foremast_tpu_torch.demo`;
  * the engine requests one H100 (`nvidia.com/gpu: 1`, GKE node
    selector `cloud.google.com/gke-accelerator: nvidia-h100-80gb`)
    instead of a TPU host, and runs without `--sharded`: one card per
    worker pod, scaled out by replicas (the worker mesh), since the
    sharded tick on one card is slower than the plain one;
  * the README speaks of the card.
"""

from __future__ import annotations

from foremast_tpu_torch.config import _DEFAULT_RULES, BrainConfig, MetricTypeRule
from foremast_tpu_torch.metrics.rules import prometheus_rule_manifest
from foremast_tpu_torch.watch.crds import API_VERSION, GROUP, VERSION

NAMESPACE = "foremast"
IMAGE = "foremast/foremast-tpu-torch:0.1.0"
# the image's console script: the port's CLI (pyproject.toml)
COMMAND = "foremast-tpu-torch"

# ---------------------------------------------------------------------------
# CRDs — openAPIV3 schemas derived from the watch/crds.py dataclasses.
# ---------------------------------------------------------------------------

_STR = {"type": "string"}
_BOOL = {"type": "boolean"}
_INT = {"type": "integer"}
_OBJ = {"type": "object"}
_STR_MAP = {"type": "object", "additionalProperties": _STR}


def _crd(kind: str, plural: str, spec_schema: dict, status_schema: dict | None) -> dict:
    props = {"spec": spec_schema}
    if status_schema is not None:
        props["status"] = status_schema
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": kind.lower(),
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}} if status_schema else {},
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": props,
                        }
                    },
                }
            ],
        },
    }


def deployment_metadata_crd() -> dict:
    """DeploymentMetadata: per-app config CR (types.go:14-156 parity)."""
    spec = {
        "type": "object",
        "properties": {
            "analyst": {
                "type": "object",
                "properties": {"endpoint": _STR},
            },
            "metrics": {
                "type": "object",
                "properties": {
                    "source": _STR,
                    "endpoint": _STR,
                    "monitoring": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "properties": {
                                "metricName": _STR,
                                "metricType": _STR,
                                "metricAlias": _STR,
                            },
                            "required": ["metricName"],
                        },
                    },
                },
            },
            "logs": _OBJ,
            "descriptor": _OBJ,
        },
    }
    return _crd("DeploymentMetadata", "deploymentmetadatas", spec, None)


def deployment_monitor_crd() -> dict:
    """DeploymentMonitor: per-deployment runtime CR (types.go:175-295)."""
    spec = {
        "type": "object",
        "properties": {
            "selector": _STR_MAP,
            "analyst": {"type": "object", "properties": {"endpoint": _STR}},
            "startTime": _STR,
            "waitUntil": _STR,
            "metrics": _OBJ,
            "continuous": _BOOL,
            "remediation": {
                "type": "object",
                "properties": {
                    "option": {
                        "type": "string",
                        "enum": ["None", "AutoRollback", "AutoPause", "Auto"],
                    },
                    "parameters": _OBJ,
                },
            },
            "rollbackRevision": _INT,
        },
    }
    status = {
        "type": "object",
        "properties": {
            "jobId": _STR,
            "phase": {
                "type": "string",
                "enum": [
                    "",
                    "Healthy",
                    "Running",
                    "Failed",
                    "Unhealthy",
                    "Warning",
                    "Expired",
                    "Abort",
                ],
            },
            "remediationTaken": _BOOL,
            "anomaly": _OBJ,
            "timestamp": _STR,
            "expired": _BOOL,
        },
    }
    return _crd("DeploymentMonitor", "deploymentmonitors", spec, status)


# ---------------------------------------------------------------------------
# Namespace / RBAC / watch plane
# ---------------------------------------------------------------------------


def namespace() -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": NAMESPACE},
    }


def watch_rbac() -> list[dict]:
    """ClusterRole covering what the watch plane touches: Deployments
    (watch/diff/rollback/pause), ReplicaSets+Pods (pod discovery), Events,
    and both CRDs (reference RBAC: foremast-barrelman-rbac.yaml)."""
    name = "foremast-watch"
    return [
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": name, "namespace": NAMESPACE},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": name},
            "rules": [
                {
                    "apiGroups": ["apps", "extensions"],
                    "resources": [
                        "deployments",
                        "deployments/rollback",
                        "replicasets",
                    ],
                    "verbs": ["get", "list", "watch", "update", "patch", "create"],
                },
                {
                    "apiGroups": [""],
                    "resources": ["pods", "namespaces"],
                    "verbs": ["get", "list", "watch"],
                },
                {
                    "apiGroups": [""],
                    "resources": ["events"],
                    "verbs": ["create", "patch"],
                },
                {
                    "apiGroups": [GROUP],
                    "resources": ["deploymentmetadatas", "deploymentmonitors"],
                    "verbs": [
                        "get",
                        "list",
                        "watch",
                        "create",
                        "update",
                        "patch",
                        "delete",
                    ],
                },
                {
                    "apiGroups": [GROUP],
                    "resources": ["deploymentmonitors/status"],
                    "verbs": ["get", "update", "patch"],
                },
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": name},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": name,
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": name,
                    "namespace": NAMESPACE,
                }
            ],
        },
    ]


def _container(name: str, args: list[str], env: list[dict], ports: list[dict],
               cpu: str = "100m", memory: str = "128Mi",
               probe_path: str | None = None, probe_port: int | None = None) -> dict:
    c = {
        "name": name,
        "image": IMAGE,
        "imagePullPolicy": "IfNotPresent",
        "command": [COMMAND],
        "args": args,
        "env": env,
        "ports": ports,
        "resources": {
            "requests": {"cpu": cpu, "memory": memory},
            "limits": {"cpu": cpu, "memory": memory},
        },
    }
    if probe_path and probe_port:
        probe = {
            "httpGet": {"path": probe_path, "port": probe_port},
            "initialDelaySeconds": 5,
            "periodSeconds": 10,
        }
        c["readinessProbe"] = probe
        c["livenessProbe"] = {**probe, "initialDelaySeconds": 30}
    return c


def _deployment(name: str, container: dict, sa: str | None = None,
                replicas: int = 1, namespace: str | None = None,
                scrape: bool = True) -> dict:
    meta: dict = {"labels": {"app": name}}
    if scrape:
        meta["annotations"] = {"prometheus.io/scrape": "true"}
    spec: dict = {
        "replicas": replicas,
        "selector": {"matchLabels": {"app": name}},
        "template": {
            "metadata": meta,
            "spec": {"containers": [container]},
        },
    }
    if sa:
        spec["template"]["spec"]["serviceAccountName"] = sa
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": namespace or NAMESPACE,
            "labels": {"app": name},
        },
        "spec": spec,
    }


def watch_deployment() -> dict:
    """The watch-plane controller (`foremast watch-plane`): informer-style
    Deployment watcher + status poller + remediation (reference:
    foremast-barrelman.yaml, 100m/30Mi budget)."""
    env = [
        {
            "name": "NAMESPACE",
            "valueFrom": {"fieldRef": {"fieldPath": "metadata.namespace"}},
        },
        {
            "name": "ANALYST_ENDPOINT",
            "value": f"http://foremast-service.{NAMESPACE}.svc:8099/v1/healthcheck/",
        },
        {
            "name": "METRICS_ENDPOINT",
            "value": "http://prometheus-k8s.monitoring.svc:9090/",
        },
    ]
    c = _container("foremast-watch", ["watch-plane"], env, [], cpu="100m", memory="64Mi")
    return _deployment("foremast-watch", c, sa="foremast-watch")


def default_metadata_cr() -> dict:
    """Cluster default DeploymentMetadata (`deployment-metadata-default.yaml`
    role): the appType fallback record the watcher resolves when an app has
    no metadata of its own (Barrelman.go:139-174 semantics)."""
    monitored = [
        {
            "metricName": "namespace_app_per_pod:http_server_requests_latency",
            "metricType": "latency",
            "metricAlias": "latency",
        },
        {
            "metricName": "namespace_app_per_pod:http_server_requests_error_5xx",
            "metricType": "error5xx",
            "metricAlias": "error5xx",
        },
        {
            "metricName": "namespace_app_per_pod:http_server_requests_error_4xx",
            "metricType": "error4xx",
            "metricAlias": "error4xx",
        },
        {
            "metricName": "namespace_app_per_pod:http_server_requests_count",
            "metricType": "tps",
            "metricAlias": "tps",
        },
    ]
    return {
        "apiVersion": API_VERSION,
        "kind": "DeploymentMetadata",
        "metadata": {"name": "default", "namespace": NAMESPACE},
        "spec": {
            "analyst": {
                "endpoint": f"http://foremast-service.{NAMESPACE}.svc:8099/v1/healthcheck/"
            },
            "metrics": {
                "source": "prometheus",
                "endpoint": "http://prometheus-k8s.monitoring.svc:9090/",
                "monitoring": monitored,
            },
        },
    }


# ---------------------------------------------------------------------------
# Engine plane: ES, REST service, the scoring engine on the card
# ---------------------------------------------------------------------------


def elasticsearch() -> list[dict]:
    """Single-node ES for the durable job store (reference es.yaml role)."""
    name = "elasticsearch"
    return [
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": NAMESPACE},
            "spec": {
                "selector": {"app": name},
                "ports": [{"name": "http", "port": 9200, "targetPort": 9200}],
            },
        },
        {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": name, "namespace": NAMESPACE},
            "spec": {
                "serviceName": name,
                "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": {
                        "containers": [
                            {
                                "name": name,
                                "image": "docker.elastic.co/elasticsearch/elasticsearch-oss:6.8.23",
                                "env": [
                                    {"name": "discovery.type", "value": "single-node"},
                                    {"name": "ES_JAVA_OPTS", "value": "-Xms512m -Xmx512m"},
                                ],
                                "ports": [{"containerPort": 9200}],
                                "resources": {
                                    "requests": {"cpu": "500m", "memory": "1Gi"},
                                    "limits": {"cpu": "1", "memory": "1536Mi"},
                                },
                                "volumeMounts": [
                                    {"name": "data", "mountPath": "/usr/share/elasticsearch/data"}
                                ],
                            }
                        ],
                        "volumes": [{"name": "data", "emptyDir": {}}],
                    },
                },
            },
        },
    ]


def service_deployment() -> list[dict]:
    """REST job gateway on :8099 (`foremast serve`; reference
    foremast-service.yaml, routes main.go:262-276)."""
    env = [
        {"name": "ELASTIC_URL", "value": f"http://elasticsearch.{NAMESPACE}.svc:9200"},
        {
            "name": "QUERY_SERVICE_ENDPOINT",
            "value": "http://prometheus-k8s.monitoring.svc:9090/",
        },
    ]
    c = _container(
        "foremast-service",
        ["serve", "--port", "8099"],
        env,
        [{"containerPort": 8099, "name": "http"}],
        cpu="100m",
        memory="64Mi",
        probe_path="/healthz",
        probe_port=8099,
    )
    return [
        _deployment("foremast-service", c),
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "foremast-service", "namespace": NAMESPACE},
            "spec": {
                "selector": {"app": "foremast-service"},
                "ports": [{"name": "http", "port": 8099, "targetPort": 8099}],
            },
        },
    ]


def _rule_env(rules: tuple[MetricTypeRule, ...]) -> list[dict]:
    """The reference's indexed env-var family for the per-metric-type
    threshold matrix (`foremast-brain.yaml:32-73`)."""
    out: list[dict] = [
        {"name": "metric_type_threshold_count", "value": str(len(rules))}
    ]
    for i, r in enumerate(rules):
        out += [
            {"name": f"metric_type{i}", "value": r.metric_type},
            {"name": f"threshold{i}", "value": _num(r.threshold)},
            {"name": f"bound{i}", "value": str(r.bound)},
            {"name": f"min_lower_bound{i}", "value": _num(r.min_lower_bound)},
        ]
    return out


def _num(x: float) -> str:
    return str(int(x)) if float(x) == int(x) else str(x)


def engine_deployment(cfg: BrainConfig | None = None) -> list[dict]:
    """The scoring engine on the card (`foremast-tpu-torch worker`):
    reference foremast-brain.yaml role, but one batched judgment on one
    H100 per pod instead of N CPU slivers. Env matrix mirrors
    BrainConfig.from_env. Publishes foremastbrain:* gauges on :8000,
    scraped by a ServiceMonitor (foremast-brain.yaml:87-122)."""
    cfg = cfg or BrainConfig()
    name = "foremast-engine"
    env = [
        {"name": "ES_ENDPOINT", "value": f"http://elasticsearch.{NAMESPACE}.svc:9200"},
        {"name": "ML_ALGORITHM", "value": cfg.algorithm},
        {"name": "threshold", "value": _num(cfg.anomaly.threshold)},
        {"name": "min_lower_bound", "value": _num(cfg.anomaly.min_lower_bound)},
        {"name": "bound", "value": str(cfg.anomaly.bound)},
        *_rule_env(_DEFAULT_RULES),
        {"name": "MIN_MANN_WHITE_DATA_POINTS", "value": str(cfg.pairwise.min_mann_white_points)},
        {"name": "MIN_WILCOXON_DATA_POINTS", "value": str(cfg.pairwise.min_wilcoxon_points)},
        {"name": "MIN_KRUSKAL_DATA_POINTS", "value": str(cfg.pairwise.min_kruskal_points)},
        {"name": "ML_PAIRWISE_ALGORITHM", "value": cfg.pairwise.algorithm},
        {"name": "MAX_STUCK_IN_SECONDS", "value": _num(cfg.max_stuck_seconds)},
        {"name": "MAX_CACHE_SIZE", "value": str(cfg.max_cache_size)},
    ]
    c = _container(
        name,
        ["worker", "--gauge-port", "8000"],
        env,
        [{"containerPort": 8000, "name": "gauges"}],
        cpu="4",
        memory="8Gi",
        # the gauge exposition doubles as the health surface
        probe_path="/metrics",
        probe_port=8000,
    )
    # GPU scheduling: one card per worker pod; more cards mean more pods
    # (the worker mesh partitions the fleet), not a sharded judge
    c["resources"]["limits"]["nvidia.com/gpu"] = 1
    c["resources"]["requests"]["nvidia.com/gpu"] = 1
    dep = _deployment(name, c)
    dep["spec"]["template"]["spec"]["nodeSelector"] = {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
    }
    return [
        dep,
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name,
                "namespace": NAMESPACE,
                "labels": {"app": name},
            },
            "spec": {
                "selector": {"app": name},
                "ports": [{"name": "gauges", "port": 8000, "targetPort": 8000}],
            },
        },
        {
            "apiVersion": "monitoring.coreos.com/v1",
            "kind": "ServiceMonitor",
            "metadata": {
                "name": name,
                "namespace": NAMESPACE,
                "labels": {"app": name},
            },
            "spec": {
                "selector": {"matchLabels": {"app": name}},
                "endpoints": [{"port": "gauges", "interval": "15s"}],
                "namespaceSelector": {"matchNames": [NAMESPACE]},
            },
        },
    ]


def ui_deployment() -> list[dict]:
    """The dashboard (`foremast ui`) — reference foremast-browser role."""
    # NOTE: the endpoint is fetched by the *viewer's browser*, not the UI
    # pod, so it must be browser-reachable. Default matches the
    # export-service.sh port-forward; point it at your ingress in prod.
    env = [
        {
            "name": "FOREMAST_SERVICE_ENDPOINT",
            "value": "http://localhost:8099",
        }
    ]
    c = _container(
        "foremast-ui",
        ["ui", "--port", "8080"],
        env,
        [{"containerPort": 8080, "name": "http"}],
        cpu="100m",
        memory="64Mi",
        probe_path="/healthz",
        probe_port=8080,
    )
    return [
        _deployment("foremast-ui", c),
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "foremast-ui", "namespace": NAMESPACE},
            "spec": {
                "selector": {"app": "foremast-ui"},
                "ports": [{"name": "http", "port": 8080, "targetPort": 8080}],
            },
        },
    ]


def scrape_config_secret() -> dict:
    """Pod-annotation scrape job for Prometheus (role of the reference's
    base64 `0additional-scrape-configs.yaml`): scrape any pod annotated
    prometheus.io/scrape=true, relabeling namespace/pod."""
    job = """\
- job_name: kubernetes-pods-scrape
  kubernetes_sd_configs:
    - role: pod
  relabel_configs:
    - source_labels: [__meta_kubernetes_pod_annotation_prometheus_io_scrape]
      action: keep
      regex: "true"
    - source_labels: [__meta_kubernetes_pod_annotation_prometheus_io_path]
      action: replace
      target_label: __metrics_path__
      regex: (.+)
    - source_labels: [__address__, __meta_kubernetes_pod_annotation_prometheus_io_port]
      action: replace
      regex: ([^:]+)(?::\\d+)?;(\\d+)
      replacement: $1:$2
      target_label: __address__
    - source_labels: [__meta_kubernetes_namespace]
      action: replace
      target_label: namespace
    - source_labels: [__meta_kubernetes_pod_name]
      action: replace
      target_label: pod
    - source_labels: [__meta_kubernetes_pod_label_app]
      action: replace
      target_label: app
"""
    return {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": {
            "name": "additional-scrape-configs",
            "namespace": "monitoring",
        },
        "stringData": {"prometheus-additional.yaml": job},
    }


# ---------------------------------------------------------------------------
# Standalone monitoring stack (role of the reference's
# deploy/prometheus-operator/ kube-prometheus bundle)
# ---------------------------------------------------------------------------
#
# The reference vendors the full kube-prometheus manifests; this tree
# instead GENERATES a minimal self-contained stack — Prometheus with the
# pod-annotation scrape job and the recording rules as native rule files,
# kube-state-metrics (the rules' kube_pod_labels join needs it), and
# Grafana pre-provisioned with the Prometheus datasource — so
# docs/quickstart.md works on an empty cluster with nothing but
# `kubectl apply`. Operator users can skip this dir and use
# `additional-scrape-configs.yaml` + the PrometheusRule CR instead.

MONITORING_NAMESPACE = "monitoring"


def monitoring_namespace() -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": MONITORING_NAMESPACE},
    }


def _scrape_job_yaml() -> str:
    """The pod-annotation scrape job (shared with the operator secret)."""
    return scrape_config_secret()["stringData"]["prometheus-additional.yaml"]


def prometheus_rbac() -> list[dict]:
    return [
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": "prometheus", "namespace": MONITORING_NAMESPACE},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": "foremast-prometheus"},
            "rules": [
                {
                    "apiGroups": [""],
                    "resources": [
                        "nodes",
                        "nodes/metrics",
                        "services",
                        "endpoints",
                        "pods",
                    ],
                    "verbs": ["get", "list", "watch"],
                },
                {"nonResourceURLs": ["/metrics"], "verbs": ["get"]},
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": "foremast-prometheus"},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": "foremast-prometheus",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": "prometheus",
                    "namespace": MONITORING_NAMESPACE,
                }
            ],
        },
    ]


def prometheus_config() -> dict:
    """prometheus.yml + the recording rules as a native rule file (no
    operator needed; same groups as the PrometheusRule CR)."""
    import yaml as _yaml

    rules_spec = prometheus_rule_manifest()["spec"]
    prometheus_yml = (
        "global:\n"
        "  scrape_interval: 30s\n"
        "  evaluation_interval: 30s\n"
        "rule_files:\n"
        "  - /etc/prometheus/rules.yml\n"
        # route the generated Foremast* alert rules (metrics/rules.py)
        # to the stack's Alertmanager (alertmanager() below)
        "alerting:\n"
        "  alertmanagers:\n"
        "    - static_configs:\n"
        "        - targets: ['alertmanager-main.monitoring.svc:9093']\n"
        "scrape_configs:\n"
        "  - job_name: kube-state-metrics\n"
        "    static_configs:\n"
        "      - targets: ['kube-state-metrics.monitoring.svc:8080']\n"
        + "\n".join("  " + ln for ln in _scrape_job_yaml().splitlines())
        + "\n"
    )
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "prometheus-config",
            "namespace": MONITORING_NAMESPACE,
        },
        "data": {
            "prometheus.yml": prometheus_yml,
            "rules.yml": _yaml.safe_dump(rules_spec, sort_keys=False),
        },
    }


def prometheus_deployment() -> list[dict]:
    dep = _deployment(
        "prometheus-k8s",
        {
            "name": "prometheus",
            "image": "prom/prometheus:v2.53.0",
            "args": [
                "--config.file=/etc/prometheus/prometheus.yml",
                "--storage.tsdb.path=/prometheus",
                "--storage.tsdb.retention.time=7d",
            ],
            "ports": [{"containerPort": 9090}],
            "volumeMounts": [
                {"name": "config", "mountPath": "/etc/prometheus"},
                {"name": "data", "mountPath": "/prometheus"},
            ],
            "resources": {
                "requests": {"cpu": "250m", "memory": "512Mi"},
                "limits": {"memory": "2Gi"},
            },
        },
        sa="prometheus",
        namespace=MONITORING_NAMESPACE,
        scrape=False,
    )
    dep["spec"]["template"]["spec"]["volumes"] = [
        {"name": "config", "configMap": {"name": "prometheus-config"}},
        {"name": "data", "emptyDir": {}},
    ]
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": "prometheus-k8s",  # the endpoint every foremast
            "namespace": MONITORING_NAMESPACE,  # component points at
        },
        "spec": {
            "selector": {"app": "prometheus-k8s"},
            "ports": [{"port": 9090, "targetPort": 9090}],
        },
    }
    return [dep, svc]


def kube_state_metrics() -> list[dict]:
    sa = {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": "kube-state-metrics",
            "namespace": MONITORING_NAMESPACE,
        },
    }
    role = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": "foremast-kube-state-metrics"},
        "rules": [
            {
                "apiGroups": [""],
                "resources": [
                    "pods",
                    "nodes",
                    "namespaces",
                    "services",
                    "endpoints",
                ],
                "verbs": ["list", "watch"],
            },
            {
                "apiGroups": ["apps"],
                "resources": ["deployments", "replicasets", "statefulsets"],
                "verbs": ["list", "watch"],
            },
        ],
    }
    binding = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {"name": "foremast-kube-state-metrics"},
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": "foremast-kube-state-metrics",
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": "kube-state-metrics",
                "namespace": MONITORING_NAMESPACE,
            }
        ],
    }
    dep = _deployment(
        "kube-state-metrics",
        {
            "name": "kube-state-metrics",
            "image": "registry.k8s.io/kube-state-metrics/kube-state-metrics:v2.12.0",
            "args": ["--metric-labels-allowlist=pods=[app]"],
            "ports": [{"containerPort": 8080}],
            "resources": {
                "requests": {"cpu": "50m", "memory": "64Mi"},
                "limits": {"memory": "256Mi"},
            },
        },
        sa="kube-state-metrics",
        namespace=MONITORING_NAMESPACE,
        scrape=False,
    )
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": "kube-state-metrics",
            "namespace": MONITORING_NAMESPACE,
        },
        "spec": {
            "selector": {"app": "kube-state-metrics"},
            "ports": [{"port": 8080, "targetPort": 8080}],
        },
    }
    return [sa, role, binding, dep, svc]


def alertmanager_config_yaml() -> str:
    """The default route/receiver config, with the reference bundle's
    cadence (`deploy/prometheus-operator/alertmanager-secret.yaml` —
    base64 of: resolve 5m, 30s group_wait / 5m group_interval / 12h
    repeat, one default receiver). Two deliberate divergences: grouping
    keys on ['alertname', 'app'] instead of the reference's ['job']
    because every generated Foremast* alert is app-scoped (one page per
    service, not one per scrape job), and the receiver is a stub the
    operator points at their pager bridge instead of the operator
    bundle's 'null' sink — `kubectl edit configmap alertmanager-config`
    is the whole integration step."""
    return (
        "global:\n"
        "  resolve_timeout: 5m\n"
        "route:\n"
        "  group_by: ['alertname', 'app']\n"
        "  group_wait: 30s\n"
        "  group_interval: 5m\n"
        "  repeat_interval: 12h\n"
        "  receiver: 'default'\n"
        "receivers:\n"
        "  - name: 'default'\n"
        "    # point this at your pager/chat bridge; an unset webhook list\n"
        "    # keeps alerts visible in the Alertmanager UI/API only\n"
    )


def alertmanager() -> list[dict]:
    """Self-contained Alertmanager (role of the reference's
    alertmanager-{alertmanager,service,secret,serviceAccount}.yaml
    operator bundle): the ForemastAnomaly_*/Foremast*Breach_*/
    ForemastEngineDown rules (`metrics/rules.alert_rules`) evaluate in
    Prometheus and ROUTE here — grouping, silences, and receivers
    included; without it the alert rules fire into the void."""
    cm = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "alertmanager-config",
            "namespace": MONITORING_NAMESPACE,
        },
        "data": {"alertmanager.yml": alertmanager_config_yaml()},
    }
    dep = _deployment(
        "alertmanager-main",
        {
            "name": "alertmanager",
            "image": "prom/alertmanager:v0.27.0",
            "args": [
                "--config.file=/etc/alertmanager/alertmanager.yml",
                "--storage.path=/alertmanager",
            ],
            "ports": [{"containerPort": 9093, "name": "web"}],
            "volumeMounts": [
                {"name": "config", "mountPath": "/etc/alertmanager"},
                {"name": "data", "mountPath": "/alertmanager"},
            ],
            "resources": {
                "requests": {"cpu": "20m", "memory": "64Mi"},
                "limits": {"memory": "256Mi"},
            },
        },
        namespace=MONITORING_NAMESPACE,
        scrape=False,
    )
    dep["spec"]["template"]["spec"]["volumes"] = [
        {"name": "config", "configMap": {"name": "alertmanager-config"}},
        {"name": "data", "emptyDir": {}},
    ]
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            # same service name as the reference bundle
            # (alertmanager-service.yaml) so runbooks port to it directly
            "name": "alertmanager-main",
            "namespace": MONITORING_NAMESPACE,
        },
        "spec": {
            "selector": {"app": "alertmanager-main"},
            "ports": [{"name": "web", "port": 9093, "targetPort": 9093}],
        },
    }
    return [cm, dep, svc]


def node_exporter() -> list[dict]:
    """node-exporter DaemonSet + Service (role of the reference's
    node-exporter-{daemonset,service,serviceAccount}.yaml): host CPU/
    memory feed the cpu/memory metric types of the threshold matrix
    (`foremast-brain.yaml:56-73`). Pods carry the stack's scrape
    annotations, so the existing pod-annotation job collects them — no
    kube-rbac-proxy sidecar (the reference's secure-scrape proxy; this
    self-contained stack scrapes in-cluster HTTP directly)."""
    sa = {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": "node-exporter",
            "namespace": MONITORING_NAMESPACE,
        },
    }
    ds = {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {
            "name": "node-exporter",
            "namespace": MONITORING_NAMESPACE,
            "labels": {"app": "node-exporter"},
        },
        "spec": {
            "selector": {"matchLabels": {"app": "node-exporter"}},
            "template": {
                "metadata": {
                    "labels": {"app": "node-exporter"},
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/port": "9100",
                    },
                },
                "spec": {
                    "serviceAccountName": "node-exporter",
                    "hostNetwork": True,
                    "hostPID": True,
                    "securityContext": {
                        "runAsNonRoot": True,
                        "runAsUser": 65534,
                    },
                    "tolerations": [
                        {
                            "key": "node-role.kubernetes.io/master",
                            "effect": "NoSchedule",
                        },
                        {
                            "key": "node-role.kubernetes.io/control-plane",
                            "effect": "NoSchedule",
                        },
                    ],
                    "containers": [
                        {
                            "name": "node-exporter",
                            "image": "quay.io/prometheus/node-exporter:v1.8.1",
                            "args": [
                                # same collector surface as the reference
                                # daemonset (node-exporter-daemonset.yaml),
                                # minus the localhost+proxy split
                                "--path.procfs=/host/proc",
                                "--path.sysfs=/host/sys",
                                (
                                    "--collector.filesystem.mount-points-exclude="
                                    "^/(dev|proc|sys|var/lib/docker/.+)($|/)"
                                ),
                            ],
                            "ports": [
                                {"containerPort": 9100, "name": "metrics"}
                            ],
                            "resources": {
                                "requests": {"cpu": "50m", "memory": "64Mi"},
                                "limits": {"memory": "180Mi"},
                            },
                            "volumeMounts": [
                                {
                                    "name": "proc",
                                    "mountPath": "/host/proc",
                                    "readOnly": True,
                                },
                                {
                                    "name": "sys",
                                    "mountPath": "/host/sys",
                                    "readOnly": True,
                                },
                            ],
                        }
                    ],
                    "volumes": [
                        {"name": "proc", "hostPath": {"path": "/proc"}},
                        {"name": "sys", "hostPath": {"path": "/sys"}},
                    ],
                },
            },
        },
    }
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": "node-exporter",
            "namespace": MONITORING_NAMESPACE,
            "labels": {"app": "node-exporter"},
        },
        "spec": {
            "clusterIP": "None",
            "selector": {"app": "node-exporter"},
            "ports": [{"name": "metrics", "port": 9100, "targetPort": 9100}],
        },
    }
    return [sa, ds, svc]


def grafana_dashboard() -> dict:
    """A Grafana dashboard generated from the SAME panel spec the built-in
    UI renders (`ui/metrics.DEFAULT_PANELS`) — base series, model band,
    and anomaly gauge per metric, parameterized by $namespace/$app — so
    the Grafana view can never drift from what the engine publishes."""
    import json as _json

    from foremast_tpu_torch.ui.metrics import DEFAULT_PANELS

    panels = []
    for i, p in enumerate(DEFAULT_PANELS):
        scale = "" if p.scale == 1.0 else f" * {p.scale}"
        targets = []
        for s in p.series("$namespace", "$app"):
            targets.append(
                {
                    "expr": s["query"] + scale,
                    "legendFormat": s["type"],
                    "refId": chr(ord("A") + len(targets)),
                }
            )
        panels.append(
            {
                "id": i + 1,
                "type": "timeseries",
                "title": f"{p.common_name} ({p.unit})",
                "gridPos": {
                    "x": (i % 2) * 12,
                    "y": (i // 2) * 8,
                    "w": 12,
                    "h": 8,
                },
                "datasource": {"type": "prometheus", "uid": "prometheus"},
                "targets": targets,
            }
        )
    dashboard = {
        "uid": "foremast",
        "title": "Foremast — application health",
        "tags": ["foremast"],
        "timezone": "browser",
        "refresh": "15s",  # the reference UI's poll (App.js:20,78)
        "time": {"from": "now-1h", "to": "now"},
        "templating": {
            "list": [
                {
                    "name": "namespace",
                    "type": "query",
                    "datasource": {"type": "prometheus", "uid": "prometheus"},
                    "query": "label_values(namespace_app:pod_count, namespace)",
                    "refresh": 2,
                },
                {
                    "name": "app",
                    "type": "query",
                    "datasource": {"type": "prometheus", "uid": "prometheus"},
                    "query": 'label_values(namespace_app:pod_count{namespace="$namespace"}, app)',
                    "refresh": 2,
                },
            ]
        },
        "panels": panels,
        "schemaVersion": 39,
    }
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "grafana-dashboard-foremast",
            "namespace": MONITORING_NAMESPACE,
        },
        "data": {"foremast.json": _json.dumps(dashboard, indent=1)},
    }


def grafana() -> list[dict]:
    provider = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "grafana-dashboard-provider",
            "namespace": MONITORING_NAMESPACE,
        },
        "data": {
            "provider.yaml": (
                "apiVersion: 1\n"
                "providers:\n"
                "  - name: foremast\n"
                "    folder: ''\n"
                "    type: file\n"
                "    options:\n"
                "      path: /var/lib/grafana/dashboards\n"
            )
        },
    }
    datasource = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "grafana-datasources",
            "namespace": MONITORING_NAMESPACE,
        },
        "data": {
            "datasources.yaml": (
                "apiVersion: 1\n"
                "datasources:\n"
                "  - name: Prometheus\n"
                "    uid: prometheus\n"
                "    type: prometheus\n"
                "    access: proxy\n"
                "    url: http://prometheus-k8s.monitoring.svc:9090\n"
                "    isDefault: true\n"
            )
        },
    }
    dep = _deployment(
        "grafana",
        {
            "name": "grafana",
            "image": "grafana/grafana:11.1.0",
            "ports": [{"containerPort": 3000}],
            "env": [
                {"name": "GF_AUTH_ANONYMOUS_ENABLED", "value": "true"},
                {"name": "GF_AUTH_ANONYMOUS_ORG_ROLE", "value": "Admin"},
            ],
            "volumeMounts": [
                {
                    "name": "datasources",
                    "mountPath": "/etc/grafana/provisioning/datasources",
                },
                {
                    "name": "dashboard-provider",
                    "mountPath": "/etc/grafana/provisioning/dashboards",
                },
                {
                    "name": "dashboards",
                    "mountPath": "/var/lib/grafana/dashboards",
                },
            ],
            "resources": {
                "requests": {"cpu": "50m", "memory": "128Mi"},
                "limits": {"memory": "512Mi"},
            },
        },
        namespace=MONITORING_NAMESPACE,
        scrape=False,
    )
    dep["spec"]["template"]["spec"]["volumes"] = [
        {"name": "datasources", "configMap": {"name": "grafana-datasources"}},
        {
            "name": "dashboard-provider",
            "configMap": {"name": "grafana-dashboard-provider"},
        },
        {
            "name": "dashboards",
            "configMap": {"name": "grafana-dashboard-foremast"},
        },
    ]
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": "grafana", "namespace": MONITORING_NAMESPACE},
        "spec": {
            "selector": {"app": "grafana"},
            "ports": [{"port": 3000, "targetPort": 3000}],
        },
    }
    return [provider, grafana_dashboard(), datasource, dep, svc]


# ---------------------------------------------------------------------------
# Demo workload (reference examples/demo/{rollingUpdate,continuous})
# ---------------------------------------------------------------------------

DEMO_NAMESPACE = "foremast-examples"


def demo_deployment(version: str, args: list[str], continuous: bool = False) -> list[dict]:
    """demo_v1 (healthy) / demo_v2 (error-injecting) manifests.

    v2's args are the fault injector (reference: `-DerrorType=5xx
    -Dfrequency=6` in demo_v2.yaml; here the demo module's flags). The
    rolling-update pair shares one Deployment name so `kubectl apply`ing
    v2 over v1 IS the canary event; the continuous variant carries the
    kubectl-watch toggle instead.
    """
    name = "demo"
    c = {
        "name": name,
        "image": IMAGE,
        "imagePullPolicy": "IfNotPresent",
        "command": ["python", "-m", "foremast_tpu_torch.demo"],
        "args": args,
        "ports": [{"containerPort": 8080, "name": "http"}],
        "resources": {
            "requests": {"cpu": "100m", "memory": "128Mi"},
            "limits": {"cpu": "200m", "memory": "256Mi"},
        },
    }
    dep = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": DEMO_NAMESPACE,
            "labels": {"app": name, "version": version},
        },
        "spec": {
            "replicas": 2,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {
                    "labels": {"app": name, "version": version},
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/port": "8080",
                        "prometheus.io/path": "/metrics",
                    },
                },
                "spec": {"containers": [c]},
            },
        },
    }
    docs: list[dict] = [
        {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": DEMO_NAMESPACE},
        },
        dep,
    ]
    if continuous:
        docs.append(
            {
                "apiVersion": API_VERSION,
                "kind": "DeploymentMonitor",
                "metadata": {"name": name, "namespace": DEMO_NAMESPACE},
                "spec": {
                    "selector": {"app": name},
                    "analyst": {
                        "endpoint": f"http://foremast-service.{NAMESPACE}.svc:8099/v1/healthcheck/"
                    },
                    "continuous": True,
                    "remediation": {"option": "AutoRollback"},
                },
            }
        )
    return docs


# ---------------------------------------------------------------------------
# Shell helpers
# ---------------------------------------------------------------------------

MINIKUBE_SH = """\
#!/bin/sh
# Local demo cluster (reference deploy/minikube.sh footprint: 4 CPU / 6 GB).
minikube start --cpus 4 --memory 6144
minikube addons enable ingress
"""

EXPORT_SERVICE_SH = """\
#!/bin/sh
# Port-forward the job gateway to localhost:8099.
kubectl -n foremast port-forward svc/foremast-service 8099:8099
"""

EXPORT_PROMETHEUS_SH = """\
#!/bin/sh
# Port-forward Prometheus to localhost:9090.
kubectl -n monitoring port-forward svc/prometheus-k8s 9090:9090
"""

EXPORT_UI_SH = """\
#!/bin/sh
# Port-forward the dashboard to localhost:8080.
kubectl -n foremast port-forward svc/foremast-ui 8080:8080
"""

README = """\
# Deploying foremast-tpu's PyTorch/CUDA port on Kubernetes

Generated tree - do not edit by hand; run `python -m foremast_tpu_torch.deploy deploy_torch/`
after changing `foremast_tpu_torch/deploy/manifests.py`.

Install order (numbered dirs, like the reference's deploy/foremast), from
an EMPTY cluster — no out-of-repo prerequisites:

    kubectl apply -f prometheus/00namespace.yaml
    kubectl apply -f prometheus/1_rbac/
    kubectl apply -f prometheus/2_stack/
    kubectl apply -f foremast/00namespace.yaml
    kubectl apply -f foremast/1_crds/
    kubectl apply -f foremast/2_watch/
    kubectl apply -f foremast/3_engine/

`prometheus/` is a minimal self-contained monitoring stack (role of the
reference's `deploy/prometheus-operator/` kube-prometheus bundle):
Prometheus with the pod-annotation scrape job and the generated recording
rules mounted as native rule files, kube-state-metrics (the rules'
`kube_pod_labels` join), Alertmanager on :9093 receiving the generated
`Foremast*` alert rules (edit `alertmanager-config` to point the default
receiver at your pager), node-exporter feeding the cpu/memory metric
types, and Grafana pre-provisioned with the Prometheus datasource on
:3000. If you already run prometheus-operator instead, skip
`prometheus/{00namespace.yaml,1_rbac,2_stack}` and use
`prometheus/additional-scrape-configs.yaml` as an additionalScrapeConfigs
secret plus `foremast/2_watch/metrics-rules.yaml` (the same rules as a
PrometheusRule CR).

The engine Deployment requests one NVIDIA H100 (`nvidia.com/gpu: 1`, GKE
`nvidia-h100-80gb` node selector) and judges on it; scale out with more
replicas (the worker mesh partitions the fleet), edit `engine_deployment()`
for another card, or drop the GPU request and pass `--device cpu` to score
on CPU. `minikube.sh` bootstraps a local demo cluster; `export/*.sh`
port-forward the service (:8099), Prometheus (:9090), and the UI (:8080).

Demo runbook (the reference's de-facto integration test,
docs/guides/installation.md:84-143): apply `examples/demo/rollingUpdate/
demo_v1.yaml`, wait >= 5 min so history accumulates, apply `demo_v2.yaml`
(error injector) and watch `kubectl -n foremast-examples get
deploymentmonitor demo -w` reach phase Unhealthy followed by automatic
rollback to v1. The `continuous/` variants carry a DeploymentMonitor with
`continuous: true` (what `kubectl watch demo` toggles).
"""


# ---------------------------------------------------------------------------
# Tree assembly
# ---------------------------------------------------------------------------


def tree(cfg: BrainConfig | None = None) -> dict[str, object]:
    """path -> manifest list (YAML docs) or literal string content."""
    rules = prometheus_rule_manifest(namespace=NAMESPACE)
    return {
        "README.md": README,
        "minikube.sh": MINIKUBE_SH,
        "export/export-service.sh": EXPORT_SERVICE_SH,
        "export/export-prometheus.sh": EXPORT_PROMETHEUS_SH,
        "export/export-ui.sh": EXPORT_UI_SH,
        "prometheus/additional-scrape-configs.yaml": [scrape_config_secret()],
        "prometheus/00namespace.yaml": [monitoring_namespace()],
        "prometheus/1_rbac/prometheus-rbac.yaml": prometheus_rbac(),
        "prometheus/2_stack/prometheus-config.yaml": [prometheus_config()],
        "prometheus/2_stack/prometheus.yaml": prometheus_deployment(),
        "prometheus/2_stack/kube-state-metrics.yaml": kube_state_metrics(),
        "prometheus/2_stack/alertmanager.yaml": alertmanager(),
        "prometheus/2_stack/node-exporter.yaml": node_exporter(),
        "prometheus/2_stack/grafana.yaml": grafana(),
        "foremast/00namespace.yaml": [namespace()],
        "foremast/1_crds/deploymentmetadata.yaml": [deployment_metadata_crd()],
        "foremast/1_crds/deploymentmonitor.yaml": [deployment_monitor_crd()],
        "foremast/2_watch/foremast-watch-rbac.yaml": watch_rbac(),
        "foremast/2_watch/foremast-watch.yaml": [watch_deployment()],
        "foremast/2_watch/deployment-metadata-default.yaml": [default_metadata_cr()],
        "foremast/2_watch/metrics-rules.yaml": [rules],
        "foremast/3_engine/es.yaml": elasticsearch(),
        "foremast/3_engine/foremast-service.yaml": service_deployment(),
        "foremast/3_engine/foremast-engine.yaml": engine_deployment(cfg),
        "foremast/3_engine/foremast-ui.yaml": ui_deployment(),
        "examples/demo/rollingUpdate/demo_v1.yaml": demo_deployment("v1", []),
        "examples/demo/rollingUpdate/demo_v2.yaml": demo_deployment(
            "v2", ["--error-type", "5xx", "--frequency", "6"]
        ),
        "examples/demo/continuous/demo_v1.yaml": demo_deployment(
            "v1", [], continuous=True
        ),
        "examples/demo/continuous/demo_v2.yaml": demo_deployment(
            "v2",
            ["--trace", "/app/tests/data/demo_canary_spike.csv"],
            continuous=True,
        ),
    }


def render_file(content: object) -> str:
    import json

    import yaml

    if isinstance(content, str):
        return content
    # JSON round-trip breaks object identity between shared schema fragments
    # so the YAML emitter never writes anchors/aliases.
    return yaml.safe_dump_all(
        json.loads(json.dumps(content)), sort_keys=False, default_flow_style=False
    )


def render(root: str) -> list[str]:
    """Write the tree under `root`; returns the paths written."""
    import os

    written = []
    for rel, content in tree().items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(render_file(content))
        if path.endswith(".sh"):
            os.chmod(path, 0o755)
        written.append(path)
    return written
