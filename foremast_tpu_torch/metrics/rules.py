"""Metric-aggregation layer: Prometheus recording rules, generated.

The port's copy of the JAX package's `foremast_tpu/metrics/rules.py`: the
same rules, records and YAML, byte for byte.

The reference ships a hand-written PrometheusRule manifest
(`deploy/foremast/2_barrelman/metrics-rules-default.yaml:15-39,45-56`) that
pre-aggregates raw app/kubelet series into the three naming families the
query builder consumes (`metricsquery.go:53-78`):

    namespace_pod:<metric>          sum by (namespace, pod)
    namespace_app:<metric>          sum by (namespace, app)
    namespace_app_per_pod:<metric>  namespace_app:<metric> / namespace_app:pod_count

Rather than maintaining a YAML blob, this module *generates* the rule set
from a compact spec: HTTP request-rate families are one template over a
status-class regex; the per-pod family is a pure quotient of the per-app
family. `prometheus_rule_manifest()` renders the PrometheusRule custom
resource used by deploy/, and `rule_expr()` lets tests and the replay
metric store resolve what a recorded series means.
"""

from __future__ import annotations

import dataclasses
import functools
import json

from collections.abc import Iterable

from foremast_tpu_torch.observe.gauges import _san

# Rate window for request-class rules (reference uses [1m] throughout the
# spring.boot.metrics.rules group; resource rules use [5m]).
REQUEST_RATE_WINDOW = "1m"
CPU_RATE_WINDOW = "5m"

# status-class regex per derived request metric (reference
# metrics-rules-default.yaml spring.boot group). `None` means no status
# selector (total request count).
REQUEST_CLASSES: dict[str, str | None] = {
    "http_server_requests_2xx": "2[0-9]+",
    "http_server_requests_error_4xx": "4[0-9]+",
    "http_server_requests_error_5xx": "5[0-9]+",
    "http_server_requests_errors": "[4-5][0-9]+",
    "http_server_requests_count": None,
}

# Resource metrics from kubelet/cAdvisor, aggregated the same three ways.
RESOURCE_METRICS = ("cpu_usage_seconds_total", "memory_usage_bytes")

LATENCY_METRIC = "http_server_requests_latency"

#: Every derived metric name the aggregation layer records (the vocabulary
#: the DeploymentMetadata `monitoring:` lists draw from).
ALL_METRICS: tuple[str, ...] = (
    *REQUEST_CLASSES,
    LATENCY_METRIC,
    *RESOURCE_METRICS,
)


@dataclasses.dataclass(frozen=True)
class RecordingRule:
    record: str
    expr: str

    def to_dict(self) -> dict[str, str]:
        return {"record": self.record, "expr": self.expr}


def _requests_rate(status_re: str | None, by: str) -> str:
    sel = f'{{status=~"{status_re}"}}' if status_re else ""
    return (
        f"sum(rate(http_server_requests_seconds_count{sel}"
        f"[{REQUEST_RATE_WINDOW}])) by (namespace, {by})"
    )


def _latency(by: str) -> str:
    return (
        'sum(rate(http_server_requests_seconds_sum{status="200"}'
        f"[{REQUEST_RATE_WINDOW}])"
        '/rate(http_server_requests_seconds_count{status="200"}'
        f"[{REQUEST_RATE_WINDOW}])) by (namespace, {by})"
    )


# join raw cAdvisor pod_name series onto the `app` pod label via
# kube-state-metrics, the reference's label_replace dance
_APP_JOIN = (
    " * on (namespace, pod_name) group_left(app) label_replace(label_replace("
    'kube_pod_labels{job="kube-state-metrics"}, "pod_name", "$1", "pod", '
    '"(.*)"), "app", "$1", "label_app", "(.*)")'
)


def _resource_expr(metric: str, by: str) -> str:
    if metric == "cpu_usage_seconds_total":
        inner = (
            "sum(rate(container_cpu_usage_seconds_total"
            f'{{job="kubelet", image!="", container_name!=""}}[{CPU_RATE_WINDOW}]))'
            " by (namespace, pod_name)"
        )
    else:
        inner = (
            "sum(container_memory_usage_bytes"
            '{job="kubelet", image!="", container_name!=""}) by (namespace, pod_name)'
        )
    if by == "pod":
        return (
            f'sum by (namespace, pod) (label_replace({inner}, "pod", "$1", '
            '"pod_name", "(.*)"))'
        )
    return f"sum by (namespace, app) ({inner}{_APP_JOIN})"


def core_rules() -> list[RecordingRule]:
    """Resource aggregation + the pod_count denominator."""
    rules = []
    for metric in RESOURCE_METRICS:
        rules.append(
            RecordingRule(f"namespace_pod:{metric}", _resource_expr(metric, "pod"))
        )
        rules.append(
            RecordingRule(f"namespace_app:{metric}", _resource_expr(metric, "app"))
        )
    rules.append(
        RecordingRule(
            "namespace_app:pod_count",
            'count(label_replace(kube_pod_labels{job="kube-state-metrics"}, '
            '"app", "$1", "label_app", "(.*)")) by (namespace, app)',
        )
    )
    rules.extend(_per_pod_rules(RESOURCE_METRICS))
    return rules


def request_rules() -> list[RecordingRule]:
    """HTTP request-class + latency aggregation (app-instrumented series)."""
    rules = []
    for by in ("pod", "app"):
        prefix = "namespace_pod" if by == "pod" else "namespace_app"
        for metric, status_re in REQUEST_CLASSES.items():
            rules.append(
                RecordingRule(f"{prefix}:{metric}", _requests_rate(status_re, by))
            )
        rules.append(RecordingRule(f"{prefix}:{LATENCY_METRIC}", _latency(by)))
    rules.extend(_per_pod_rules((*REQUEST_CLASSES, LATENCY_METRIC)))
    return rules


def _per_pod_rules(metrics: Iterable[str]) -> list[RecordingRule]:
    return [
        RecordingRule(
            f"namespace_app_per_pod:{m}",
            f"namespace_app:{m} / namespace_app:pod_count",
        )
        for m in metrics
    ]


#: Gauge suffixes the brain publishes per metric
#: (`foremast-brain.yaml:109-122`).
BRAIN_GAUGE_SUFFIXES = ("upper", "lower", "anomaly")


#: The recorded family the engine's gauges are named after: historical
#: queries always use the per-app form (`metricsquery.go:73-78`), and the
#: reference browser charts exactly these (`metrics.js:15-23`).
def brain_gauge_series(metric: str) -> str:
    return f"namespace_app_per_pod:{metric}"


def brain_rules() -> list[RecordingRule]:
    """Restore the reference's `foremastbrain:` colon spelling.

    The scoring worker names its gauges after the job's base series and
    exposes them with '_' for ':' on :8000/metrics (prometheus_client
    forbids ':' — it is reserved for recording rules):
    `foremastbrain_namespace_app_per_pod_<metric>_{upper,lower,anomaly}`.
    The reference contract, which its dashboards and alert rules are
    written against, is the colon form
    `foremastbrain:namespace_app_per_pod:<metric>_{upper,lower,anomaly}`
    (`deploy/foremast/3_brain/foremast-brain.yaml:109-122`,
    `foremast-browser/src/config/metrics.js:15-23`). One recording rule
    per (metric, bound) republishes each exported series under the exact
    reference name, for every metric in the standard vocabulary."""
    return [
        RecordingRule(
            f"foremastbrain:{brain_gauge_series(m)}_{suffix}",
            f"foremastbrain_{_san(brain_gauge_series(m))}_{suffix}",
        )
        for m in ALL_METRICS
        for suffix in BRAIN_GAUGE_SUFFIXES
    ]


def alert_rules() -> list[dict]:
    """Alerting rules over the brain's gauge families.

    The reference declares the intent without shipping rules: "We will
    send foremast internal metrics so that we can define AlertRules in
    prometheus to generate Alerts" (`types.go:190-191`). These close that
    loop, written against the colon-spelled series `brain_rules` records:

      * ForemastAnomaly_<metric>  — the sticky anomaly gauge changed
        value or newly appeared in the last 5 m (an anomaly EVENT; the
        gauge holds the last anomalous value forever, so changes() +
        appearance isolate events — same semantics as the dashboard
        join, ui/join.py);
      * Foremast{Upper,Lower}Breach_<metric> — the measured per-app
        series breaches the model band for 2 m, direction-aware: error/
        latency/resource metrics page above the UPPER band, success/
        traffic metrics (2xx, request count) page below the LOWER band
        (label_replace aligns the gauge's exported_namespace with the
        recorded series' namespace);
      * ForemastEngineDown        — no scoring engine is exporting
        self-telemetry at all.
    """
    rules: list[dict] = []
    for m in ALL_METRICS:
        gauge = brain_gauge_series(m)  # the series the engine publishes
        anom = f"foremastbrain:{gauge}_anomaly"
        rules.append(
            {
                "alert": f"ForemastAnomaly_{m}",
                # the sticky gauge yields an event when its value CHANGES
                # or when the series APPEARS (first-ever anomaly for this
                # app — changes() alone is 0 on a newly-born series). A
                # repeat anomaly at the exact same value inside one series
                # lifetime is indistinguishable from stickiness — a
                # limitation of the reference's gauge contract itself.
                "expr": (
                    f"changes({anom}[5m]) > 0 or ({anom} unless {anom} offset 5m)"
                ),
                "labels": {"severity": "warning"},
                "annotations": {
                    "summary": (
                        "Foremast flagged an anomaly on "
                        + m
                        + " for {{ $labels.app }} in "
                        + "{{ $labels.exported_namespace }}"
                    )
                },
            }
        )
        # direction-aware band breach: error/latency/resource metrics page
        # when ABOVE the upper band; success/traffic metrics page when
        # BELOW the lower band (a 2xx/request-rate collapse is the outage
        # signal for those; healthy-high traffic above the band is not).
        low_is_bad = m in (
            "http_server_requests_2xx",
            "http_server_requests_count",
        )
        band = "lower" if low_is_bad else "upper"
        cmp_op = "<" if low_is_bad else ">"
        agg = "min" if low_is_bad else "max"
        rules.append(
            {
                "alert": (
                    f"Foremast{'Lower' if low_is_bad else 'Upper'}Breach_{m}"
                ),
                # min/max by(...) dedupes scrape-label variants of the
                # gauge (engine restart keeps the old pod's series alive
                # for the staleness window; group_left needs a unique
                # right side)
                "expr": (
                    f"{gauge} {cmp_op} on(namespace, app) group_left() "
                    f"{agg} by (namespace, app) (label_replace("
                    f'foremastbrain:{gauge}_{band}, "namespace", "$1", '
                    '"exported_namespace", "(.*)"))'
                ),
                "for": "2m",
                "labels": {"severity": "warning"},
                "annotations": {
                    "summary": (
                        m
                        + f" {'below' if low_is_bad else 'above'} the model's "
                        + f"{band} band for "
                        + "{{ $labels.app }} in {{ $labels.namespace }}"
                    )
                },
            }
        )
    rules.append(
        {
            "alert": "ForemastEngineDown",
            "expr": "absent(foremast_worker_tick_seconds_count)",
            "for": "5m",
            "labels": {"severity": "critical"},
            "annotations": {
                "summary": "no foremast scoring engine is exporting telemetry"
            },
        }
    )
    return rules


def all_rules() -> list[RecordingRule]:
    return core_rules() + request_rules() + brain_rules()


@functools.lru_cache(maxsize=1)
def _by_record() -> dict[str, str]:
    return {r.record: r.expr for r in all_rules()}


def rule_expr(record: str) -> str | None:
    """Resolve a recorded series name to its PromQL definition."""
    return _by_record().get(record)


def prometheus_rule_manifest(
    name: str = "foremast-metrics-rules", namespace: str = "monitoring"
) -> dict:
    """The PrometheusRule custom resource (monitoring.coreos.com/v1)."""
    return {
        "apiVersion": "monitoring.coreos.com/v1",
        "kind": "PrometheusRule",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"prometheus": "k8s", "role": "alert-rules"},
        },
        "spec": {
            "groups": [
                {
                    "name": "core.metrics.aggregation.rules",
                    "rules": [r.to_dict() for r in core_rules()],
                },
                {
                    "name": "request.metrics.aggregation.rules",
                    "rules": [r.to_dict() for r in request_rules()],
                },
                {
                    "name": "foremastbrain.gauge.spelling.rules",
                    "rules": [r.to_dict() for r in brain_rules()],
                },
                {
                    "name": "foremast.alert.rules",
                    "rules": alert_rules(),
                },
            ]
        },
    }


def _yaml_scalar(s: str) -> str:
    """Quote a scalar for YAML output (JSON strings are valid YAML)."""
    return json.dumps(s)


def to_yaml(manifest: dict | None = None) -> str:
    """Render the manifest as YAML without a yaml dependency (the image has
    PyYAML, but keeping the renderer dependency-free makes the deploy
    artifacts reproducible from a bare interpreter)."""
    m = manifest if manifest is not None else prometheus_rule_manifest()
    lines: list[str] = []

    def emit(obj, indent: int, in_list: bool = False) -> None:
        pad = "  " * indent
        if isinstance(obj, dict):
            first = True
            for k, v in obj.items():
                lead = pad[:-2] + "- " if in_list and first else pad
                first = False
                if isinstance(v, (dict, list)) and v:
                    lines.append(f"{lead}{k}:")
                    emit(v, indent + 1)
                else:
                    val = _yaml_scalar(v) if isinstance(v, str) else json.dumps(v)
                    lines.append(f"{lead}{k}: {val}")
        elif isinstance(obj, list):
            for item in obj:
                if isinstance(item, dict):
                    emit(item, indent + 1, in_list=True)
                else:
                    val = (
                        _yaml_scalar(item)
                        if isinstance(item, str)
                        else json.dumps(item)
                    )
                    lines.append(f"{pad}- {val}")

    emit(m, 0)
    return "\n".join(lines) + "\n"
