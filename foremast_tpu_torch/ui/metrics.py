"""Dashboard metric-panel configuration.

The port's copy of the JAX package's `foremast_tpu/ui/metrics.py`.

Role parity with the reference UI's `foremast-browser/src/config/metrics.js`
(`METRICS_MAP`): each panel charts four series — BASE (the measured
recording-rule series), UPPER/LOWER (the model band the engine publishes)
and ANOMALY (anomaly-timestamp gauge) — with per-panel scale/unit.

Differences from the reference, by design:
  * series names are *generated* from the base metric with the exact
    sanitization `observe.gauges.BrainGauges` uses when exporting
    (prometheus_client forbids ':' in names), so the dashboard can never
    drift from what the engine actually publishes;
  * the map is parameterized by (namespace, app) instead of hardcoding the
    demo's labels (`metrics.js` hardcodes foremast-examples/demo).
"""

from __future__ import annotations

import dataclasses

from foremast_tpu_torch.observe.gauges import _san

BASE = "base"
UPPER = "upper"
LOWER = "lower"
ANOMALY = "anomaly"

GAUGE_NAMESPACE = "foremastbrain"


@dataclasses.dataclass(frozen=True)
class Panel:
    """One chart: a base recording-rule series + its model-band family."""

    metric: str  # base series, e.g. namespace_app_per_pod:http_server_requests_latency
    common_name: str
    scale: float = 1.0
    unit: str = "count"

    def series(self, namespace: str, app: str) -> list[dict]:
        base_sel = f'{{namespace="{namespace}",app="{app}"}}'
        # the engine exports with exported_namespace/app labels
        # (gauges.py BrainGauges.publish)
        gauge_sel = f'{{exported_namespace="{namespace}",app="{app}"}}'
        g = f"{GAUGE_NAMESPACE}_{_san(self.metric)}"
        return [
            {"type": BASE, "name": self.metric, "query": self.metric + base_sel},
            {"type": UPPER, "name": f"{g}_upper", "query": f"{g}_upper" + gauge_sel},
            {"type": LOWER, "name": f"{g}_lower", "query": f"{g}_lower" + gauge_sel},
            {
                "type": ANOMALY,
                "name": f"{g}_anomaly",
                "query": f"{g}_anomaly" + gauge_sel,
            },
        ]

    def to_json(self, namespace: str, app: str) -> dict:
        return {
            "metric": self.metric,
            "commonName": self.common_name,
            "scale": self.scale,
            "unit": self.unit,
            "series": self.series(namespace, app),
        }


# Default panel set — the reference's METRICS_MAP entries (5xx, latency,
# CPU, memory) plus 4xx/tps which its recording rules also record.
DEFAULT_PANELS: tuple[Panel, ...] = (
    Panel(
        "namespace_app_per_pod:http_server_requests_error_5xx",
        "5XX Errors",
    ),
    Panel(
        "namespace_app_per_pod:http_server_requests_error_4xx",
        "4XX Errors",
    ),
    Panel(
        "namespace_app_per_pod:http_server_requests_latency",
        "Latency",
        scale=1000,
        unit="ms",
    ),
    Panel(
        "namespace_app_per_pod:http_server_requests_count",
        "Request Rate",
        unit="req/s",
    ),
    Panel(
        "namespace_app_per_pod:cpu_usage_seconds_total",
        "CPU",
        unit="cores",
    ),
    Panel(
        "namespace_app_per_pod:memory_usage_bytes",
        "Memory",
        scale=1 / (1024 * 1024),
        unit="MiB",
    ),
)


def _validate_panels(panels: tuple[Panel, ...]) -> None:
    """Every panel's base metric must be a series the recording-rule
    generator actually records — the no-drift guarantee for the base
    curve (the gauge names already share the engine's sanitizer)."""
    from foremast_tpu_torch.metrics.rules import rule_expr

    for p in panels:
        if rule_expr(p.metric) is None:
            raise ValueError(
                f"panel {p.common_name!r} charts {p.metric!r}, which is not "
                "a generated recording rule (metrics/rules.py)"
            )


_validate_panels(DEFAULT_PANELS)


def dashboard_config(
    service_endpoint: str,
    namespace: str = "foremast-examples",
    app: str = "demo",
    panels: tuple[Panel, ...] = DEFAULT_PANELS,
    poll_seconds: int = 15,
    window_seconds: int = 3600,
    step_seconds: int = 15,
) -> dict:
    """The JSON blob injected into index.html as window.FOREMAST_CONFIG.

    poll/step of 15 s match the reference UI (`App.js:20,78`)."""
    return {
        "serviceEndpoint": service_endpoint.rstrip("/"),
        "namespace": namespace,
        "app": app,
        "pollSeconds": poll_seconds,
        "windowSeconds": window_seconds,
        "stepSeconds": step_seconds,
        "panels": [p.to_json(namespace, app) for p in panels],
    }
