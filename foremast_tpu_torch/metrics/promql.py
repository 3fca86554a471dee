"""PromQL query construction + datasource URLs + config codec.

Three reference contracts reproduced exactly:

1. The metrics-query construction (barrelman
   `pkg/client/metrics/metricsquery.go:14-127`): three query sets per job —
   current / baseline / historical — over the recording-rule series
   `namespace_pod:<metric>` and `namespace_app_per_pod:<metric>`, fixed
   step=60 s, +1 min Prometheus-latency offset on current, 7-day
   historical window.
2. The query_range URL format (service
   `pkg/prometheus/prometheushelper.go:12-27`) and the wavefront stub
   (`pkg/wavefront/wavefronthelper.go:20-29`).
3. The config-string codec (service `cmd/manager/main.go:28-74`): each
   window's alias->URL map flattens to `alias== <url> ||alias2== <url2>`
   with separators `" ||"` and `"== "` — the strings the brain reads back
   from the ES document.
"""

from __future__ import annotations

import urllib.parse
from typing import Mapping

from foremast_tpu_torch.jobs.models import MetricQuery, MetricsInfo

STEP_SECONDS = 60  # metricsquery.go:43
PROMETHEUS_LATENCY_OFFSET = 60  # +1 min compensation, metricsquery.go:53-55
HISTORICAL_WINDOW = 7 * 24 * 3600  # 7 days, metricsquery.go:75-77

STRATEGY_ROLLING_UPDATE = "rollingUpdate"
STRATEGY_CANARY = "canary"
STRATEGY_CONTINUOUS = "continuous"

CONFIG_ENTRY_SEP = " ||"  # main.go:28-31
CONFIG_KV_SEP = "== "


# ---------------------------------------------------------------------------
# PromQL query text (metricsquery.go:45-78)
# ---------------------------------------------------------------------------


def pods_query(metric: str, namespace: str, pods: list[str]) -> str:
    """`namespace_pod:<metric>{namespace="ns",pod=~"p1|p2"}` — the
    pod-pinned form for canary/rolling current+baseline windows."""
    pod_re = "|".join(pods)
    return f'namespace_pod:{metric}{{namespace="{namespace}",pod=~"{pod_re}"}}'


def app_query(metric: str, namespace: str, app: str) -> str:
    """`namespace_app_per_pod:<metric>{namespace="ns",app="app"}` — the
    app-aggregated form for historical + continuous windows."""
    return f'namespace_app_per_pod:{metric}{{namespace="{namespace}",app="{app}"}}'


def create_metrics_info(
    strategy: str,
    metric_names: Mapping[str, str],
    namespace: str,
    app: str,
    start: int,
    end: int,
    endpoint: str,
    new_pods: list[str] | None = None,
    old_pods: list[str] | None = None,
) -> MetricsInfo:
    """CreateMetricsInfo parity (metricsquery.go:91-127).

    metric_names: alias -> PromQL metric (the DeploymentMetadata monitoring
    list, types.go). Windows: current = [start+offset, end+offset] on new
    pods (or app-wide for continuous); baseline = [start-window, start] on
    old pods, only for canary/continuous with two pod groups; historical =
    app-wide last 7 days.
    """
    window = end - start
    info = MetricsInfo()
    for alias, metric in metric_names.items():
        if strategy == STRATEGY_CONTINUOUS or not new_pods:
            cur_q = app_query(metric, namespace, app)
        else:
            cur_q = pods_query(metric, namespace, new_pods)
        info.current[alias] = MetricQuery(
            "prometheus",
            {
                "endpoint": endpoint,
                "query": cur_q,
                "start": start + PROMETHEUS_LATENCY_OFFSET,
                "end": end + PROMETHEUS_LATENCY_OFFSET,
                "step": STEP_SECONDS,
            },
        )
        if strategy in (STRATEGY_CANARY, STRATEGY_CONTINUOUS) and old_pods:
            info.baseline[alias] = MetricQuery(
                "prometheus",
                {
                    "endpoint": endpoint,
                    "query": pods_query(metric, namespace, old_pods),
                    "start": start - window,
                    "end": start,
                    "step": STEP_SECONDS,
                },
            )
        info.historical[alias] = MetricQuery(
            "prometheus",
            {
                "endpoint": endpoint,
                "query": app_query(metric, namespace, app),
                "start": start - HISTORICAL_WINDOW,
                "end": start,
                "step": STEP_SECONDS,
            },
        )
    return info


# ---------------------------------------------------------------------------
# Datasource URLs
# ---------------------------------------------------------------------------


def prometheus_url(params: Mapping[str, object]) -> str:
    """`<endpoint>query_range?query=<urlencoded>&start=&end=&step=`
    (prometheushelper.go:12-27)."""
    endpoint = str(params.get("endpoint", ""))
    q = urllib.parse.quote(str(params.get("query", "")), safe="")
    return (
        f"{endpoint}query_range?query={q}"
        f"&start={params.get('start', '')}"
        f"&end={params.get('end', '')}"
        f"&step={params.get('step', '')}"
    )


def wavefront_url(params: Mapping[str, object]) -> str:
    """`<query>&&<start>&&<step-unit>&&<end>` (wavefronthelper.go:20-29);
    step granularity mapped to wavefront units m/s/h/d."""
    step = int(params.get("step", 60) or 60)
    unit = {60: "m", 1: "s", 3600: "h", 86400: "d"}.get(step, "m")
    return (
        f"{params.get('query', '')}&&{params.get('start', '')}"
        f"&&{unit}&&{params.get('end', '')}"
    )


_URL_BUILDERS = {"prometheus": prometheus_url, "wavefront": wavefront_url}


def build_url(mq: MetricQuery) -> str:
    make_url = _URL_BUILDERS.get(mq.data_source_type)
    if make_url is None:
        raise ValueError(f"unsupported dataSourceType {mq.data_source_type!r}")
    return make_url(mq.parameters)


# ---------------------------------------------------------------------------
# Config-string codec (main.go:28-74)
# ---------------------------------------------------------------------------


def encode_config(queries: Mapping[str, MetricQuery]) -> tuple[str, str]:
    """alias->MetricQuery map -> (config_string, source_string):
    `alias== <url> ||alias2== <url2>` and the parallel datasource list."""
    parts = []
    sources = []
    for alias in sorted(queries):
        mq = queries[alias]
        parts.append(f"{alias}{CONFIG_KV_SEP}{build_url(mq)}")
        sources.append(f"{alias}{CONFIG_KV_SEP}{mq.data_source_type}")
    return CONFIG_ENTRY_SEP.join(parts), CONFIG_ENTRY_SEP.join(sources)


def decode_config(config: str) -> dict[str, str]:
    """config string -> alias -> URL (what the brain fetches)."""
    out: dict[str, str] = {}
    if not config:
        return out
    for entry in config.split(CONFIG_ENTRY_SEP):
        entry = entry.strip()
        if not entry:
            continue
        alias, sep, url = entry.partition(CONFIG_KV_SEP)
        if sep:
            out[alias.strip()] = url.strip()
    return out
