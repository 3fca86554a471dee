"""Metric windows in: the config-string codec, the datasource URL
functions and the in-memory metric sources."""

from foremast_tpu_torch.metrics.promql import (
    build_url,
    decode_config,
    encode_config,
    prometheus_url,
    wavefront_url,
)
from foremast_tpu_torch.metrics.source import (
    MetricSource,
    ReplaySource,
    StaticSource,
    load_csv_trace,
)

__all__ = [
    "build_url",
    "decode_config",
    "encode_config",
    "prometheus_url",
    "wavefront_url",
    "MetricSource",
    "ReplaySource",
    "StaticSource",
    "load_csv_trace",
]
