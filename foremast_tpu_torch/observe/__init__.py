"""Observability: the span pipeline (per-stage tick breakdown, Perfetto
dumps, profiler markers), JSON logs that carry its trace IDs, and the
`torch.profiler` hooks (`trace_scoring`, `annotate`)."""

from foremast_tpu_torch.observe.profile import annotate, trace_scoring

__all__ = ["annotate", "trace_scoring"]
