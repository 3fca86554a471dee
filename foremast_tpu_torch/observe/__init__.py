"""Observability: the span pipeline (per-stage tick breakdown, Perfetto
dumps, profiler markers) and JSON logs that carry its trace IDs."""
