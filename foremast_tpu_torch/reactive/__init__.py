"""Reactive plane: judge on arrival, not on tick.

The port's copy of the ingest half of the JAX package's
`foremast_tpu/reactive/`: the receiver marks each pushed series' route
key in a bounded `DirtySet`, and the worker drains it between full ticks
through micro-ticks (`BrainWorker.micro_tick`) that claim just the dirty
documents; full ticks demote to sweeps. The push->verdict latency
histogram (`foremast_verdict_latency_seconds`) is the plane's end-to-end
metric. The K8s half, `watchstream.py`, is the watch plane's streaming
informer (`StreamingInformer`, `FOREMAST_WATCH_STREAM=1`): deployment
events dispatch on arrival from the API server's watch stream, with
resourceVersion resume, 410-Gone re-lists and stall restarts.
"""

from foremast_tpu_torch.reactive.dirty import (
    DEFAULT_DIRTY_MAX,
    DirtySet,
    ReactiveCollector,
    microtick_docs_from_env,
    microtick_seconds_from_env,
    sweep_slice_docs_from_env,
)

__all__ = [
    "DEFAULT_DIRTY_MAX",
    "DirtySet",
    "ReactiveCollector",
    "microtick_docs_from_env",
    "microtick_seconds_from_env",
    "sweep_slice_docs_from_env",
]
