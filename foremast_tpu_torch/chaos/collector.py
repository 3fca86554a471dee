"""`ChaosCollector` — the chaos plane's Prometheus exposition (the port's
copy of `foremast_tpu/chaos/collector.py`, same family names, types and
labels).

A custom collector over the live `Degradation` bundle (the same pattern
as `ingest.IngestCollector`): the hot paths only bump plain lock-guarded
counters; families are materialized at scrape time, and
`prometheus_client` is imported then, never when this module is.
"""

from __future__ import annotations

from foremast_tpu_torch.chaos.breaker import STATE_CODES
from foremast_tpu_torch.chaos.degrade import Degradation


class ChaosCollector:
    """prometheus_client custom collector over a `Degradation` bundle."""

    def __init__(self, degradation: Degradation):
        self._d = degradation

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        d = self._d
        injections = CounterMetricFamily(
            "foremast_chaos_injections",
            "faults injected by the active FOREMAST_CHAOS_PLAN, by "
            "dependency edge and fault kind (latency sleeps count too)",
            labels=["edge", "kind"],
        )
        if d.chaos_plan is not None:
            for (edge, kind), n in sorted(
                d.chaos_plan.injections_snapshot().items()
            ):
                injections.add_metric([edge, kind], n)
        yield injections

        state = GaugeMetricFamily(
            "foremast_breaker_state",
            "circuit-breaker state per dependency edge "
            "(0=closed, 1=half-open, 2=open)",
            labels=["edge"],
        )
        transitions = CounterMetricFamily(
            "foremast_breaker_transitions",
            "circuit-breaker state transitions, by edge and target state",
            labels=["edge", "state"],
        )
        shorts = CounterMetricFamily(
            "foremast_breaker_short_circuits",
            "calls rejected without touching the dependency because "
            "its breaker was open",
            labels=["edge"],
        )
        for edge, br in sorted(d.breakers.all().items()):
            snap = br.debug_state()
            state.add_metric([edge], STATE_CODES[snap["state"]])
            for to, n in sorted(snap["transitions"].items()):
                transitions.add_metric([edge, to], n)
            shorts.add_metric([edge], snap["short_circuits"])
        yield state
        yield transitions
        yield shorts

        docs = CounterMetricFamily(
            "foremast_degraded_docs",
            "documents handled by degradation machinery instead of the "
            "healthy path (released un-judged, buffered/replayed/"
            "dropped write-backs), by reason",
            labels=["reason"],
        )
        for reason, n in sorted(d.stats.docs_snapshot().items()):
            docs.add_metric([reason], n)
        yield docs

        events = CounterMetricFamily(
            "foremast_degraded_events",
            "degradation events that are not per-document (claim "
            "errors survived, receiver overload sheds, replay flushes), "
            "by dependency edge and action",
            labels=["edge", "action"],
        )
        for (edge, action), n in sorted(d.stats.events_snapshot().items()):
            events.add_metric([edge, action], n)
        yield events
