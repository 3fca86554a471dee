"""Anomaly-join and panel shaping — server-side, pure, tested.

The port's copy of the JAX package's `foremast_tpu/ui/join.py`.

The reference UI joins anomaly timestamps onto the base series in the
browser (`foremast-browser/src/App.js:231-260`) so anomalies plot as dots
on the measured curve. Round 1 kept that in client JS, which left the one
piece of real logic in the dashboard unexecuted by any test (no JS
runtime in CI). It now lives here: the UI server's `/api/v1/panel`
endpoint fetches a panel's four series, scales them, and joins anomalies
in Python; `static/app.js` only renders what it is given.

Join semantics (matching the engine's gauge behavior): the
`foremastbrain:<metric>_anomaly` gauge is sticky — it holds the *last*
anomalous value and is never cleared — so the raw series repeats the value
at every scrape after an anomaly. An anomaly *event* is where the series
appears or its value changes; a series already present at the window's
left edge is an old sticky value, not an event inside this window. Events
are then joined onto base-series timestamps and plotted at the *measured*
value.
"""

from __future__ import annotations

Point = tuple[float, float]  # (unix seconds, value)

_UNSET = object()


def anomaly_events(
    anomaly: list[Point], start: float, step: float
) -> list[Point]:
    """Sticky-gauge series -> the anomaly events inside this window."""
    events: list[Point] = []
    prev: object = _UNSET
    for t, v in anomaly:
        at_left_edge = prev is _UNSET and t <= start + step
        if (prev is _UNSET and not at_left_edge) or (
            prev is not _UNSET and v != prev
        ):
            events.append((t, v))
        prev = v
    return events


def join_anomalies(
    base: list[Point], anomaly: list[Point], start: float, step: float
) -> list[Point]:
    """Anomaly events joined onto base timestamps, at the MEASURED value
    (the dot must land on the plotted curve, reference App.js:231-260)."""
    base_by_t = {t: v for t, v in base}
    return [
        (t, base_by_t[t])
        for t, _ in anomaly_events(anomaly, start, step)
        if t in base_by_t
    ]


def panel_payload(
    by_type: dict[str, list[Point]], scale: float, start: float, step: float
) -> dict:
    """The full per-panel data blob the dashboard renders: scaled series
    plus the anomaly join. Keys mirror what app.js previously computed."""
    scaled = {
        k: [{"t": t, "v": v * scale} for t, v in series]
        for k, series in by_type.items()
    }
    joined = join_anomalies(
        by_type.get("base", []), by_type.get("anomaly", []), start, step
    )
    scaled["anomalyJoined"] = [{"t": t, "v": v * scale} for t, v in joined]
    return scaled
