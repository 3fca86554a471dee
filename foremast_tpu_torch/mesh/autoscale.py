"""Autoscaling driver: join and leave decisions from exported signals.

The port's copy of the JAX package's `foremast_tpu/mesh/autoscale.py`, a
pure decision component: it spawns and kills nothing. The operator feeds
it three saturation signals the observability plane exports and acts on
its verdicts:

  * tick occupancy: busy seconds per wall second of the worker loop;
  * write-queue peak: a store write path that cannot drain as fast as the
    judge produces;
  * ring budget pressure: resident ring bytes over
    `FOREMAST_INGEST_BUDGET_BYTES`.

A signal must breach its threshold for `breach_ticks` consecutive
observations before a verdict fires, and a `cooldown_seconds` window
after every verdict absorbs the rebalance transient (observations inside
it bank nothing). Scale-down needs EVERY signal low and never goes below
`min_workers`.
"""

from __future__ import annotations

import dataclasses
import os
import time

DECISION_UP = "scale_up"
DECISION_DOWN = "scale_down"
DECISION_HOLD = "hold"


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds and hysteresis (the FOREMAST_AUTOSCALE_* knobs)."""

    high_occupancy: float = 0.80
    low_occupancy: float = 0.30
    high_ring_pressure: float = 0.85
    high_write_queue: int = 8
    breach_ticks: int = 3
    cooldown_seconds: float = 120.0
    min_workers: int = 1
    max_workers: int = 64

    @staticmethod
    def from_env(env=None) -> "AutoscaleConfig":
        e = os.environ if env is None else env

        def f(name, default):
            return float(e.get(name, "") or default)

        return AutoscaleConfig(
            high_occupancy=f("FOREMAST_AUTOSCALE_HIGH_OCCUPANCY", 0.80),
            low_occupancy=f("FOREMAST_AUTOSCALE_LOW_OCCUPANCY", 0.30),
            high_ring_pressure=f("FOREMAST_AUTOSCALE_HIGH_RING_PRESSURE", 0.85),
            high_write_queue=int(f("FOREMAST_AUTOSCALE_HIGH_WRITE_QUEUE", 8)),
            breach_ticks=int(f("FOREMAST_AUTOSCALE_BREACH_TICKS", 3)),
            cooldown_seconds=f("FOREMAST_AUTOSCALE_COOLDOWN_SECONDS", 120.0),
            min_workers=int(f("FOREMAST_AUTOSCALE_MIN_WORKERS", 1)),
            max_workers=int(f("FOREMAST_AUTOSCALE_MAX_WORKERS", 64)),
        )


class AutoscaleDriver:
    """Consecutive-breach and cooldown state machine over the signals."""

    def __init__(self, config: AutoscaleConfig | None = None, clock=time.monotonic):
        self.config = config or AutoscaleConfig()
        self._clock = clock
        self._high_streak = 0
        self._low_streak = 0
        self._last_decision_at: float | None = None
        self.decisions = {DECISION_UP: 0, DECISION_DOWN: 0}
        self.last_signals: dict | None = None

    def _cooling(self, now: float) -> bool:
        return self._last_decision_at is not None and now - self._last_decision_at < self.config.cooldown_seconds

    def observe(self, occupancy: float, members: int, write_queue_peak: int = 0, ring_pressure: float = 0.0) -> str:
        """Feed one observation window; returns the verdict. `members` is
        the live worker count (it bounds both directions)."""
        cfg = self.config
        now = self._clock()
        self.last_signals = {
            "occupancy": round(float(occupancy), 4),
            "write_queue_peak": int(write_queue_peak),
            "ring_pressure": round(float(ring_pressure), 4),
            "members": int(members),
        }
        high = (
            occupancy >= cfg.high_occupancy
            or ring_pressure >= cfg.high_ring_pressure
            or write_queue_peak >= cfg.high_write_queue
        )
        low = (
            occupancy <= cfg.low_occupancy
            and ring_pressure < cfg.high_ring_pressure
            and write_queue_peak < cfg.high_write_queue
        )
        if self._cooling(now):
            # the window absorbs the transient a verdict itself causes: a
            # streak built inside it would fire the moment it ends
            self._high_streak = 0
            self._low_streak = 0
            return DECISION_HOLD
        self._high_streak = self._high_streak + 1 if high else 0
        self._low_streak = self._low_streak + 1 if low else 0
        if self._high_streak >= cfg.breach_ticks and members < cfg.max_workers:
            self._high_streak = 0
            self._last_decision_at = now
            self.decisions[DECISION_UP] += 1
            return DECISION_UP
        if self._low_streak >= cfg.breach_ticks and members > cfg.min_workers:
            self._low_streak = 0
            self._last_decision_at = now
            self.decisions[DECISION_DOWN] += 1
            return DECISION_DOWN
        return DECISION_HOLD

    def debug_state(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "high_streak": self._high_streak,
            "low_streak": self._low_streak,
            "cooling": self._cooling(self._clock()),
            "decisions": dict(self.decisions),
            "last_signals": self.last_signals,
        }
