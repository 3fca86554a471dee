"""Typed judgment configuration with the reference brain's env-var surface.

The port's own copy of the fields of `foremast_tpu/config.py` that the
scoring path and the worker read: the bound selectors, the pairwise
selectors, the per-metric-type threshold matrix
(`foremast-brain.yaml:26-73`), the engine knobs, the stuck-claim window
and the fit-cache size. `from_env()` reads the same variable names as the JAX
package, so one deployment's environment configures either engine.
`AnomalyConfig.gather` turns the per-metric-type table into dense `[B]`
operand vectors on the host, once per bucket.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

# Bound selectors: which side(s) of the band flag an anomaly
# (`ML_BOUND`, `foremast-brain/README.md:24`).
BOUND_UPPER = 1
BOUND_LOWER = 2
BOUND_BOTH = 3

# Pairwise algorithm selectors (`foremast-brain/README.md:34`).
PAIRWISE_ALL = "ALL"
PAIRWISE_ANY = "ANY"
PAIRWISE_MANN_WHITE = "MANN_WHITE"
PAIRWISE_WILCOXON = "WILCOXON"
PAIRWISE_KRUSKAL = "KRUSKAL"
PAIRWISE_FRIEDMAN = "FRIEDMAN"
PAIRWISE_CHOICES = (
    PAIRWISE_ALL,
    PAIRWISE_ANY,
    PAIRWISE_MANN_WHITE,
    PAIRWISE_WILCOXON,
    PAIRWISE_KRUSKAL,
    PAIRWISE_FRIEDMAN,
)

_BOUND_NAMES = {
    "upper": BOUND_UPPER,
    "lower": BOUND_LOWER,
    "both": BOUND_BOTH,
    "1": BOUND_UPPER,
    "2": BOUND_LOWER,
    "3": BOUND_BOTH,
}


def _parse_bound(raw: str | int) -> int:
    if isinstance(raw, int):
        if raw not in (BOUND_UPPER, BOUND_LOWER, BOUND_BOTH):
            raise ValueError(f"bound must be 1/2/3, got {raw}")
        return raw
    key = str(raw).strip().lower()
    if key not in _BOUND_NAMES:
        raise ValueError(f"unknown bound selector {raw!r}")
    return _BOUND_NAMES[key]


@dataclasses.dataclass(frozen=True)
class MetricTypeRule:
    """One row of the per-metric-type override matrix
    (`foremast-brain.yaml:32-73`)."""

    metric_type: str
    threshold: float
    bound: int = BOUND_UPPER
    min_lower_bound: float = 0.0


_DEFAULT_RULES = (
    MetricTypeRule("error5xx", 2.0, BOUND_UPPER, 0.0),
    MetricTypeRule("error4xx", 3.0, BOUND_UPPER, 0.0),
    MetricTypeRule("latency", 10.0, BOUND_BOTH, 0.0),
    MetricTypeRule("cpu", 5.0, BOUND_UPPER, 0.0),
    MetricTypeRule("memory", 5.0, BOUND_UPPER, 0.0),
)


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Global threshold params + per-metric-type override table."""

    threshold: float = 2.0  # `foremast-brain.yaml:26-27`
    min_lower_bound: float = 0.0  # `foremast-brain.yaml:28-29`
    bound: int = BOUND_UPPER  # `foremast-brain.yaml:30-31`
    rules: tuple[MetricTypeRule, ...] = _DEFAULT_RULES

    def rule_for(self, metric_type: str | None) -> MetricTypeRule:
        for r in self.rules:
            if r.metric_type == metric_type:
                return r
        return MetricTypeRule(
            metric_type or "", self.threshold, self.bound, self.min_lower_bound
        )

    def gather(
        self, metric_types: Sequence[str | None]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense (threshold[B], bound[B], min_lower_bound[B]) vectors for a
        batch of metric types — the scorer's per-row operands."""
        rules = [self.rule_for(t) for t in metric_types]
        return (
            np.asarray([r.threshold for r in rules], dtype=np.float32),
            np.asarray([r.bound for r in rules], dtype=np.int32),
            np.asarray([r.min_lower_bound for r in rules], dtype=np.float32),
        )


@dataclasses.dataclass(frozen=True)
class PairwiseConfig:
    """Baseline-vs-current distribution-test selection and min-points
    gates (`foremast-brain.yaml:74-79`)."""

    algorithm: str = PAIRWISE_ALL
    threshold: float = 0.05  # p-value cutoff, `ML_PAIRWISE_THRESHOLD`
    min_mann_white_points: int = 20
    min_wilcoxon_points: int = 20
    min_kruskal_points: int = 5
    min_friedman_points: int = 20

    def __post_init__(self):
        if self.algorithm not in PAIRWISE_CHOICES:
            raise ValueError(f"unknown pairwise algorithm {self.algorithm!r}")


@dataclasses.dataclass(frozen=True)
class BrainConfig:
    """Judgment config — env parity with `foremast-brain.yaml:21-81` for
    the fields the scoring path reads."""

    algorithm: str = "moving_average_all"  # ML_ALGORITHM, yaml:24-25
    anomaly: AnomalyConfig = AnomalyConfig()
    pairwise: PairwiseConfig = PairwiseConfig()
    # season length in steps for the seasonal models: daily cycles at
    # the 60 s step of the 7-day history
    season_steps: int = 1440
    min_historical_points: int = 10  # MIN_HISTORICAL_DATA_POINT_TO_MEASURE
    max_stuck_seconds: float = 90.0  # MAX_STUCK_IN_SECONDS, yaml:80-81
    max_cache_size: int = 1000  # MAX_CACHE_SIZE model cache, README:30

    def fingerprint(self) -> str:
        """Stable short hash of the effective judgment config, so two
        workers' configs can be compared at a glance (`debug_state`)."""
        import hashlib

        return hashlib.sha256(repr(dataclasses.asdict(self)).encode()).hexdigest()[:12]

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None) -> "BrainConfig":
        """Build from the reference's env-var names, including the indexed
        `metric_type{i}` family (`foremast-brain.yaml:32-73`)."""
        e = dict(os.environ if env is None else env)

        def get(name: str, default):
            raw = e.get(name)
            if raw is None or raw == "":
                return default
            if isinstance(default, int):
                return int(raw)
            if isinstance(default, float):
                return float(raw)
            return raw

        def geti(name: str, i: int, default):
            """`name{i}`, then the global `name`, then the default; empty
            strings count as unset."""
            for key in (f"{name}{i}", name):
                raw = e.get(key)
                if raw is not None and raw != "":
                    return raw
            return default

        n_rules = int(e.get("metric_type_threshold_count", "0") or 0)
        rules: list[MetricTypeRule] = []
        for i in range(n_rules):
            mt = e.get(f"metric_type{i}")
            if not mt:
                continue
            rules.append(
                MetricTypeRule(
                    metric_type=mt,
                    threshold=float(geti("threshold", i, 2.0)),
                    bound=_parse_bound(geti("bound", i, 1)),
                    min_lower_bound=float(geti("min_lower_bound", i, 0.0)),
                )
            )
        raw_bound = e.get("ML_BOUND") or e.get("bound") or 1  # "" is unset
        anomaly = AnomalyConfig(
            threshold=get("ML_THRESHOLD", get("threshold", 2.0)),
            min_lower_bound=get("min_lower_bound", 0.0),
            bound=_parse_bound(raw_bound),
            rules=tuple(rules) if rules else _DEFAULT_RULES,
        )
        pairwise = PairwiseConfig(
            algorithm=get("ML_PAIRWISE_ALGORITHM", PAIRWISE_ALL).upper(),
            threshold=get("ML_PAIRWISE_THRESHOLD", 0.05),
            min_mann_white_points=get("MIN_MANN_WHITE_DATA_POINTS", 20),
            min_wilcoxon_points=get("MIN_WILCOXON_DATA_POINTS", 20),
            min_kruskal_points=get("MIN_KRUSKAL_DATA_POINTS", 5),
            min_friedman_points=get("MIN_FRIEDMAN_DATA_POINTS", 20),
        )
        return BrainConfig(
            algorithm=get("ML_ALGORITHM", "moving_average_all"),
            anomaly=anomaly,
            pairwise=pairwise,
            season_steps=get("ML_SEASON_STEPS", 1440),
            min_historical_points=get("MIN_HISTORICAL_DATA_POINT_TO_MEASURE", 10),
            max_stuck_seconds=get("MAX_STUCK_IN_SECONDS", 90.0),
            max_cache_size=get("MAX_CACHE_SIZE", 1000),
        )
