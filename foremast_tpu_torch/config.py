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


# ---------------------------------------------------------------------------
# The env-var registry: the ENTIRE configuration surface, enumerable.
# ---------------------------------------------------------------------------
#
# Every environment variable any foremast_tpu_torch module reads is
# declared here: `analysis.env_contract.env_findings` flags an
# undeclared or computed read (a tier-1 test runs it over the package),
# and the knob table in the README's port section is rendered from this
# registry (`env_contract.env_table()`, kept current by a test). A knob
# the JAX package also registers keeps its name, default, kind and
# group there, so one deployment's environment reads the same on both.
#
# The JAX package's knobs the port never reads are left out:
# FOREMAST_PALLAS (the fused Pallas judgment), FOREMAST_COMPILE_CACHE_DIR
# (XLA's compilation cache) and FOREMAST_BENCH_ROUND (its benchmark
# reports). FOREMAST_RECOMPILE_WITNESS stays: the CLI reads it to refuse
# the mode it asks for. Pod mode's rendezvous keeps the JAX package's
# JAX_* names, which the port reads itself (`parallel.mesh.init_distributed`).
#
# `name` may be an indexed pattern (`metric_type{i}`) for the
# reference's per-metric-type override family — those are only ever
# read through config.from_env, so the checker never needs to match
# them literally.


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One declared environment variable: the unit of config surface."""

    name: str
    default: str | None
    kind: str  # "str" | "int" | "float" | "bool" | "path" | "indexed"
    description: str
    group: str = "framework"  # "engine" | "framework" | "deploy"


ENV_KNOBS: tuple[EnvKnob, ...] = (
    # -- engine (reference parity: foremast-brain.yaml:21-81 + README:20-38)
    EnvKnob(
        "ES_ENDPOINT",
        "http://localhost:9200",
        "str",
        "Elasticsearch job store, engine spelling (in-memory if unset "
        "and no `ELASTIC_URL`)",
        "engine",
    ),
    EnvKnob(
        "ML_ALGORITHM",
        "moving_average_all",
        "str",
        "also: moving_average, ewma, double_exponential_smoothing, "
        "holt_winters, phase_means (pooled per-phase means — the "
        "daily-season workhorse), seasonal, prophet, `auto_univariate` "
        "(per-series structure screen over {mean, HW or phase_means by "
        "season length, Fourier seasonal} — recommended for unknown "
        "metric mixes), `auto`, `bivariate_normal`, `lstm_autoencoder` "
        "(hybrid: AE + seasonal-residual Gaussian)",
        "engine",
    ),
    EnvKnob(
        "ML_THRESHOLD",
        "2.0",
        "float",
        "global sigma multiplier (reference alias: `threshold`)",
        "engine",
    ),
    EnvKnob(
        "threshold",
        "2.0",
        "float",
        "reference spelling of `ML_THRESHOLD`",
        "engine",
    ),
    EnvKnob(
        "ML_BOUND",
        "1",
        "int",
        "1=upper, 2=lower, 3=both (reference alias: `bound`)",
        "engine",
    ),
    EnvKnob("bound", "1", "int", "reference spelling of `ML_BOUND`", "engine"),
    EnvKnob("min_lower_bound", "0", "float", "lower-bound floor", "engine"),
    EnvKnob(
        "metric_type_threshold_count",
        "0",
        "int",
        "row count of the per-metric-type override table",
        "engine",
    ),
    EnvKnob(
        "metric_type{i}",
        None,
        "indexed",
        "with `threshold{i}`/`bound{i}`/`min_lower_bound{i}`: "
        "per-metric-type override rows (deployed defaults: error5xx 2/1, "
        "error4xx 3/1, latency 10/3, cpu 5/1, memory 5/1)",
        "engine",
    ),
    EnvKnob(
        "ML_PAIRWISE_ALGORITHM",
        "ALL",
        "str",
        "ALL | ANY | MANN_WHITE | WILCOXON | KRUSKAL | FRIEDMAN (the "
        "reference design doc's fourth algorithm, two-group special case)",
        "engine",
    ),
    EnvKnob(
        "ML_PAIRWISE_THRESHOLD", "0.05", "float", "pairwise p threshold", "engine"
    ),
    EnvKnob(
        "MIN_MANN_WHITE_DATA_POINTS",
        "20",
        "int",
        "Mann-Whitney min-points gate",
        "engine",
    ),
    EnvKnob(
        "MIN_WILCOXON_DATA_POINTS",
        "20",
        "int",
        "Wilcoxon min-points gate",
        "engine",
    ),
    EnvKnob(
        "MIN_KRUSKAL_DATA_POINTS",
        "5",
        "int",
        "Kruskal-Wallis min-points gate",
        "engine",
    ),
    EnvKnob(
        "MIN_FRIEDMAN_DATA_POINTS",
        "20",
        "int",
        "Friedman min-points gate",
        "engine",
    ),
    EnvKnob(
        "ML_SEASON_STEPS",
        "1440",
        "int",
        "season length in steps for every seasonal model (HW, Fourier "
        "seasonal, residual-MVN, the auto screen); 1440 = daily at the "
        "60 s PromQL step. Histories under 2 cycles keep the mean model "
        "(identifiability guard). Routing note (deliberate): an EXPLICIT "
        "`ML_ALGORITHM=holt_winters` is honored as configured even at "
        "m=1440, where its rolled scan makes cold fits slower than "
        "`phase_means` — silently rewriting an operator's "
        "explicit algorithm choice would make config behavior "
        "unpredictable. For daily seasons prefer `auto_univariate` "
        "(which routes long seasons to the pooled phase-means fit "
        "itself) or set `phase_means` directly",
        "engine",
    ),
    EnvKnob(
        "MIN_HISTORICAL_DATA_POINT_TO_MEASURE",
        "10",
        "int",
        "measurability gate",
        "engine",
    ),
    EnvKnob(
        "MAX_STUCK_IN_SECONDS", "90", "float", "work-stealing takeover", "engine"
    ),
    EnvKnob("MAX_CACHE_SIZE", "1000", "int", "fitted-model LRU size", "engine"),
    # -- framework-specific
    EnvKnob(
        "ELASTIC_URL",
        None,
        "str",
        "Elasticsearch job store, service spelling (falls back to "
        "`ES_ENDPOINT`; in-memory when both unset)",
    ),
    EnvKnob(
        "FOREMAST_NATIVE",
        "1",
        "bool",
        "`0` disables the C++ data loader (pure Python)",
    ),
    EnvKnob(
        "FOREMAST_LSTM_STEPS",
        "60",
        "int",
        "LSTM-AE train steps per new model",
    ),
    EnvKnob(
        "FOREMAST_CLAIM_LIMIT",
        "256",
        "int",
        "jobs claimed per tick (`worker --claim-limit`); the whole claim "
        "scores as one batched program",
    ),
    EnvKnob(
        "FOREMAST_JOINT_COLUMNAR",
        "1",
        "bool",
        "default `1`: warm joint (multi-alias bivariate / LSTM-hybrid) "
        "docs ride the columnar fast tick from arena-resident model "
        "state, the same path univariate re-checks use. `0` routes every "
        "joint doc through the per-task object path",
    ),
    EnvKnob(
        "FOREMAST_CANARY_COLUMNAR",
        "1",
        "bool",
        "default `1`: warm BASELINE-carrying univariate docs (the "
        "canary/continuous strategies) ride the columnar fast tick as "
        "their own bucket — baseline windows fill a second [B, Tc] "
        "buffer judged by a pairwise-active variant of the program "
        "(Mann-Whitney/Wilcoxon/Kruskal/Friedman batched over the "
        "buffer). `0` routes every baseline-carrying doc through the "
        "per-task object path",
    ),
    EnvKnob(
        "FOREMAST_COLD_CHUNK_DOCS",
        "1024",
        "int",
        "slow-path doc-chunk size: cold claim sets run "
        "fetch→fit→judge→write per chunk, bounding time-to-first-verdict "
        "by one chunk's work",
    ),
    EnvKnob(
        "FOREMAST_PIPELINE_DEPTH",
        "2",
        "int",
        "slow-path tick-pipeline depth: prefetch runs depth-1 chunks "
        "ahead of the device and the write queue holds at most depth "
        "judged chunks (peak residency ~2×depth chunks across the "
        "fetch / judge / write-back stages). `1` = fully serial. "
        "Sources declaring "
        "`concurrent_fetch = False` (in-memory sources) always "
        "degrade to serial",
    ),
    EnvKnob(
        "FOREMAST_FETCH_WORKERS",
        "16",
        "int",
        "persistent per-worker metric-fetch thread pool size (per-doc "
        "query_range fan-out within a chunk; one pool per worker "
        "process, reused across ticks)",
    ),
    EnvKnob(
        "FOREMAST_ARENA_BYTES",
        "268435456",
        "int",
        "soft device-memory budget for the state arena (default 256 MB; `0` "
        "disables the arena). The arena AUTO-GROWS past this when the "
        "fleet's working set needs more rows — one warning log per "
        "growth — because an LRU arena smaller than the working set "
        "would re-upload the whole fleet's state every tick. Sizing "
        "rule: rows = services × metrics-per-job; bytes/row = 20 + 4 × "
        "`ML_SEASON_STEPS` (daily m=1440 ⇒ ~5.8 KB/row, so a "
        "16k-service × 4-metric daily fleet needs ~378 MB; "
        "engine.arena.set_arena_budget)",
    ),
    EnvKnob(
        "FOREMAST_ARENA_MAX_BYTES",
        "2147483648",
        "int",
        "hard arena ceiling (default 2 GB ≈ 2.5% of an H100's 80 GB). "
        "Batches that cannot fit even here fall back to a per-tick full "
        "state restack — counted in "
        "`foremast_worker_arena_events_total{event=\"fallbacks\"}` and "
        "logged, never silent",
    ),
    EnvKnob(
        "FOREMAST_DEVICE_MESH",
        "auto",
        "str",
        "device mesh the worker's judge partitions over: "
        "`auto` (default) = all local devices on the data axis — a "
        "1-device resolution IS the plain single-device judge, so "
        "stock CPU hosts are unaffected; `0`/`off` disables mesh "
        "placement entirely; `N` puts N devices on the data axis; "
        "`NxM` is an explicit (data, model) grid. The warm columnar "
        "paths (univariate + joint from-rows) shard their batch "
        "leading axis over `data` with state-arena ROW SPACE "
        "block-sharded over the same axis by default ("
        "aggregate capacity = per-device budget × devices, accounted "
        "on `/debug/state device_mesh`; set FOREMAST_ARENA_SHARDED=0 "
        "to replicate instead). Malformed values warn and fall "
        "back to `auto`. `--sharded` spans every local card "
        "instead and ignores this knob",
    ),
    EnvKnob(
        "FOREMAST_ARENA_SHARDED",
        "1",
        "int",
        "shard the device state arenas' row space over the mesh data "
        "axis (default on): each device holds only its "
        "block of rows — placement tied to batch position, so warm "
        "gathers stay device-local with zero cross-card transfer — "
        "and the per-device FOREMAST_ARENA_BYTES budget buys "
        "devices× aggregate rows instead of one replica per card. "
        "`0` restores the replicated layout. Ignored (forced "
        "replicated) on a 1-device judge",
    ),
    EnvKnob(
        "FOREMAST_DEVICE_MESH_MODEL",
        "1",
        "int",
        "model-axis width for `FOREMAST_DEVICE_MESH=auto`/`N` "
        "spellings (tensor parallelism for the learned detectors; the "
        "`NxM` spelling overrides this). Must stay inside one host — "
        "see parallel/mesh.py make_global_mesh",
    ),
    EnvKnob(
        "FOREMAST_BF16_DELTA",
        "1",
        "bool",
        "default `1`: histories travel/reside as f32 anchor + bf16 "
        "deltas (2 B/point, half of f32's host-to-device bytes on the "
        "steady-state and cold-tick/churn copies; moments shortcut for "
        "the deployed default, in-program reconstruction for seasonal fits); verdict "
        "parity, low-CV band geometry, and m=1440 seasonal fidelity are "
        "test-pinned. `0` restores full-f32 handling "
        "(engine.scoring.set_bf16_delta)",
    ),
    EnvKnob(
        "FOREMAST_FETCH_RETRIES",
        "2",
        "int",
        "transient-failure retries per metric fetch (HTTP 429/5xx and "
        "connection errors), with exponential jittered backoff; `0` "
        "restores fail-on-first-error. A retry budget is per URL, so a "
        "doc's preprocess stage survives one flaky round trip instead "
        "of failing the whole document",
    ),
    EnvKnob(
        "FOREMAST_INGEST",
        "0",
        "bool",
        "`1` mounts the push-based ingest plane (docs/operations.md "
        "\"Ingest plane\"): a remote-write receiver feeding a sharded "
        "in-memory ring TSDB, with the worker's fetches served from "
        "resident series and falling back to Prometheus on cold miss",
    ),
    EnvKnob(
        "FOREMAST_INGEST_PORT",
        "9009",
        "int",
        "ingest receiver port (POST /api/v1/write, JSON remote-write "
        "style); `0` disables the HTTP receiver — the ring then only "
        "fills through backfill and the direct push API",
    ),
    EnvKnob(
        "FOREMAST_INGEST_BUDGET_BYTES",
        "268435456",
        "int",
        "resident-series byte budget for the ring TSDB (default "
        "256 MB), split evenly across shards; past it, "
        "least-recently-used series are evicted whole (they re-warm "
        "via the cold-miss fallback). Sizing rule: 12 B/point at pow2 "
        "capacities — a full 7-day 60 s history rounds to 16,384 "
        "points ≈ 192 KB/series",
    ),
    EnvKnob(
        "FOREMAST_INGEST_SHARDS",
        "8",
        "int",
        "ring TSDB shard count — receiver push threads, tick fetches "
        "and scrapes contend on 1/N of the keyspace per lock",
    ),
    EnvKnob(
        "FOREMAST_INGEST_STALE_SECONDS",
        "300",
        "float",
        "staleness watermark: a fetch is only served from the ring "
        "when the newest resident sample is within this many seconds "
        "of the requested window head — a dead pusher degrades to the "
        "pull path instead of freezing verdicts",
    ),
    EnvKnob(
        "FOREMAST_INGEST_MAX_POINTS",
        "16384",
        "int",
        "per-series ring capacity ceiling (pow2-rounded); older "
        "samples are overwritten past it",
    ),
    EnvKnob(
        "FOREMAST_INGEST_MAX_BODY_BYTES",
        "8388608",
        "int",
        "ingest receiver request-body cap (default 8 MiB): pushes "
        "whose Content-Length exceeds it answer 413 before any byte "
        "is buffered or parsed, so one oversized pusher cannot wedge "
        "a handler thread or balloon the heap",
    ),
    EnvKnob(
        "FOREMAST_ADMIT_MIN_COVERAGE_SECONDS",
        "86400",
        "float",
        "short-history admission floor (docs/operations.md \"Cold "
        "start & churn\"): in PURE-PUSH mode (no fallback source) a "
        "newcomer series whose live ring-coverage span holds at least "
        "this many seconds of fresh data gets a verdict-capable "
        "PROVISIONAL fit from the resident columns in its first tick, "
        "refined toward the full 7-day fit in the background as "
        "coverage grows; below the floor the fetch stays UNKNOWN. "
        "With a fallback configured the floor is inert — an uncovered "
        "window start keeps degrading to the fallback, which may hold "
        "the full history the ring lost. `0` disables partial "
        "admission entirely",
    ),
    EnvKnob(
        "FOREMAST_REFINE_DOCS_PER_TICK",
        "256",
        "int",
        "background-refinement budget: at most this many provisional "
        "fits are upgraded (invalidated for refit from the grown ring "
        "window) per idle or all-warm tick — bounds the next tick's "
        "slow-path refit batch. Refits pace geometrically (~1.5x more "
        "points each), so a fit refines O(log) times on its way from "
        "the admission floor to the full window; `0` parks provisional "
        "fits at their admitted history",
    ),
    EnvKnob(
        "FOREMAST_MICROTICK_SECONDS",
        "0",
        "float",
        "reactive plane pacing (docs/operations.md \"Event-driven "
        "detection\"): > 0 turns the worker's idle wait between full "
        "ticks into the micro-tick drain window — every this-many "
        "seconds the worker claims and judges JUST the documents whose "
        "series the receiver marked dirty since the last drain, so a "
        "pushed anomaly meets its verdict in ~this + judge time "
        "instead of waiting out the poll; full ticks demote to sweeps "
        "on the poll cadence. `0` (default) = tick-paced detection. "
        "Requires FOREMAST_INGEST=1 "
        "(the receiver is what marks arrivals)",
    ),
    EnvKnob(
        "FOREMAST_MICROTICK_DOCS",
        "256",
        "int",
        "dirty route keys drained per micro-tick: bounds one "
        "micro-tick's claim scope (the claim itself stays bounded by "
        "--claim-limit); keys past the budget wait for the next "
        "micro-tick or sweep",
    ),
    EnvKnob(
        "FOREMAST_SWEEP_SLICE_DOCS",
        "2048",
        "int",
        "sliced, preemptible sweeps (docs/operations.md "
        "\"Event-driven detection\"): a full sweep whose claim exceeds "
        "this many docs runs as bounded SLICES through the warm-path "
        "pipeline — the prefetch thread packs slice N+1 while the "
        "device runs slice N and the writer decodes + bulk-writes "
        "slice N-1 — with a dirty-drain preemption point at every "
        "slice boundary, so pushed-anomaly p99 is bounded by one "
        "slice's wall clock instead of the sweep's. `0` = monolithic "
        "ticks. "
        "Smaller slices tighten the latency bound and cost more "
        "per-dispatch overhead; see the slice-size tuning guidance",
    ),
    EnvKnob(
        "FOREMAST_MICROTICK_DIRTY_MAX",
        "8192",
        "int",
        "dirty-set capacity (route keys): past it the OLDEST pending "
        "arrival drops, counted on "
        "foremast_microtick_dirty_events{event=\"dropped\"} — the full "
        "sweep still judges those documents on its own cadence, so "
        "overflow degrades latency attribution, never correctness "
        "(bounded by construction, never a leak)",
    ),
    EnvKnob(
        "FOREMAST_WATCH_STREAM",
        "0",
        "bool",
        "`1` switches the watch plane's deployment informer to the "
        "streaming `watch=true` long-poll (resourceVersion resume, "
        "410-Gone re-list, stall detection): deployment events "
        "dispatch on ARRIVAL and the 30 s resync demotes to a repair "
        "sweep. `0` keeps the list+diff poll informer",
    ),
    EnvKnob(
        "FOREMAST_SNAPSHOT_DIR",
        None,
        "path",
        "durable data-plane directory (docs/operations.md \"Restarts "
        "and upgrades\"): ring shard snapshots + append logs, "
        "write-through fit journals, and the worker's persistent mesh "
        "identity all live here, so a SIGKILLed or upgraded worker "
        "restarts WARM — next tick ≥ 90% fast-path with zero fallback "
        "HTTP fetches — instead of re-fetching 7-day histories for the "
        "whole fleet. Unset = ephemeral",
    ),
    EnvKnob(
        "FOREMAST_SNAPSHOT_INTERVAL_SECONDS",
        "60",
        "float",
        "ring snapshot cadence: a full shard snapshot pass at most this "
        "often (append logs cover the gap between passes, so crash "
        "recency is bounded by log flush — every push — not by this)",
    ),
    EnvKnob(
        "FOREMAST_SNAPSHOT_MAX_AGE_SECONDS",
        "86400",
        "float",
        "restore age cutoff: a restored series whose coverage head is "
        "older than this is discarded (counted on "
        "`foremast_snapshot_discards{reason=\"stale\"}`) and cold-fits "
        "through the fallback instead — yesterday's ring must not "
        "shadow a fleet that moved on",
    ),
    EnvKnob(
        "FOREMAST_SNAPSHOT_LOG_MAX_BYTES",
        "67108864",
        "int",
        "per-shard append-log budget (default 64 MiB): a log past it "
        "forces a snapshot pass (fit journals compact at 8 MiB), "
        "bounding restart replay time",
    ),
    EnvKnob(
        "FOREMAST_CHAOS_PLAN",
        None,
        "str",
        "deterministic fault-injection plan (docs/operations.md "
        "\"Failure modes & degradation\"): inline JSON or `@path` to a "
        "JSON file — seeded rules injecting latency / error-rate / "
        "blackhole / clock-skew faults into each dependency edge "
        "(prometheus, store, kube, receiver, pusher, transfer, clock). "
        "UNSET in "
        "production: every injection seam is then a pass-through "
        "attribute check. Test/soak tooling only",
    ),
    EnvKnob(
        "FOREMAST_BREAKER_FAILURES",
        "5",
        "int",
        "circuit breaker: consecutive transient failures (connection/"
        "timeout errors, HTTP 429/5xx) on one dependency edge before "
        "its breaker opens and further calls fail fast (BreakerOpen) "
        "instead of stalling on timeouts",
    ),
    EnvKnob(
        "FOREMAST_BREAKER_OPEN_SECONDS",
        "10",
        "float",
        "circuit breaker: open-state cooldown before ONE half-open "
        "probe call is allowed through; probe success re-closes, "
        "failure re-opens with a fresh cooldown",
    ),
    EnvKnob(
        "FOREMAST_TICK_BUDGET_SECONDS",
        "0",
        "float",
        "per-tick deadline (0 = unbounded): docs whose fetch/judge "
        "turn comes after the budget are RELEASED un-judged — status "
        "back to preprocess_completed, claimable next tick, counted on "
        "`foremast_degraded_docs{reason=\"deadline_released\"}` — so "
        "one slow dependency bounds tick latency instead of wedging "
        "the whole claim behind it",
    ),
    EnvKnob(
        "FOREMAST_WRITE_BEHIND_DOCS",
        "65536",
        "int",
        "write-behind buffer entry cap: verdicts whose store write "
        "failed transiently buffer locally and replay when the store "
        "heals; past the cap the OLDEST entries drop (counted). "
        "Entries aging past MAX_STUCK_IN_SECONDS always drop — past "
        "the stuck window a peer's claim-CAS takeover owns the doc, "
        "and a late replay would double-write its verdict",
    ),
    EnvKnob(
        "FOREMAST_INGEST_MAX_INFLIGHT",
        "64",
        "int",
        "ingest receiver overload shedding: concurrent push handlers "
        "allowed before a push is answered 429 + Retry-After BEFORE "
        "its body is read (pushers retry-then-buffer client-side); "
        "`0` disables shedding",
    ),
    EnvKnob(
        "FOREMAST_INGEST_DECODE_WORKERS",
        "4",
        "int",
        "pooled decode worker threads on the ingest receiver "
        "(docs/wire-protocol.md): handler threads do socket I/O only "
        "while decompress/decode/apply run on this many pool threads, "
        "bounding decode CPU however many pusher connections pile up; "
        "a full decode queue sheds 429. `0` decodes inline on the "
        "handler thread",
    ),
    EnvKnob(
        "FOREMAST_INGEST_MAX_DECODED_BYTES",
        "33554432",
        "int",
        "decoded-size ceiling for the binary wire path (default "
        "32 MiB): the DECLARED size in the snappy preamble / FMW1 "
        "frame header past it answers 413 before the body is read or "
        "decompressed — the snappy-bomb mirror of "
        "FOREMAST_INGEST_MAX_BODY_BYTES's no-buffering contract",
    ),
    EnvKnob(
        "FOREMAST_ES_CONNECT_DEADLINE_SECONDS",
        "0",
        "float",
        "bound on the Elasticsearch connect-retry loop at startup "
        "(`0` = the reference's forever-retry): past it the worker "
        "exits loudly with the retry state instead of waiting "
        "invisibly; the retry progress is always surfaced on "
        "`/debug/state` `store_connect`",
    ),
    EnvKnob(
        "FOREMAST_KUBE_TIMEOUT_SECONDS",
        "30",
        "float",
        "per-request socket timeout for the in-cluster K8s API client "
        "(HttpKube; applies to connect and read). Transient API-server "
        "failures (429/5xx, connection errors) retry under "
        "FOREMAST_FETCH_RETRIES with jittered backoff; hard 4xx fails "
        "fast",
    ),
    EnvKnob(
        "FOREMAST_MESH",
        "0",
        "bool",
        "`1` joins the worker mesh (docs/operations.md \"Worker "
        "mesh\"): this worker registers a membership lease in the job "
        "store, claims only the fleet partition a consistent-hash "
        "ring assigns it, and (with `FOREMAST_INGEST=1`) answers "
        "pushes for series another member owns with that member's "
        "advertised receiver address",
    ),
    EnvKnob(
        "FOREMAST_MESH_LEASE_SECONDS",
        "15",
        "float",
        "membership lease: renewed every third of this, and a member "
        "whose record is older than this (by the reader's clock) is "
        "treated as dead — the ring heals around it and its in-flight "
        "claims age out via MAX_STUCK_IN_SECONDS takeover. Keep it "
        "comfortably above the tick poll interval and below the stuck "
        "window",
    ),
    EnvKnob(
        "FOREMAST_MESH_REPLICAS",
        "64",
        "int",
        "consistent-hash virtual nodes per unit of member capacity — "
        "higher evens out partition sizes at the cost of ring-build "
        "time on rebalance (64 keeps the largest/smallest partition "
        "spread under ~20% at 4 members)",
    ),
    EnvKnob(
        "FOREMAST_MESH_ROUTE_LABEL",
        "app",
        "str",
        "the series label whose value is the partition identity: a "
        "pushed series carrying it hashes to the SAME member as the "
        "documents of that application (doc route key = appName). "
        "Series without the label hash by whole canonical key and may "
        "land off-worker — their fetches degrade to the cold-miss "
        "fallback, never to wrong answers",
    ),
    EnvKnob(
        "FOREMAST_MESH_ADVERTISE",
        None,
        "str",
        "host (or host:port) peers and pushers should use to reach "
        "this worker's ingest receiver; default advertises the local "
        "hostname with the receiver's actual bound port",
    ),
    EnvKnob(
        "FOREMAST_HANDOFF",
        "1",
        "bool",
        "default `1` (mesh + ingest mode): planned membership changes "
        "move state instead of refitting it (docs/operations.md "
        "\"Elastic scaling\") — a joining worker registers FENCED and "
        "receives its partition's ring series + fit entries from the "
        "current owners before claiming; a draining worker streams its "
        "state to the post-drain owners before leaving; SIGTERM on a "
        "mesh worker drains instead of just leaving. `0` restores the "
        "cold-refit behavior (every partition move refits)",
    ),
    EnvKnob(
        "FOREMAST_HANDOFF_DEADLINE_SECONDS",
        "30",
        "float",
        "planned-handoff fence bound: a joining worker waits at most "
        "this long for the current owners' transfer `done` markers "
        "before activating anyway — a torn, blackholed, or crashed "
        "transfer degrades the moved state to cold refits (counted on "
        "`foremast_handoff_transfers`), never a parked joiner. Also "
        "bounds (2x) how long transferred-in series are protected from "
        "the rebalance eviction pass",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_HIGH_OCCUPANCY",
        "0.8",
        "float",
        "autoscale driver (mesh/autoscale.py): tick occupancy (busy "
        "seconds per wall second) at or above this is a scale-up "
        "breach signal",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_LOW_OCCUPANCY",
        "0.3",
        "float",
        "autoscale driver: occupancy at or below this (with every "
        "other signal quiet) is a scale-down breach signal",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_HIGH_RING_PRESSURE",
        "0.85",
        "float",
        "autoscale driver: resident ring bytes over "
        "FOREMAST_INGEST_BUDGET_BYTES at or above this fraction is a "
        "scale-up breach signal (eviction pressure turns warm fetches "
        "back into fallback fetches)",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_HIGH_WRITE_QUEUE",
        "8",
        "int",
        "autoscale driver: a slow-path write-queue peak at or above "
        "this is a scale-up breach signal",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_BREACH_TICKS",
        "3",
        "int",
        "autoscale driver hysteresis: a signal must breach for this "
        "many CONSECUTIVE observations before a verdict fires",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_COOLDOWN_SECONDS",
        "120",
        "float",
        "autoscale driver hysteresis: no verdict within this window of "
        "the previous one — the rebalance transient a scale event "
        "itself causes must not trigger the next one",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_MIN_WORKERS",
        "1",
        "int",
        "autoscale driver: scale-down floor",
    ),
    EnvKnob(
        "FOREMAST_AUTOSCALE_MAX_WORKERS",
        "64",
        "int",
        "autoscale driver: scale-up ceiling",
    ),
    EnvKnob(
        "FOREMAST_MAX_GAUGE_FAMILIES",
        "512",
        "int",
        "gauge-family cap: past it, publishes for NEW metric names are "
        "dropped (counted on "
        "`foremastbrain_gauge_families_dropped_total`, warned once)",
    ),
    EnvKnob(
        "FOREMAST_TRACE_DIR",
        None,
        "path",
        "directory for Perfetto-loadable span ring-buffer dumps; unset "
        "disables the buffer (stage histograms stay on)",
    ),
    EnvKnob(
        "FOREMAST_PROFILE",
        None,
        "path",
        "directory for `torch.profiler` Chrome traces: one per worker "
        "sweep and one per `observe.profile.trace_scoring` region; "
        "unset disables them",
    ),
    EnvKnob(
        "FOREMAST_LOCK_WITNESS",
        None,
        "bool",
        "`1` wraps this package's locks to record real acquisition "
        "order (one list append per acquire) and logs at exit any "
        "edge missing from the committed `analysis_lockgraph_torch.json` "
        "— the static lock-order model's runtime witness "
        "(`analysis/witness.py`)",
    ),
    EnvKnob(
        "FOREMAST_RECOMPILE_WITNESS",
        None,
        "bool",
        "the JAX package's XLA recompile counter; the port has no "
        "traced programs, so its CLI refuses `1`",
    ),
    EnvKnob(
        "FOREMAST_SERVICE_ENDPOINT",
        "http://localhost:8099",
        "str",
        "browser-reachable job-gateway URL for the UI",
    ),
    EnvKnob(
        "QUERY_SERVICE_ENDPOINT",
        None,
        "str",
        "Prometheus base for the service's query proxy",
    ),
    EnvKnob(
        "FOREMAST_UI_NAMESPACE",
        "foremast-examples",
        "str",
        "dashboard's charted namespace label",
    ),
    EnvKnob("FOREMAST_UI_APP", "demo", "str", "dashboard's charted app label"),
    # -- multi-tenant QoS plane
    EnvKnob(
        "FOREMAST_TENANTS",
        None,
        "str",
        "tenant spec map as inline JSON or `@/path/to/file.json` "
        "(FOREMAST_CHAOS_PLAN-style): `{name: {weight, ring_bytes, "
        "arena_rows, ingest_bytes_per_s, burst_bytes}}` (or wrapped "
        "under a top-level `tenants` key); 0/omitted fields mean no "
        "envelope. Unset or a single tenant keeps every scheduling "
        "and eviction path byte-identical to the untenanted worker; "
        ">=2 tenants turns on weighted-fair claim ordering, "
        "per-tenant ingest admission and budget-envelope eviction. "
        "Malformed JSON raises at startup",
    ),
    EnvKnob(
        "FOREMAST_TENANT_LABEL",
        "tenant",
        "str",
        "series/doc label the tenant is resolved from (canonical "
        "selector label on pushed series, URL-encoded matcher in doc "
        "query configs); series without it belong to `default`",
    ),
    EnvKnob(
        "FOREMAST_TENANT_LABEL_MAX",
        "64",
        "int",
        "cardinality cap for the `tenant` metric label: configured "
        "tenants always export under their own name; at most this "
        "many UNCONFIGURED observed values get label slots, the rest "
        "fold into `other` (BrainGauges-style, warned once)",
    ),
    # -- deployment / platform integration
    EnvKnob(
        "NAMESPACE",
        "default",
        "str",
        "fallback gauge namespace label; the watch plane's own namespace "
        "(downward-API parity)",
        "deploy",
    ),
    EnvKnob(
        "JAX_COORDINATOR_ADDRESS",
        None,
        "str",
        "pod mode's rendezvous (`host:port`, rank 0 listens there; a "
        "`tcp://` init of torch.distributed over gloo), with "
        "`JAX_NUM_PROCESSES` / `JAX_PROCESS_ID`; read by `worker --sharded`",
        "deploy",
    ),
    EnvKnob("JAX_NUM_PROCESSES", None, "int", "pod mode's world size (the number of processes)", "deploy"),
    EnvKnob(
        "FOREMAST_POD_TIMEOUT_SECONDS",
        "300",
        "float",
        "pod-mode collective watchdog: a broadcast that does not "
        "complete within this budget aborts the tick "
        "(PodCollectiveTimeout) so a follower never hangs on a dead "
        "leader — the in-flight claims age out via "
        "MAX_STUCK_IN_SECONDS takeover. `0` disables the watchdog",
        "deploy",
    ),
    EnvKnob("JAX_PROCESS_ID", None, "int", "pod mode's rank of this process (0 is the leader)", "deploy"),
    EnvKnob(
        "KUBERNETES_SERVICE_HOST",
        "kubernetes.default.svc",
        "str",
        "in-cluster API server (injected by the kubelet)",
        "deploy",
    ),
    EnvKnob(
        "KUBERNETES_SERVICE_PORT",
        "443",
        "str",
        "in-cluster API server port",
        "deploy",
    ),
    EnvKnob(
        "K8S_METRICS_COMMON_TAGS",
        None,
        "str",
        "instrument starter: comma-separated `key:value` tags stamped on "
        "every emitted metric",
        "deploy",
    ),
    EnvKnob(
        "APP_NAME",
        None,
        "str",
        "instrument starter: fallback `app` tag",
        "deploy",
    ),
    # -- the port's own: the build of its kernels and host library
    EnvKnob(
        "CUDA_HOME",
        None,
        "path",
        "CUDA toolkit whose `bin/nvcc` builds the kernels "
        "(`ops/_build.py`); unset, `nvcc` is taken from `PATH`, "
        "then `/usr/local/cuda`",
        "deploy",
    ),
    EnvKnob(
        "CXX",
        "g++",
        "str",
        "C++ compiler that builds the host packing library "
        "(`native.py`, `ops/csrc/windowpack.cpp`)",
        "deploy",
    ),
)

ENV_KNOB_NAMES = frozenset(k.name for k in ENV_KNOBS)


def env_overrides(env: Mapping[str, str] | None = None) -> dict[str, str]:
    """Registered knobs explicitly set in the process env — the varz
    plane's enumerable answer to "how is this worker configured beyond
    defaults" (non-indexed knobs only; values are raw strings)."""
    e = os.environ if env is None else env
    return {k.name: e[k.name] for k in ENV_KNOBS if k.name in e}
