"""Host-side wrapper: ragged jobs in, reference-wire verdicts out.

Packs pending metric windows into fixed-shape batches (bucketed by
window length, and by row count), gathers the per-metric-type config
table into dense operand vectors, runs `scoring.score` on the device,
and decodes the results into the reference's wire format — anomalies as
flat `[t1, v1, t2, v2, ...]` pairs (`Barrelman.go:593-620`).

Not ported yet (ROADMAP.md Queue 1): the fit cache and state arena, the
columnar warm path and `band_mode="last"`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device

# Window lengths bucket to powers of two >= 8, so a fleet of ragged jobs
# lands in a handful of batch shapes.
_MIN_BUCKET = 8


def bucket_length(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class MetricTask:
    """One metric of one job, host-side ragged form.

    times/values arrays for historical, current and (optionally) baseline
    windows; metric_type selects the threshold row (error5xx/latency/...).
    """

    job_id: str
    alias: str
    metric_type: str | None
    hist_times: np.ndarray
    hist_values: np.ndarray
    cur_times: np.ndarray
    cur_values: np.ndarray
    base_times: np.ndarray | None = None
    base_values: np.ndarray | None = None

    def __post_init__(self):
        if (self.base_times is None) != (self.base_values is None):
            raise ValueError("base_times and base_values must be set together")


@dataclasses.dataclass
class MetricVerdict:
    """Judgment for one metric, in wire-friendly form."""

    job_id: str
    alias: str
    verdict: int  # scoring.HEALTHY / UNHEALTHY / UNKNOWN
    anomaly_pairs: list[float]  # flat [t1, v1, t2, v2, ...]
    upper: np.ndarray  # [Tc] model band (gauge export)
    lower: np.ndarray
    p_value: float
    dist_differs: bool


# Empty padding row for batch-axis bucketing: zero windows everywhere,
# so verdict UNKNOWN, dropped on decode.
_PAD_TASK = MetricTask(
    job_id="__pad__",
    alias="__pad__",
    metric_type=None,
    hist_times=np.zeros(0, np.int64),
    hist_values=np.zeros(0, np.float32),
    cur_times=np.zeros(0, np.int64),
    cur_values=np.zeros(0, np.float32),
)


class HealthJudge:
    """Batched scorer with reference-parity config semantics, on `device`
    (CUDA by default; raises when there is no card)."""

    def __init__(self, config: BrainConfig | None = None, device="cuda"):
        self.config = config or BrainConfig()
        self.device = resolve_device(device)

    def judge(self, tasks: Sequence[MetricTask]) -> list[MetricVerdict]:
        """Score a set of metric tasks, batching same-shaped buckets."""
        if not tasks:
            return []
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, t in enumerate(tasks):
            key = (
                bucket_length(len(t.hist_values)),
                bucket_length(
                    max(
                        len(t.cur_values),
                        0 if t.base_values is None else len(t.base_values),
                    )
                ),
            )
            buckets.setdefault(key, []).append(i)

        out: list[MetricVerdict | None] = [None] * len(tasks)
        for (th, tc), idxs in buckets.items():
            # the batch axis is bucketed too, so claim sizes that vary
            # tick to tick reuse a few shapes; pad rows are empty
            # (verdict UNKNOWN) and dropped below
            chunk = [tasks[i] for i in idxs]
            rows = bucket_length(len(chunk))
            if rows != len(chunk):
                chunk = chunk + [_PAD_TASK] * (rows - len(chunk))
            for v, i in zip(self._judge_bucket(chunk, th, tc), idxs):
                out[i] = v
        return [v for v in out if v is not None]

    def _judge_bucket(
        self, tasks: list[MetricTask], th: int, tc: int
    ) -> list[MetricVerdict]:
        cfg = self.config
        dev = self.device
        b = len(tasks)
        cur = MetricWindows.from_ragged(
            [(t.cur_times, t.cur_values) for t in tasks], tc, dev, device_times=False
        )
        if all(t.base_values is None for t in tasks):
            # baseline-less bucket: an all-masked baseline fails every
            # pairwise min-points gate, so ship zeros at the same shape
            base = MetricWindows(
                values=torch.zeros((b, tc), dtype=torch.float32, device=dev),
                mask=torch.zeros((b, tc), dtype=torch.bool, device=dev),
                times=None,
            )
        else:
            empty = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            base = MetricWindows.from_ragged(
                [
                    (t.base_times, t.base_values) if t.base_values is not None else empty
                    for t in tasks
                ],
                tc,
                dev,
                device_times=False,
            )
        hist = MetricWindows.from_ragged(
            [(t.hist_times, t.hist_values) for t in tasks], th, dev, device_times=False
        )
        thr, bound, mlb = cfg.anomaly.gather([t.metric_type for t in tasks])
        batch = scoring.ScoreBatch(
            historical=hist,
            current=cur,
            baseline=base,
            threshold=torch.from_numpy(thr).to(dev),
            bound=torch.from_numpy(bound).to(dev),
            min_lower_bound=torch.from_numpy(mlb).to(dev),
            min_points=torch.full(
                (b,), cfg.min_historical_points, dtype=torch.int32, device=dev
            ),
        )
        res = scoring.score(
            batch,
            algorithm=cfg.algorithm,
            season_length=cfg.season_steps,
            pairwise_algorithm=cfg.pairwise.algorithm,
            p_threshold=cfg.pairwise.threshold,
            min_mw=cfg.pairwise.min_mann_white_points,
            min_wilcoxon=cfg.pairwise.min_wilcoxon_points,
            min_kruskal=cfg.pairwise.min_kruskal_points,
            min_friedman=cfg.pairwise.min_friedman_points,
        )
        return self._decode_bucket(tasks, res, tc)

    def _decode_bucket(
        self, tasks: list[MetricTask], res: scoring.ScoreResult, tc: int
    ) -> list[MetricVerdict]:
        # ONE device->host copy: every result stacked into a single f32
        # [B, 3 * Tc + 3] tensor (verdict codes, flags and the differs bit
        # are small integers, exact in f32)
        f32 = torch.float32
        host = (
            torch.cat(
                [
                    res.anomalies.to(f32),
                    res.upper.to(f32),
                    res.lower.to(f32),
                    res.verdict.to(f32)[:, None],
                    res.p_value.to(f32)[:, None],
                    res.dist_differs.to(f32)[:, None],
                ],
                dim=1,
            )
            .cpu()
            .numpy()
        )
        anoms = host[:, :tc] != 0
        uppers = host[:, tc : 2 * tc]
        lowers = host[:, 2 * tc : 3 * tc]
        verdicts = host[:, 3 * tc].astype(np.int32)
        ps = host[:, 3 * tc + 1]
        differs = host[:, 3 * tc + 2] != 0

        # decode anomaly positions for the whole batch in one pass (flags
        # are sparse and already mask-gated, so padding never fires)
        nz_r, nz_c = np.nonzero(anoms)
        row_start = np.searchsorted(nz_r, np.arange(len(tasks)))
        row_end = np.searchsorted(nz_r, np.arange(len(tasks)), side="right")

        out = []
        for i, t in enumerate(tasks):
            n = len(t.cur_values)
            cols = nz_c[row_start[i] : row_end[i]]
            if len(cols):
                flat = np.empty(2 * len(cols), dtype=np.float64)
                flat[0::2] = np.asarray(t.cur_times)[cols]
                flat[1::2] = np.asarray(t.cur_values)[cols]
                pairs = flat.tolist()
            else:
                pairs = []
            out.append(
                MetricVerdict(
                    job_id=t.job_id,
                    alias=t.alias,
                    verdict=int(verdicts[i]),
                    anomaly_pairs=pairs,
                    upper=uppers[i, :n],
                    lower=lowers[i, :n],
                    p_value=float(ps[i]),
                    dist_differs=bool(differs[i]),
                )
            )
        return out


def combine_verdicts(verdicts: Sequence[MetricVerdict]) -> int:
    """Job-level verdict: fail-fast — any unhealthy metric makes the job
    unhealthy (`design.md:43`); all-unknown stays unknown."""
    if not verdicts:
        return scoring.UNKNOWN
    vs = [v.verdict for v in verdicts]
    if any(v == scoring.UNHEALTHY for v in vs):
        return scoring.UNHEALTHY
    if all(v == scoring.UNKNOWN for v in vs):
        return scoring.UNKNOWN
    return scoring.HEALTHY
