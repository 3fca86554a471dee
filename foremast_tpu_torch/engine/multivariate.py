"""Multivariate job judgment — the reference's metric-count model rule.

The JAX package's `engine/multivariate.py` on torch: 1 metric -> the
univariate forecasters; 2 metrics -> the bivariate normal; 3+ metrics ->
the LSTM autoencoder with its residual-Gaussian companion:

  * `ML_ALGORITHM=auto`             -> by metric count
  * `ML_ALGORITHM=bivariate_normal` -> joint 2-metric judgment (pairs only)
  * `ML_ALGORITHM=lstm_autoencoder` -> joint judgment for 2+ metrics
  * anything else                   -> univariate per metric (HealthJudge)

Joint detectors align a job's metrics on common timestamps, judge the
joint series, and attribute flagged timestamps back to every alias (the
wire format is per-alias anomaly pairs). Per-alias gauge bounds are the
marginal mean +/- threshold * sigma. Canary rank tests run per alias, and
any alias whose distributions differ lowers the job's joint threshold by
`scoring.DIFF_THRESHOLD_FACTOR`.

LSTM-AE models are trained per (app, alias set, window bucket) on the
card (`models.lstm_ae.fit_many`: the `lstm_ae_forward` / `lstm_ae_backward`
kernels) and kept in a bounded `ModelCache` with their residual-MVN
state; the cache entries hold host numpy leaves. Warm re-checks score
joint docs columnar from a device `TreeArena` (`joint_columnar`).

Over a device mesh (the univariate judge a `parallel.ShardedJudge`), the
joint columnar buffers split over its data axis through its placement
hook (`_place_joint`), the joint `TreeArena`s split their row space the
same way (`_joint_sharding`, `_joint_shards`), and the from-rows
programs (`lstm_joint_score_from_rows`, `models.bivariate.
detect_bivariate_from_rows`) run block by block (`parallel.mesh.
per_block`) against each device's own rows (`arena.device_rows`). The object
paths (cold fits, training) stay on the judge's device, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.engine.arena import TreeArena, _arena_bytes, tree_map_leaves
from foremast_tpu_torch.engine.judge import (
    HealthJudge,
    MetricTask,
    MetricVerdict,
    _fetch,
    bucket_length,
    infer_step,
)
from foremast_tpu_torch.models.bivariate import (
    detect_bivariate,
    detect_bivariate_from_rows,
    fit_bivariate,
    fit_bivariate_bf16_delta,
)
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.models.lstm_ae import (
    AEParams,
    LSTMAEConfig,
    LSTMParams,
    ae_cutoff,
    fit_many,
    from_leaves,
    leaves,
    params_from_tree,
    score_many_cutoff,
    score_rows_cutoff,
    tree_map,
)
from foremast_tpu_torch.models.residual_mvn import (
    MVNState,
    chi2_quantile,
    fit_residual_mvn,
    fit_residual_mvn_bf16_delta,
    residual_mvn_d2_robust,
)
from foremast_tpu_torch.observe.spans import span
from foremast_tpu_torch.ops.forecasters import Forecast
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device, to_device
from foremast_tpu_torch.parallel import mesh as meshlib
from foremast_tpu_torch.parallel.mesh import Fill, per_block

log = logging.getLogger("foremast_tpu_torch.multivariate")

ALGO_BIVARIATE = "bivariate_normal"
ALGO_LSTM = "lstm_autoencoder"
ALGO_AUTO = "auto"
MULTIVARIATE_ALGOS = frozenset({ALGO_BIVARIATE, ALGO_LSTM, ALGO_AUTO})

# Sigmas ABOVE the configured threshold at which residual-MVN evidence
# flags alone; between the base and this cutoff a point needs
# corroboration (AE agreement or a borderline neighbour).
MVN_CONFIRM_MARGIN = 1.0

# Univariate fallbacks when a multivariate algorithm is configured but a
# job's metric count doesn't fit: `auto` takes the structure screen,
# explicit bivariate/lstm keep the reference's deployed default.
FALLBACK_UNIVARIATE = "moving_average_all"
FALLBACK_AUTO = "auto_univariate"


def select_mode(algorithm: str, n_metrics: int) -> str:
    """'univariate' | 'bivariate' | 'lstm' for a job with n_metrics."""
    if algorithm == ALGO_AUTO:
        if n_metrics <= 1:
            return "univariate"
        return "bivariate" if n_metrics == 2 else "lstm"
    if algorithm == ALGO_BIVARIATE:
        return "bivariate" if n_metrics == 2 else "univariate"
    if algorithm == ALGO_LSTM:
        return "lstm" if n_metrics >= 2 else "univariate"
    return "univariate"


def align_series(times: list[np.ndarray], vals: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Common timestamps + stacked values [F, n] for one job's window set:
    joint observations exist only where every metric has a sample (the
    first occurrence of a repeated timestamp). The one alignment of both
    the object path and the worker's joint columnar path."""
    times = [np.asarray(t, np.int64) for t in times]
    vals = [np.asarray(v, np.float32) for v in vals]
    common = times[0]
    for t in times[1:]:
        common = np.intersect1d(common, t, assume_unique=False)
    if len(common) == 0:
        return common, np.zeros((len(times), 0), np.float32)
    cols = []
    for t, v in zip(times, vals):
        order = np.argsort(t, kind="stable")
        idx = np.searchsorted(t[order], common)
        cols.append(v[order][idx])
    return common, np.stack(cols, axis=0)


def _align(tasks: list[MetricTask], which: str) -> tuple[np.ndarray, np.ndarray]:
    """`align_series` over one job's task windows (which: 'hist'/'cur')."""
    return align_series(
        [getattr(t, f"{which}_times") for t in tasks],
        [getattr(t, f"{which}_values") for t in tasks],
    )


def _marginal_bounds(hist: np.ndarray, threshold: float, tc: int):
    """Per-metric constant gauge bounds from historical moments:
    hist [F, n] -> (upper [F, tc], lower [F, tc]), mean +/- thr*sigma."""
    if hist.shape[1] == 0:
        z = np.zeros((hist.shape[0], tc), np.float32)
        return z, z
    mu = hist.mean(axis=1)
    sd = hist.std(axis=1)
    up = np.repeat((mu + threshold * sd)[:, None], tc, axis=1).astype(np.float32)
    lo = np.repeat(np.maximum(mu - threshold * sd, 0.0)[:, None], tc, axis=1).astype(np.float32)
    return up, lo


def _pack_np(rows: list[np.ndarray], length: int) -> tuple[np.ndarray, np.ndarray]:
    """Ragged rows -> host ([B, length] values, [B, length] mask)."""
    out = np.zeros((len(rows), length), np.float32)
    mask = np.zeros((len(rows), length), bool)
    for i, r in enumerate(rows):
        n = min(len(r), length)
        out[i, :n] = r[:n]
        mask[i, :n] = True
    return out, mask


# Checkpoint-entry coercion: rebuilds the AE parameters and the MVN state
# as host numpy from whatever layout a checkpoint restored; the scalar
# reads here are the rehydration contract.
# foremast: device-boundary
def _coerce_entry(entry) -> tuple:
    """Normalize an LSTM cache entry to (AEParams of numpy leaves, float,
    float, mvn | None).

    `mvn` is the seasonal-residual Gaussian state as a 9-tuple of host
    values — (level [F], trend [F], season [F, m], phase [F], resid_mu
    [F], cov [F, F], valid bool, hist_last_ts int, hist_len int). A
    `torch.save` checkpoint restores NamedTuples as plain tuples (and
    bools/ints as they were); an older 3-tuple entry coerces with
    mvn=None and is refit. Returns `entry` itself when nothing changed."""
    params, mu, sd = entry[0], entry[1], entry[2]
    mvn = entry[3] if len(entry) > 3 else None
    changed = not (isinstance(entry, tuple) and len(entry) == 4)
    if not (isinstance(params, AEParams) and isinstance(params.enc, LSTMParams)):
        changed = True
        params = params_from_tree(params, lambda a: np.asarray(a, np.float32))
    mvn_ok = mvn is None or (
        isinstance(mvn, tuple)
        and len(mvn) == 9
        and all(isinstance(a, np.ndarray) for a in mvn[:6])
        and isinstance(mvn[6], bool)
    )
    if not mvn_ok:
        if not (hasattr(mvn, "__len__") and len(mvn) == 9):
            mvn = None  # unknown layout: the judge refits the MVN
        else:
            mvn = (
                np.asarray(mvn[0], np.float32),
                np.asarray(mvn[1], np.float32),
                np.asarray(mvn[2], np.float32),
                np.asarray(mvn[3], np.int32),
                np.asarray(mvn[4], np.float32),
                np.asarray(mvn[5], np.float32),
                bool(np.asarray(mvn[6])),
                int(np.asarray(mvn[7])),
                int(np.asarray(mvn[8])),
            )
        changed = True
    return (params, float(mu), float(sd), mvn) if changed else entry


@dataclasses.dataclass
class _JointJob:
    tasks: list[MetricTask]
    hist_t: np.ndarray
    hist_v: np.ndarray  # [F, nh]
    cur_t: np.ndarray
    cur_v: np.ndarray  # [F, nc]


def _pack_bf16_delta_rows(values: np.ndarray, mask: np.ndarray):
    """Anchor-shifted bf16-delta pack of left-packed joint histories:
    values [..., T] f32 with a valid-prefix mask [..., T] (broadcastable)
    -> (anchor [...] f32 numpy, delta [..., T] bf16 CPU tensor). The
    anchor is the first slot (all-masked rows anchor 0), masked slots pack
    as exact +0, and the cast rounds to nearest even."""
    anchor = (values[..., 0] * mask[..., 0]).astype(np.float32)
    delta = np.where(mask, values - anchor[..., None], np.float32(0.0)).astype(np.float32)
    return anchor, torch.from_numpy(delta).to(torch.bfloat16)


def _stack_params(entries, dev) -> AEParams:
    """Per-job AE parameter trees (numpy leaves) -> one [S, ...] stack on
    `dev`, one upload per leaf."""
    return tree_map(lambda *ls: to_device(np.stack(ls), dev), *[e[0] for e in entries])


def lstm_joint_score_from_rows(state, rows, x, mask, cut, cutoff, hi_cutoff, gaps):
    """The LSTM-AE hybrid judgment from ARENA-resident joint state: each
    doc's state row gathered on the device (`rows` [S] into the
    TreeArena leaves — the AE parameters inside the forward kernel), the
    AE reconstruction check, the echo-robust residual-MVN check and the
    confirmation-band rule; no per-tick state upload.

    state: TreeArena tree — `ae` (AEParams of [capacity, ...] leaves),
    `level`/`trend`/`season`/`phase` (per-metric HW terminal state, season
    tiled to the arena width), `rmu`/`cov` (residual Gaussian), `valid`.
    x [S, 1, tc, F] padded aligned current windows; mask [S, tc] real
    points; cut [S] AE error cutoffs; cutoff/hi_cutoff [S] chi^2 base /
    strong-evidence cutoffs; gaps [S] int32 hist->cur gap steps. Returns
    anomaly flags [S, tc] bool."""
    ae_flags, _err = score_rows_cutoff(state["ae"], rows, x, mask[:, None, :].contiguous(), cut)
    st = {k: v.index_select(0, rows) for k, v in state.items() if k != "ae"}
    return _lstm_joint_judgment(ae_flags[:, 0, :], st, x, mask, cutoff, hi_cutoff, gaps)


def _lstm_joint_judgment(ae_flags, st, x, mask, cutoff, hi_cutoff, gaps):
    """Scoring tail of the from-rows LSTM program: HW gap advance,
    echo-robust residual-MVN distance, confirmation-band corroboration.
    `ae_flags` [S, tc]; `st` the gathered non-AE state."""
    s, f = x.shape[0], x.shape[-1]
    m = st["season"].shape[-1]
    gap = gaps.to(torch.int32)
    # the phase advances by the TRUE gap (mod m); only the trend
    # extrapolation is capped — the arena state itself stays pristine
    phase = ((st["phase"] + gap[:, None]) % m).to(torch.int32)
    level = st["level"] + st["trend"] * gap.clamp_max(scoring.GAP_TREND_CAP_STEPS).to(torch.float32)[:, None]
    dev = x.device
    hw = Forecast(
        pred=torch.zeros((s * f, 0), dtype=torch.float32, device=dev),
        scale=torch.zeros((s * f,), dtype=torch.float32, device=dev),
        level=level.reshape(-1),
        trend=st["trend"].reshape(-1),
        season=st["season"].reshape(s * f, m),
        season_phase=phase.reshape(-1),
    )
    mvn = MVNState(hw=hw, mu=st["rmu"], cov=st["cov"], valid=st["valid"])
    cur_sf = x[:, 0].transpose(1, 2)  # [S, F, tc]
    d2 = residual_mvn_d2_robust(mvn, cur_sf, cutoff)
    valid = st["valid"][:, None] & mask
    over = (d2 > cutoff[:, None]) & valid
    strong = (d2 > hi_cutoff[:, None]) & valid
    border = over & ~strong
    neighbor = torch.zeros_like(border)
    neighbor[:, 1:] |= border[:, :-1]
    neighbor[:, :-1] |= border[:, 1:]
    return ae_flags | strong | (border & (ae_flags | neighbor))


class JointPending:
    """A dispatched joint columnar judgment: the flags on their way to
    host memory (`_HostCopy`), waited through the univariate judge's
    `_fetch` (which, over a pod, gathers every rank's rows). `wait()` is
    the one blocking point."""

    __slots__ = ("dev", "s0", "fetch")

    def __init__(self, dev, s0: int, fetch):
        self.dev = dev
        self.s0 = s0
        self.fetch = fetch

    def wait(self) -> np.ndarray:
        with span("judge.decode", stage="decode", rows=self.s0, device=True):
            return self.fetch(self.dev)[0][: self.s0]


class MultivariateJudge:
    """Dispatcher: routes each job to univariate/bivariate/LSTM judgment
    on `device` (CUDA by default; raises when there is none).

    Drop-in for HealthJudge at the worker level: the same
    `judge(tasks) -> [MetricVerdict]` surface over the flat task list.
    """

    def __init__(
        self,
        config: BrainConfig | None = None,
        univariate: HealthJudge | None = None,
        cache: ModelCache | None = None,
        device="cuda",
    ):
        self.config = config or BrainConfig()
        self.device = resolve_device(device)
        uni_cfg = self.config
        if self.config.algorithm in MULTIVARIATE_ALGOS:
            fallback = FALLBACK_AUTO if self.config.algorithm == ALGO_AUTO else FALLBACK_UNIVARIATE
            uni_cfg = dataclasses.replace(self.config, algorithm=fallback)
        self.univariate = univariate or HealthJudge(uni_cfg, device=self.device)
        if self.univariate.config.algorithm in MULTIVARIATE_ALGOS:
            self.univariate.config = uni_cfg
        self.cache = cache or ModelCache(self.config.max_cache_size)
        self.lstm_steps = int(os.environ.get("FOREMAST_LSTM_STEPS", "60"))
        # per-key warm-path metadata recorded next to every joint fit:
        # (tc, hist_mu [F], hist_sd [F], step, last_ts, n_hist)
        self.joint_meta = ModelCache(self.config.max_cache_size)
        # device arenas of joint state rows, one per (mode, feature count);
        # retired arenas fold their counters into the monotone base
        self._joint_arenas: dict = {}
        self._joint_counters_base = {"hits": 0, "misses": 0, "evictions": 0, "shard_moves": 0, "fallbacks": 0}
        self.pad_rows_total = 0
        self.batch_rows_total = 0

    # -- public ----------------------------------------------------------

    def judge(self, tasks: list[MetricTask]) -> list[MetricVerdict]:
        if not tasks:
            return []
        by_job: dict[str, list[MetricTask]] = {}
        for t in tasks:
            by_job.setdefault(t.job_id, []).append(t)
        uni: list[MetricTask] = []
        bi: list[list[MetricTask]] = []
        lstm: list[list[MetricTask]] = []
        for job_tasks in by_job.values():
            mode = select_mode(self.config.algorithm, len(job_tasks))
            if mode == "bivariate":
                bi.append(job_tasks)
            elif mode == "lstm":
                lstm.append(job_tasks)
            else:
                uni.extend(job_tasks)
        out: list[MetricVerdict] = []
        if uni:
            out.extend(self.univariate.judge(uni))
        if bi:
            out.extend(self._judge_bivariate(bi))
        if lstm:
            out.extend(self._judge_lstm(lstm))
        return out

    # -- shared helpers --------------------------------------------------

    def _joint(self, job_tasks: list[MetricTask]) -> _JointJob:
        ht, hv = _align(job_tasks, "hist")
        ct, cv = _align(job_tasks, "cur")
        return _JointJob(job_tasks, ht, hv, ct, cv)

    # Pairwise decode stage: gathers the rank tests' (p, differs) for host
    # emission.
    # foremast: device-boundary
    def _pairwise(self, joints: list[_JointJob]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-job (p [F], differs [F]): each alias's raw current window
        tested against its own baseline window. Metrics without a
        baseline fail every min-points gate: (1.0, False)."""
        cfg = self.config
        tasks = [t for j in joints for t in j.tasks]
        if all(t.base_values is None for t in tasks):
            return [(np.ones(len(j.tasks)), np.zeros(len(j.tasks), bool)) for j in joints]
        tc = bucket_length(
            max(max(len(t.cur_values), 0 if t.base_values is None else len(t.base_values)) for t in tasks)
        )
        empty = (np.zeros(0, np.int64), np.zeros(0, np.float32))
        dev = self.device
        cur = MetricWindows.from_ragged([(t.cur_times, t.cur_values) for t in tasks], tc, dev, device_times=False)
        base = MetricWindows.from_ragged(
            [(t.base_times, t.base_values) if t.base_values is not None else empty for t in tasks],
            tc,
            dev,
            device_times=False,
        )
        p, differs = _fetch(
            scoring.pairwise_decision(
                cur,
                base,
                cfg.pairwise.algorithm,
                cfg.pairwise.threshold,
                cfg.pairwise.min_mann_white_points,
                cfg.pairwise.min_wilcoxon_points,
                cfg.pairwise.min_kruskal_points,
                cfg.pairwise.min_friedman_points,
            )
        )
        out, i = [], 0
        for j in joints:
            f = len(j.tasks)
            out.append((p[i : i + f], differs[i : i + f]))
            i += f
        return out

    def _unknown(self, job_tasks: list[MetricTask], pairwise=None) -> list[MetricVerdict]:
        """UNKNOWN verdicts, carrying real pairwise evidence when computed."""
        return [
            MetricVerdict(
                job_id=t.job_id,
                alias=t.alias,
                verdict=scoring.UNKNOWN,
                anomaly_pairs=[],
                upper=np.zeros(len(t.cur_values), np.float32),
                lower=np.zeros(len(t.cur_values), np.float32),
                p_value=1.0 if pairwise is None else float(pairwise[0][f]),
                dist_differs=False if pairwise is None else bool(pairwise[1][f]),
            )
            for f, t in enumerate(job_tasks)
        ]

    def _effective_thresholds(self, pw, threshold: float) -> np.ndarray:
        """Per-job joint threshold: lowered by DIFF_THRESHOLD_FACTOR when
        ANY alias's distributions differ."""
        return np.asarray(
            [threshold * scoring.DIFF_THRESHOLD_FACTOR if bool(d.any()) else threshold for _, d in pw],
            np.float32,
        )

    def _emit(self, job: _JointJob, flags: np.ndarray, threshold: float, pairwise=None) -> list[MetricVerdict]:
        """Joint flags [nc] over the aligned current points -> per-alias
        verdicts in the reference wire form."""
        flagged_times = job.cur_t[flags]
        verdict = scoring.UNHEALTHY if flags.any() else scoring.HEALTHY
        up, lo = _marginal_bounds(job.hist_v, threshold, max(len(job.cur_t), 1))
        out = []
        for f, t in enumerate(job.tasks):
            vals = job.cur_v[f][flags]
            pairs: list[float] = []
            for ts, v in zip(flagged_times, vals):
                pairs.extend([float(ts), float(v)])
            out.append(
                MetricVerdict(
                    job_id=t.job_id,
                    alias=t.alias,
                    verdict=verdict,
                    anomaly_pairs=pairs,
                    upper=up[f],
                    lower=lo[f],
                    p_value=1.0 if pairwise is None else float(pairwise[0][f]),
                    dist_differs=False if pairwise is None else bool(pairwise[1][f]),
                )
            )
        return out

    # -- bivariate -------------------------------------------------------

    # Slow-path bivariate stage: fit, dispatch, gather and verdict decode in
    # one body (the cold-fit regime; the warm path is joint_columnar).
    # foremast: device-boundary
    def _judge_bivariate(self, jobs: list[list[MetricTask]]) -> list[MetricVerdict]:
        threshold = self.config.anomaly.rule_for(None).threshold
        min_pts = self.config.min_historical_points
        dev = self.device
        all_joints = [self._joint(job_tasks) for job_tasks in jobs]
        all_pw = self._pairwise(all_joints)
        joints, pw, out = [], [], []
        for j, p in zip(all_joints, all_pw):
            if len(j.hist_t) < min_pts or len(j.cur_t) == 0:
                out.extend(self._unknown(j.tasks, p))
            else:
                joints.append(j)
                pw.append(p)
        if not joints:
            return out
        th = bucket_length(max(len(j.hist_t) for j in joints))
        tc = bucket_length(max(len(j.cur_t) for j in joints))
        hx, hm = _pack_np([j.hist_v[0] for j in joints], th)
        hy, _ = _pack_np([j.hist_v[1] for j in joints], th)
        cx, cm = _pack_np([j.cur_v[0] for j in joints], tc)
        cy, _ = _pack_np([j.cur_v[1] for j in joints], tc)
        eff_thr = self._effective_thresholds(pw, threshold)
        with span("judge.fit", stage="fit", rows=len(joints), misses=len(joints), device=True):
            if scoring.bf16_delta_enabled():
                # cold joint fits ship anchor + bf16 deltas (2 B/point)
                ax, dx = _pack_bf16_delta_rows(hx, hm)
                ay, dy = _pack_bf16_delta_rows(hy, hm)
                fit = fit_bivariate_bf16_delta(
                    to_device(ax, dev), to_device(dx, dev), to_device(ay, dev), to_device(dy, dev),
                    to_device(hm, dev), min_points=min_pts,
                )
            else:
                fit = fit_bivariate(to_device(hx, dev), to_device(hy, dev), to_device(hm, dev), min_points=min_pts)
        with span("judge.score", stage="score", rows=len(joints), device=True):
            flags = detect_bivariate(
                fit, to_device(cx, dev), to_device(cy, dev), to_device(cm, dev), to_device(eff_thr, dev)
            )
        with span("judge.decode", stage="decode", rows=len(joints), device=True):
            flags, valid, mean_np, cov_np = _fetch((flags, fit.valid, fit.mean, fit.cov))
        for i, j in enumerate(joints):
            if not valid[i]:
                out.extend(self._unknown(j.tasks, pw[i]))
            else:
                # valid fits become warm-path state (invalid ones cache
                # nothing, so the columnar path never turns UNKNOWN healthy)
                self._record_joint("bivariate", j, 0, entry=(mean_np[i].copy(), cov_np[i].copy()))
                out.extend(self._emit(j, flags[i, : len(j.cur_t)], float(eff_thr[i]), pw[i]))
        return out

    # -- LSTM autoencoder ------------------------------------------------

    def _judge_lstm(self, jobs: list[list[MetricTask]]) -> list[MetricVerdict]:
        threshold = self.config.anomaly.rule_for(None).threshold
        min_pts = self.config.min_historical_points
        out: list[MetricVerdict] = []
        all_joints = [self._joint(job_tasks) for job_tasks in jobs]
        all_pw = self._pairwise(all_joints)
        # group by (feature count, per-JOB window bucket): training needs
        # uniform [S, W, T, F], and a group-wide max tc would starve a
        # short-history job into all-masked training windows
        groups: dict[tuple[int, int], list] = {}
        for j, p in zip(all_joints, all_pw):
            f = j.hist_v.shape[0]
            tc = bucket_length(max(len(j.cur_t), 1))
            # the history must fill TWO training windows of the job's own
            # bucket: one window cannot calibrate the AE's cutoff
            if len(j.cur_t) == 0 or len(j.hist_t) < max(min_pts, 2 * tc):
                out.extend(self._unknown(j.tasks, p))
            else:
                groups.setdefault((f, tc), []).append((j, p))
        for (f, tc), pairs in groups.items():
            out.extend(self._judge_lstm_group([j for j, _ in pairs], [p for _, p in pairs], f, tc, threshold))
        return out

    def _train(self, to_train: list[_JointJob], entries: dict, f: int, tc: int) -> None:
        """Train one model per job on its newest tc-length history
        windows (at most 8; shorter histories pad with fully-masked
        windows) and put (params, err_mean, err_std, None) in `entries`."""
        n_win = min(max(len(j.hist_t) // tc for j in to_train), 8)
        x = np.zeros((len(to_train), n_win, tc, f), np.float32)
        mask = np.zeros((len(to_train), n_win, tc), bool)
        for i, j in enumerate(to_train):
            usable = (len(j.hist_t) // tc) * tc
            chunks = j.hist_v[:, len(j.hist_t) - usable :].reshape(f, -1, tc)
            for w in range(min(chunks.shape[1], n_win)):
                x[i, w] = chunks[:, -(w + 1), :].T  # [tc, F]
                mask[i, w] = True
        dev = self.device
        with span("judge.fit", stage="fit", rows=len(to_train), misses=len(to_train), device=True):
            params, mu, sd, _ = fit_many(
                torch.Generator().manual_seed(0),
                to_device(x, dev),
                to_device(mask, dev),
                LSTMAEConfig(features=f),
                steps=self.lstm_steps,
            )
            host = [leaf.cpu().numpy() for leaf in leaves(params)]
            mu_np, sd_np = _fetch((mu, sd))
        for i, j in enumerate(to_train):
            entries[id(j)] = (tree_map(lambda a, i=i: a[i], from_leaves(host)), float(mu_np[i]), float(sd_np[i]), None)

    # Slow-path LSTM/MVN group stage: fit, dispatch, gather and verdict
    # decode in one body (the cold-fit regime; the warm path is
    # joint_columnar).
    # foremast: device-boundary
    def _judge_lstm_group(self, joints, pw, f: int, tc: int, threshold: float) -> list[MetricVerdict]:
        # entries kept locally: the bounded cache may evict mid-batch
        entries: dict[int, tuple] = {}
        to_train: list[_JointJob] = []
        for j in joints:
            cached = self.cache.get(self._key(j, tc))
            if cached is None:
                to_train.append(j)
            else:
                entry = _coerce_entry(cached)
                if entry is not cached:  # checkpoint-restored form: fix once
                    self.cache.put(self._key(j, tc), entry)
                entries[id(j)] = entry
        if to_train:
            self._train(to_train, entries, f, tc)

        # the residual MVN's HW state is TIME-ANCHORED: a cached fit is
        # reused only for the exact same history (last timestamp + length)
        def _mvn_fresh(j: _JointJob, mvn) -> bool:
            return mvn is not None and len(j.hist_t) == mvn[8] and int(j.hist_t[-1]) == mvn[7]

        need_mvn = [j for j in joints if not _mvn_fresh(j, entries[id(j)][3])]
        # partition by the 2-cycle rule BEFORE bucketing: the fit's season
        # guard keys off the batch's STATIC length, so the short partition
        # is fitted at m=1 explicitly (its bucket may pad past 2m)
        season = self.config.season_steps
        for need, m_part in (
            ([j for j in need_mvn if len(j.hist_t) >= 2 * season], season),
            ([j for j in need_mvn if len(j.hist_t) < 2 * season], 1),
        ):
            if need:
                self._fit_mvn_batch(need, entries, f, tc, m_part)

        ordered = [entries[id(j)] for j in joints]
        steps = [infer_step(j.hist_t) for j in joints]
        for j, step in zip(joints, steps):
            self._record_joint("lstm", j, tc, step=step)
        # canary: a differing alias lowers the job's joint threshold
        eff_thr = self._effective_thresholds(pw, threshold)
        sc = self._lstm_scores(joints, ordered, steps, f, tc, eff_thr)
        # hybrid judgment: AE flags UNION the residual Gaussian's, whose
        # borderline points need corroboration (AE agreement or a
        # BORDERLINE neighbour: a strong spike's causal echo must not
        # confirm itself)
        over = (sc["d2"] > sc["cutoff"][:, None]) & sc["valid"]
        strong = (sc["d2"] > sc["hi_cutoff"][:, None]) & sc["valid"]
        border = over & ~strong
        neighbor = np.zeros_like(border)
        neighbor[:, 1:] |= border[:, :-1]
        neighbor[:, :-1] |= border[:, 1:]
        flags = sc["ae_flags"] | strong | (border & (sc["ae_flags"] | neighbor))
        out: list[MetricVerdict] = []
        for i, j in enumerate(joints):
            out.extend(self._emit(j, flags[i, : len(j.cur_t)], float(eff_thr[i]), pw[i]))
        return out

    def _lstm_scores(self, joints, ordered, steps, f: int, tc: int, eff_thr) -> dict:
        """The two detectors' evidence for one LSTM group, as host arrays:
        `err` [S, tc] reconstruction errors against the AE cutoffs `cut`
        [S] (gamma-quantile calibration) and their flags `ae_flags`; the
        echo-robust residual d^2 [S, tc] against the chi^2 `cutoff` and
        `hi_cutoff` [S]; `valid` [S, tc], the MVN fit's validity on the
        real current points (bucket padding never enters the band). Each
        job's HW state is advanced across its real history->current gap."""
        dev = self.device
        s_count = len(joints)
        cur_np = np.zeros((s_count, 1, tc, f), np.float32)
        cur_mask = np.zeros((s_count, tc), bool)
        for i, j in enumerate(joints):
            n = min(len(j.cur_t), tc)
            cur_np[i, 0, :n] = j.cur_v[:, :n].T
            cur_mask[i, :n] = True
        cut = ae_cutoff(np.asarray([e[1] for e in ordered]), np.asarray([e[2] for e in ordered]), eff_thr)
        mvns = [e[3] for e in ordered]
        levels = np.stack([m[0] for m in mvns])  # [S, F]
        trends = np.stack([m[1] for m in mvns])
        # entries may mix season widths (the m=1 partition)
        m_len = max(m[2].shape[-1] for m in mvns)
        seasons = np.stack([scoring.tile_season(m[2], m_len) for m in mvns])  # [S, F, m]
        phases = np.stack([m[3] for m in mvns]).astype(np.int64)
        for i, (j, step) in enumerate(zip(joints, steps)):
            k = int(round((float(j.cur_t[0]) - mvns[i][7]) / max(step, 1.0)))
            gap = max(k - 1, 0)
            # the phase advances by the TRUE gap; the trend is capped
            phases[i] = (phases[i] + gap) % m_len
            levels[i] = levels[i] + trends[i] * min(gap, scoring.GAP_TREND_CAP_STEPS)
        cutoffs = np.asarray([chi2_quantile(float(eff_thr[i]), f) for i in range(s_count)], np.float32)
        hi_cutoffs = np.asarray(
            [chi2_quantile(float(eff_thr[i]) + MVN_CONFIRM_MARGIN, f) for i in range(s_count)], np.float32
        )
        with span("judge.score", stage="score", rows=s_count, device=True):
            flags, err = score_many_cutoff(
                _stack_params(ordered, dev),
                to_device(cur_np, dev),
                to_device(cur_mask[:, None, :], dev),
                to_device(cut, dev),
            )
            hw = Forecast(
                pred=torch.zeros((s_count * f, 0), dtype=torch.float32, device=dev),
                scale=torch.zeros((s_count * f,), dtype=torch.float32, device=dev),
                level=to_device(levels.reshape(-1), dev),
                trend=to_device(trends.reshape(-1), dev),
                season=to_device(seasons.reshape(s_count * f, -1), dev),
                season_phase=to_device(phases.reshape(-1).astype(np.int32), dev),
            )
            state = MVNState(
                hw=hw,
                mu=to_device(np.stack([m[4] for m in mvns]), dev),
                cov=to_device(np.stack([m[5] for m in mvns]), dev),
                valid=to_device(np.asarray([m[6] for m in mvns]), dev),
            )
            # the padded buffer the AE scored, in the MVN's [S, F, tc] layout
            cur_sf = to_device(cur_np[:, 0].transpose(0, 2, 1), dev)
            d2 = residual_mvn_d2_robust(state, cur_sf, to_device(cutoffs, dev))
        with span("judge.decode", stage="decode", rows=s_count, device=True):
            ae_flags, err, d2 = _fetch((flags[:, 0, :], err[:, 0, :], d2))
        return {
            "ae_flags": ae_flags,
            "err": err,
            "cut": cut,
            "d2": d2,
            "cutoff": cutoffs,
            "hi_cutoff": hi_cutoffs,
            "valid": np.asarray([m[6] for m in mvns])[:, None] & cur_mask,
        }

    # Cold MVN fit stage: uploads aligned histories, runs the fit, gathers
    # the state to host numpy for the cache entry.
    # foremast: device-boundary
    def _fit_mvn_batch(self, need: list[_JointJob], entries: dict, f: int, tc: int, season: int) -> None:
        """Fit the residual MVN for one identifiability partition and fold
        the state into each job's cache entry (time-anchored)."""
        thb = bucket_length(max(len(j.hist_t) for j in need))
        hist = np.zeros((len(need), f, thb), np.float32)
        hmask = np.zeros((len(need), thb), bool)
        for i, j in enumerate(need):
            nh = j.hist_v.shape[1]
            hist[i, :, :nh] = j.hist_v
            hmask[i, :nh] = True
        dev = self.device
        with span("judge.fit", stage="fit", rows=len(need), misses=len(need), device=True):
            if scoring.bf16_delta_enabled():
                anchor, delta = _pack_bf16_delta_rows(hist, hmask[:, None, :])
                st = fit_residual_mvn_bf16_delta(
                    to_device(anchor, dev), to_device(delta, dev), to_device(hmask, dev), season_length=season
                )
            else:
                st = fit_residual_mvn(to_device(hist, dev), to_device(hmask, dev), season_length=season)
            n = len(need)
            lv, tr, ph, rmu, cov, va = _fetch(
                (
                    st.hw.level.reshape(n, f),
                    st.hw.trend.reshape(n, f),
                    st.hw.season_phase.reshape(n, f),
                    st.mu,
                    st.cov,
                    st.valid,
                )
            )
            se = st.hw.season.reshape(n, f, -1).cpu().numpy()
        for i, j in enumerate(need):
            e = entries[id(j)]
            entry = (
                e[0],
                e[1],
                e[2],
                (lv[i], tr[i], se[i], ph[i].astype(np.int32), rmu[i], cov[i], bool(va[i]), int(j.hist_t[-1]), len(j.hist_t)),
            )
            entries[id(j)] = entry
            self.cache.put(self._key(j, tc), entry)

    def _key(self, j: _JointJob, tc: int) -> tuple:
        # per (app, aliases, feature count, window bucket, season): two
        # services with the same standard alias set never share a model
        return ("lstm", j.tasks[0].app, tuple(t.alias for t in j.tasks), j.hist_v.shape[0], tc, self.config.season_steps)

    # -- joint columnar fast path ----------------------------------------

    def _joint_keys(self, mode: str, j: _JointJob, tc: int):
        """(cache_key, meta_key) for a joint job, or None when any alias
        lacks a fit key (unsettled history — never warm-admissible)."""
        aliases = tuple(t.alias for t in j.tasks)
        app = j.tasks[0].app
        hkeys = tuple(t.fit_key for t in j.tasks)
        if any(k is None for k in hkeys):
            return None
        if mode == "bivariate":
            # history identity IS part of the key: two deployments of one
            # app never share a fitted Gaussian
            key = ("bivariate", app, aliases, hkeys)
        else:
            key = self._key(j, tc)
        return key, ("jmeta", mode, app, aliases, hkeys)

    def _record_joint(self, mode: str, j: _JointJob, tc: int, entry=None, step: float | None = None) -> None:
        """Fold one slow-path joint judgment into warm-path state. The meta
        (tc, hist_mu [F], hist_sd [F], step, last_ts, n_hist) is REPLACED
        only when its anchors change, so a stable fleet keeps stable meta
        identity (the worker revalidates admission by identity)."""
        keys = self._joint_keys(mode, j, tc)
        if keys is None:
            return
        key, meta_key = keys
        if entry is not None:
            self.cache.put(key, entry)
        last_ts = int(j.hist_t[-1])
        n_hist = len(j.hist_t)
        prev = self.joint_meta.peek(meta_key)
        if prev is not None and prev[0] == tc and prev[4] == last_ts and prev[5] == n_hist:
            return
        self.joint_meta.put(
            meta_key,
            (tc, j.hist_v.mean(axis=1), j.hist_v.std(axis=1), infer_step(j.hist_t) if step is None else step, last_ts, n_hist),
        )

    def columnar_joint_peek(self, mode: str, app: str, aliases: tuple, hist_keys: tuple):
        """Warm-admission probe: (cache_key, entry, meta_key, meta) when
        this joint job can be scored columnar — fitted state and warm
        metadata cached, the history clears the object path's gates, and
        (lstm) the MVN state is anchored to exactly the history the meta
        describes. None otherwise. Lock-free peeks."""
        meta = self.joint_meta.peek(("jmeta", mode, app, aliases, hist_keys))
        if meta is None:
            return None
        tc, _mu, _sd, _step, last_ts, n_hist = meta
        min_pts = self.config.min_historical_points
        if mode == "bivariate":
            if n_hist < min_pts:
                return None
            key = ("bivariate", app, aliases, hist_keys)
            entry = self.cache.peek(key)
            if entry is None:
                return None
        else:
            if n_hist < max(min_pts, 2 * tc):
                return None
            key = ("lstm", app, aliases, len(aliases), tc, self.config.season_steps)
            entry = self.cache.peek(key)
            # checkpoint-restored entries coerce on the slow path first;
            # a stale-anchored MVN must refit there too
            if not isinstance(entry, tuple) or len(entry) != 4 or not isinstance(entry[0], AEParams):
                return None
            mvn = entry[3]
            if mvn is None or mvn[7] != last_ts or mvn[8] != n_hist:
                return None
        return key, entry, ("jmeta", mode, app, aliases, hist_keys), meta

    def _bi_template(self):
        f32 = torch.float32
        return {"mean": ((2,), f32), "cov": ((2, 2), f32)}

    def _lstm_template(self, f: int, m: int):
        f32 = torch.float32
        h = LSTMAEConfig(features=f).hidden

        def cell():
            return LSTMParams(w_x=((f, 4 * h), f32), w_h=((h, 4 * h), f32), b=((4 * h,), f32))

        return {
            "ae": AEParams(enc=cell(), dec=cell(), w_out=((h, f), f32), b_out=((f,), f32)),
            "level": ((f,), f32),
            "trend": ((f,), f32),
            "season": ((f, m), f32),
            "phase": ((f,), torch.int32),
            "rmu": ((f,), f32),
            "cov": ((f, f), f32),
            "valid": ((), torch.bool),
        }

    # -- placement over the univariate judge's mesh --------------------

    def _joint_sharding(self):
        return self.univariate._arena_sharding()

    def _joint_shards(self) -> int:
        """Row-space shard count of the joint arenas: the univariate
        judge's, so joint warm gathers stay on their devices too."""
        return self.univariate._arena_shards()

    def _joint_multiple(self) -> int:
        """Joint batch leading-axis multiple: the univariate judge's (a
        ShardedJudge's data-axis size)."""
        return self.univariate._batch_multiple()

    def _place_joint(self, *arrays):
        """Leading-axis placement of joint columnar buffers through the
        univariate judge's `_place_cols` (one upload each on a plain
        judge; split over the mesh, with its partition assert, on a
        ShardedJudge)."""
        return self.univariate._place_cols(*arrays)

    def _joint_arena_for(self, mode: str, f: int, m_need: int):
        """The (mode, f) TreeArena, season buffers at least m_need wide.
        Widening rebuilds empty (host cache entries re-scatter lazily).
        None when arenas are disabled (FOREMAST_ARENA_BYTES=0)."""
        if _arena_bytes() <= 0:
            return None
        key = (mode, f)
        arena = self._joint_arenas.get(key)
        if arena is None or getattr(arena, "season_m", 0) < m_need:
            if arena is not None:
                self._retire_joint(arena)
            template = self._bi_template() if mode == "bivariate" else self._lstm_template(f, m_need)
            arena = TreeArena(
                template, device=self.device, sharding=self._joint_sharding(), shards=self._joint_shards()
            )
            arena.season_m = m_need
            self._joint_arenas[key] = arena
        return arena

    def _retire_joint(self, arena) -> None:
        c = arena.counters()
        for k in ("hits", "misses", "evictions", "shard_moves"):
            self._joint_counters_base[k] += c.get(k, 0)

    def joint_state_counters(self) -> dict:
        """Aggregated joint-arena counters, monotone across rebuilds."""
        agg = dict(self._joint_counters_base, rows_live=0, capacity_rows=0)
        for arena in self._joint_arenas.values():
            c = arena.counters()
            for k in ("hits", "misses", "evictions", "shard_moves", "rows_live", "capacity_rows"):
                agg[k] += c.get(k, 0)
        return agg

    def _row_tree(self, mode: str, entry, m: int):
        """One arena row (host numpy tree) from a cache entry."""
        if mode == "bivariate":
            return {"mean": entry[0], "cov": entry[1]}
        mvn = entry[3]
        return {
            "ae": entry[0],
            "level": mvn[0],
            "trend": mvn[1],
            "season": scoring.tile_season(mvn[2], m),
            "phase": mvn[3].astype(np.int32),
            "rmu": mvn[4],
            "cov": mvn[5],
            "valid": np.bool_(mvn[6]),
        }

    # The warm joint gather stage: arrays in, the from-rows programs
    # dispatched, flags gathered to host numpy out (the joint counterpart of
    # the worker's _decode_uni).
    # foremast: device-boundary
    def joint_columnar(self, mode, keys, entries, metas, cur, mask, gaps=None) -> np.ndarray:
        """Batched warm judgment of admitted joint docs — arrays in, host
        flags [S, tcb] out: `joint_columnar_async` then `wait()`."""
        return self.joint_columnar_async(mode, keys, entries, metas, cur, mask, gaps).wait()

    def joint_columnar_async(self, mode, keys, entries, metas, cur, mask, gaps=None) -> JointPending:
        """The dispatch half of the joint columnar judgment: cur [S, F,
        tcb] aligned current windows (caller-packed), mask [S, tcb] real
        points, keys/entries/metas per doc from `columnar_joint_peek`,
        gaps [S] int32 hist->cur steps (lstm). Assigns and scatters arena
        rows, uploads (pinned, non-blocking), queues the from-rows program
        and the one copy of its flags to host memory, and returns without
        synchronizing: the cutoffs are computed on the host first. The
        batch axis is pow2-padded (and rounded to the mesh's data axis;
        dup of row 0, mask all-False: flags all-False, dropped on the
        decode)."""
        s0, f, tcb = cur.shape
        thr = float(self.config.anomaly.rule_for(None).threshold)
        m_need = 1 if mode == "bivariate" else max(e[3][2].shape[-1] for e in entries)
        arena = self._joint_arena_for(mode, f, m_need)
        # the sharded arena must see the PADDED position list: a row's
        # block is a function of position // (sb / shards)
        sb = bucket_length(s0)
        mult = self._joint_multiple()
        if mult > 1 and sb % mult:
            sb += mult - sb % mult
        rows = None
        state = None
        if arena is not None:
            re_ = arena.row_entry
            force = [i for i, (k, e) in enumerate(zip(keys, entries)) if re_.get(k) is not None and re_.get(k) is not e]
            keys_a, entries_a = keys, entries
            if arena.shards > 1 and sb != s0:
                # shard-qualified pad keys: one stable pad row per
                # data-axis block (a shared key would migrate between
                # blocks as s0 changes); their masks are all-False
                per = sb // arena.shards
                keys_a = list(keys) + [f"__pad__joint__@{(s0 + j) // per}" for j in range(sb - s0)]
                entries_a = list(entries) + [entries[0]] * (sb - s0)
            with span("judge.arena_assemble", stage="arena_assemble", rows=s0, device=True):
                assigned = arena.assign(keys_a, force, s0)
                if assigned is not None:
                    rows_idx, scat = assigned
                    if scat:
                        trees = [None] * len(entries_a)
                        for i in scat:
                            trees[i] = self._row_tree(mode, entries_a[i], arena.season_m)
                            re_[keys_a[i]] = entries_a[i]
                        arena.scatter(rows_idx, scat, trees)
                    state = arena.state
                    rows = rows_idx
        if rows is None:
            # arena disabled or batch over the hard byte cap: one-off host
            # stack + upload — counted, never silent
            if arena is not None:
                self._joint_counters_base["fallbacks"] += 1
                log.warning(
                    "joint arena fallback: %d %s rows exceed the hard cap — full state restack this "
                    "tick; raise FOREMAST_ARENA_MAX_BYTES",
                    s0,
                    mode,
                )
            trees = [self._row_tree(mode, e, m_need) for e in entries]
            host = tree_map_leaves(lambda *ls: np.stack([np.asarray(x) for x in ls]), *trees)
            mesh = getattr(self.univariate, "mesh", None)
            state = meshlib.place(host, self.device) if mesh is None else meshlib.replicate(host, mesh)
            rows = np.arange(s0, dtype=np.int64)
        self.batch_rows_total += sb
        self.pad_rows_total += sb - s0
        if sb != s0:
            pad = sb - s0
            cur = np.concatenate([cur, np.zeros((pad, f, tcb), np.float32)])
            mask = np.concatenate([mask, np.zeros((pad, tcb), bool)])
            if len(rows) != sb:
                rows = np.concatenate([rows, np.full(pad, rows[0], rows.dtype)])
            if gaps is not None:
                gaps = np.concatenate([gaps, np.zeros(pad, np.int32)])
        # sharded arena: LOCAL (per-block) row indices, through the same
        # placement as the batch buffers; the stacked fallback (state is
        # not arena.state) keeps global rows against replicas
        sharded = arena is not None and arena.shards > 1 and state is arena.state
        rows = np.asarray(rows, np.int64)
        (rows_d,) = self._place_joint(arena.device_rows(rows) if sharded else rows)
        with span("judge.score", stage="score", rows=sb, device=True):
            if mode == "bivariate":
                operands = self._place_joint(
                    np.ascontiguousarray(cur[:, 0]),
                    np.ascontiguousarray(cur[:, 1]),
                    mask,
                    Fill((sb,), thr, torch.float32),
                )
                # one call a device over a mesh (the blocks a device holds
                # batched), as the univariate warm dispatch
                flags = per_block(
                    detect_bivariate_from_rows, state["mean"], state["cov"], rows_d, *operands, merge=True
                )
            else:
                thr_arr = np.full(sb, thr, np.float32)
                cut = ae_cutoff(
                    np.asarray([e[1] for e in entries] + [1.0] * (sb - s0)),
                    np.asarray([e[2] for e in entries] + [1.0] * (sb - s0)),
                    thr_arr,
                )
                operands = self._place_joint(
                    np.ascontiguousarray(cur.transpose(0, 2, 1))[:, None],
                    mask,
                    cut,
                    Fill((sb,), chi2_quantile(thr, f), torch.float32),
                    Fill((sb,), chi2_quantile(thr + MVN_CONFIRM_MARGIN, f), torch.float32),
                    gaps if gaps is not None else Fill((sb,), 0, torch.int32),
                )
                flags = per_block(lstm_joint_score_from_rows, state, rows_d, *operands, merge=True)
            pending = JointPending(self.univariate._host_copy((flags,)), s0, self.univariate._fetch)
        return pending

