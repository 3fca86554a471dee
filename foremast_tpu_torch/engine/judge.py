"""Host-side wrapper: ragged jobs in, reference-wire verdicts out.

Packs pending metric windows into fixed-shape batches (bucketed by
window length, and by row count), gathers the per-metric-type config
table into dense operand vectors, runs the scoring programs on the
device, and decodes the results into the reference's wire format —
anomalies as flat `[t1, v1, t2, v2, ...]` pairs (`Barrelman.go:593-620`).

Two paths, as in the JAX package's `engine/judge.py`:

  * the object path, `HealthJudge.judge`: one-shot `scoring.score` with
    no `fit_cache`; with one (the worker's setting), fit-cache misses
    are fitted in 4,096-row chunks from anchor + bf16-delta uploads,
    their terminal state is cached and scattered into a device
    `StateArena`, and every row is judged by `score_from_arena`;
  * the columnar warm path, `judge_columnar[_async]`: arrays in, compact
    arrays out, for re-check ticks whose every row carries a cached fit.
    The dispatch half returns before the device finishes; the
    `ColumnarPending.wait()` half synchronizes one event and unpacks.

Every device-to-host transfer of a result is ONE copy (`_HostCopy`).
Operands reach the device through the placement hooks (`_place`,
`_place_cols`) and results leave through `_fetch`; `parallel.
ShardedJudge` overrides them to split every batch over a device mesh,
where each program then runs once a block (`parallel.mesh.per_block`).
The stages — fit, arena_assemble, score, decode — are `observe.spans`
spans, as in the JAX judge, so a worker tick's breakdown attributes them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from foremast_tpu_torch import native
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.engine.arena import StateArena, _arena_bytes
from foremast_tpu_torch.observe.spans import span
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device
from foremast_tpu_torch.parallel import mesh as meshlib
from foremast_tpu_torch.parallel.mesh import Blocks, Fill, per_block

log = logging.getLogger("foremast_tpu_torch.judge")

# Window lengths bucket to powers of two >= 8, so a fleet of ragged jobs
# lands in a handful of batch shapes.
_MIN_BUCKET = 8

# Max rows per fit sub-batch (`_fit_miss_rows`): bounds peak packing and
# upload memory on fleet-cold ticks at the 7-day history length.
_FIT_CHUNK = 4096


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
    # stable service identity (job ids change per run)
    app: str = ""
    # set ONLY when the historical range is provably immutable: keys the
    # fitted-forecast cache so re-check ticks skip the history scan
    fit_key: str | None = None
    # warm fast path: a task whose fit is cached may carry EMPTY hist
    # arrays plus the history's step and last timestamp, so the seasonal
    # gap advance (_gap_steps) keeps its anchors
    hist_step: float | None = None
    hist_last_t: float | None = None
    # the cached fit state itself: a referenced entry cannot be evicted
    # from under the task by a colder bucket's fits in the same tick
    fit_entry: tuple | None = None

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


# Fits whose horizon depends on trend or seasonal phase: only these need
# the hist->cur gap advance (scoring._advance_gap); the gap is a no-op
# for level-only models, so the deployed default skips computing it.
GAP_SENSITIVE_FITS = frozenset(
    {
        "double_exponential_smoothing",
        "holtwinters",
        "holt_winters",
        "phase_means",
        "auto_univariate",
        "seasonal",
        "prophet",
        "seasonal_hourly",
    }
)


def infer_step(times: np.ndarray) -> float:
    """Sampling step of a window — median of (subsampled) spacings.

    Median, not endpoint spacing: PromQL query_range omits empty steps.
    Long windows median 64 evenly spaced consecutive spacings (O(1) in
    the window length). Falls back to the reference's 60 s step for
    single-point or all-duplicate windows."""
    n = len(times)
    if n < 2:
        return 60.0
    t = np.asarray(times)
    if n > 65:
        idx = np.linspace(0, n - 2, 64).astype(np.int64)
        gaps = t[idx + 1] - t[idx]
    else:
        gaps = np.diff(t)
    step = float(np.median(gaps))
    return step if step > 0 else 60.0


def _gap_steps(tasks: Sequence[MetricTask]) -> np.ndarray:
    """Per-task hist->cur gap in whole steps, [B] int32: the fitted
    phase assumes the current window starts ONE step after the history's
    last point. Tasks without both windows gap 0."""
    out = np.zeros(len(tasks), np.int32)
    for i, t in enumerate(tasks):
        ht = t.hist_times
        ct = t.cur_times
        if len(ct) == 0:
            continue
        if len(ht) == 0:
            # warm fast path: the caller skipped the hist fetch but
            # carried the step/last-time anchors
            if t.hist_step is None or t.hist_last_t is None:
                continue
            step, last = t.hist_step, t.hist_last_t
        else:
            step, last = infer_step(np.asarray(ht)), float(ht[-1])
        k = int(round((float(ct[0]) - last) / max(step, 1.0)))
        out[i] = max(k - 1, 0)
    return out


# -- compact results ----------------------------------------------------------


def packbits(flags: torch.Tensor) -> torch.Tensor:
    """`np.packbits(flags, axis=1)` on a [B, T] bool tensor: [B, ceil(T/8)]
    uint8, big-endian bit order (the first flag is the high bit), the
    last byte zero-padded. The bit weights are made on the device: a
    host constant would be a blocking copy, which synchronizes."""
    b, t = flags.shape
    nbytes = (t + 7) // 8
    bits = torch.zeros((b, nbytes * 8), dtype=torch.uint8, device=flags.device)
    bits[:, :t] = flags
    w = torch.pow(2, torch.arange(7, -1, -1, device=flags.device)).to(torch.uint8)
    return (bits.view(b, nbytes, 8) * w).sum(dim=-1, dtype=torch.uint8)


def _band_last(upper, lower, nidx):
    """Each row's band at its last valid index: upper[arange(B), nidx]."""
    ar = torch.arange(upper.shape[0], device=upper.device)
    nidx = nidx.long()
    return upper[ar, nidx], lower[ar, nidx]


def _compact_min(verdict, anoms):
    """Minimal result for hook-less columnar ticks: int8 verdicts and
    bit-packed anomaly flags only."""
    return verdict.to(torch.int8), packbits(anoms)


def _compact_full_nopair(verdict, anoms, upper, lower):
    """Columnar result with FULL [B, Tc] bands (band_mode="full")."""
    return verdict.to(torch.int8), packbits(anoms), upper, lower


def _compact_min_pair(verdict, anoms, p, differs):
    """`_compact_min` plus the pairwise outputs (the canary bucket: its
    (p, differs) are real device results)."""
    return verdict.to(torch.int8), packbits(anoms), p, differs


def _compact_full_pair(verdict, anoms, upper, lower, p, differs):
    """`_compact_full_nopair` plus the pairwise outputs."""
    return verdict.to(torch.int8), packbits(anoms), upper, lower, p, differs


def _compact_result_nopair(verdict, anoms, upper, lower, nidx):
    """`_compact_result` without the pairwise outputs (the baseline-less
    columnar bucket, where (p=1, differs=False) are constants the host
    fills itself)."""
    ub, lb = _band_last(upper, lower, nidx)
    return verdict.to(torch.int8), packbits(anoms), ub, lb


def _compact_result(verdict, anoms, upper, lower, p, differs, nidx):
    """Shrink a ScoreResult for the device-to-host hop (band_mode="last"):
    int8 verdicts, bit-packed anomaly flags, each row's band at its last
    valid point (the gauge exporter reads only `upper[-1]`), p and
    differs."""
    ub, lb = _band_last(upper, lower, nidx)
    return verdict.to(torch.int8), packbits(anoms), ub, lb, p, differs


_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.int8: np.int8,
    torch.uint8: np.uint8,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
}


def _pack_bytes(tensors):
    """[B, bytes] uint8 of result tensors with leading axis [B], and the
    (numpy dtype, tail shape, bytes) layout to unpack it."""
    b = tensors[0].shape[0]
    parts, layout = [], []
    for t in tensors:
        tail = tuple(t.shape[1:])
        u8 = t.contiguous().reshape(b, int(np.prod(tail, dtype=np.int64))).view(torch.uint8)
        parts.append(u8)
        layout.append((_NP_DTYPES[t.dtype], tail, u8.shape[1]))
    return torch.cat(parts, dim=1), layout


class _HostCopy:
    """Result tensors (leading axis [B]) on their way to the host, as ONE
    copy: packed bytewise into a [B, bytes] uint8 buffer. For CUDA
    tensors the copy is non-blocking into pinned memory allocated for
    this result alone, with an event recorded after it, so the caller
    returns before the device finishes; `wait()` synchronizes that event
    (from any thread) and unpacks. For CPU tensors `wait()` just
    unpacks.

    Results sharded over a mesh's data axis (`Blocks`) land in the same
    one host buffer: each block is packed on its device and copied
    non-blocking into its rows, one event per block on that device's
    current stream. With `gather` (a pod over NCCL,
    `parallel.mesh.Pod.gather_device`) the packed rows of this rank are
    first gathered with every other rank's on the card, and the whole
    result is the one copy."""

    __slots__ = ("buf", "layout", "events")

    def __init__(self, tensors, gather=None):
        self.events = []
        if isinstance(tensors[0], Blocks):
            # one packing a run of blocks on one device
            packed = []
            for lo, hi in meshlib.device_runs(tensors[0].devices):
                with meshlib.device_scope(tensors[0].parts[lo].device):
                    got, self.layout = _pack_bytes([meshlib.join_rows(t.parts[lo:hi]) for t in tensors])
                packed.append(got)
            if gather is None:
                self._copy_runs(packed)
                return
            dev = packed[0].device
            packed = torch.cat([p.to(dev, non_blocking=True) for p in packed]) if len(packed) > 1 else packed[0]
        else:
            packed, self.layout = _pack_bytes(tensors)
        if gather is not None:
            with meshlib.device_scope(packed.device):
                packed = gather(packed)
        self._copy_one(packed)

    def _copy_one(self, packed: torch.Tensor) -> None:
        if not packed.is_cuda:
            self.buf = packed
            return
        self.buf = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.device(packed.device):
            self.buf.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self.events.append(event)

    def _copy_runs(self, packed: list) -> None:
        # one copy a run of blocks on one device, into its rows of the buffer
        if not packed[0].is_cuda:
            self.buf = torch.cat(packed)
            return
        rows = sum(p.shape[0] for p in packed)
        self.buf = torch.empty((rows, packed[0].shape[1]), dtype=torch.uint8, pin_memory=True)
        r0 = 0
        for p in packed:
            with torch.cuda.device(p.device):
                self.buf[r0 : r0 + p.shape[0]].copy_(p, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(p.device))
            self.events.append(event)
            r0 += p.shape[0]

    @property
    def nbytes(self) -> int:
        return self.buf.numel()

    def done(self) -> bool:
        """Whether every copy has landed (never blocks)."""
        return all(event.query() for event in self.events)

    def synchronize(self) -> None:
        """Wait until every copy has landed in `buf`."""
        for event in self.events:
            event.synchronize()

    def unpack(self, buf: torch.Tensor) -> tuple[np.ndarray, ...]:
        """The result columns of a host buffer laid out as `buf` (this
        copy's, or several ranks' rows of it gathered end to end)."""
        host = buf.numpy()
        out, off = [], 0
        for dtype, tail, nbytes in self.layout:
            col = np.ascontiguousarray(host[:, off : off + nbytes]).view(dtype)
            out.append(col.reshape((host.shape[0],) + tail))
            off += nbytes
        return tuple(out)

    def wait(self) -> tuple[np.ndarray, ...]:
        self.synchronize()
        return self.unpack(self.buf)


def _fetch(tensors) -> tuple[np.ndarray, ...]:
    """One blocking device-to-host copy of result tensors, as numpy."""
    return _HostCopy(tensors).wait()


def _pack_hist_bf16_host(series, length: int, pin: bool = False):
    """Host-side anchor-shifted bf16-delta packing of ragged histories.

    Returns (anchor f32 [B] numpy, delta [B, length] bf16 CPU tensor,
    lens int32 [B] numpy). Rows are left-packed (valid prefix), so the
    device rebuilds the mask from `lens` and the upload is 2 B/point
    (f32 values + bool mask are 5). Anchor = first valid value, so the
    deltas are bounded by the window range; padding is +0.0. The deltas
    are the JAX package's bit for bit: f32 differences rounded to
    nearest even as `ml_dtypes` rounds them (NaN the quiet NaN of its
    sign). The native library writes the bf16 rows straight into the
    delta tensor, pinned when `pin` (so the upload needs no staging
    copy); without the library a numpy row loop does the same."""
    b = len(series)
    delta = torch.empty((b, length), dtype=torch.bfloat16, pin_memory=pin and b * length > 0)
    packed = native.pack_bf16_delta(series, length, out=delta.view(torch.int16).numpy().view(np.uint16))
    if packed is None:
        anchor, bits, lens = native.pack_bf16_delta_plain(series, length)
        delta.view(torch.int16).copy_(torch.from_numpy(bits.view(np.int16)))
    else:
        anchor, _, lens = packed
    return anchor, delta, lens


def _zero_windows(rows: int, length: int) -> MetricWindows:
    """All-masked [rows, length] windows, made on the device they land
    on (`Fill`): an absent baseline, or the history of a cached tick."""
    return MetricWindows(
        values=Fill((rows, length), 0.0, torch.float32), mask=Fill((rows, length), False, torch.bool), times=None
    )


# Columnar-path padding: a zero terminal-state entry (n_hist=0 =>
# UNKNOWN, dropped on decode) under one shared arena key.
_PAD_ENTRY = (0.0, 0.0, np.zeros(1, np.float32), 0, 0.0, 0)
_PAD_COL_KEY = "__pad__col__"

# Empty padding row for batch-axis bucketing: zero windows everywhere
# (verdict UNKNOWN, dropped on decode); the constant fit key means the
# empty-history "fit" caches once, so padded warm ticks stay fit-free.
_PAD_TASK = MetricTask(
    job_id="__pad__",
    alias="__pad__",
    metric_type=None,
    hist_times=np.zeros(0, np.int64),
    hist_values=np.zeros(0, np.float32),
    cur_times=np.zeros(0, np.int64),
    cur_values=np.zeros(0, np.float32),
    fit_key="__pad__",
)


class HealthJudge:
    """Batched scorer with reference-parity config semantics, on `device`
    (CUDA by default; raises when there is no card).

    `fit_cache` (a `models.cache.ModelCache`, set by the caller — the
    reference brain's MAX_CACHE_SIZE model cache) memoizes fitted
    terminal state per (algorithm, season, task.fit_key): a re-check
    tick whose history is unchanged re-runs only the judgment tail."""

    def __init__(self, config: BrainConfig | None = None, device="cuda"):
        self.config = config or BrainConfig()
        self.device = resolve_device(device)
        self.fit_cache = None
        # "full": MetricVerdict.upper/lower carry the whole band over the
        # current window. "last": only the final band point (as a
        # length-1 array, so `v.upper[-1]` consumers work unchanged) and
        # bit-packed flags cross to the host — the fleet-tick mode.
        self.band_mode = "full"
        # device state arenas (engine.arena.StateArena), one per
        # (algorithm, season) the judge has scored
        self._arenas: dict = {}
        # counters of arenas retired by clear_device_state / widen
        # rebuilds: device_state_counters() stays monotone
        self._counters_base = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "fallbacks": 0,
            "shard_moves": 0,
        }
        # columnar batch-padding accounting: rows dispatched vs rows that
        # were padding
        self.pad_rows_total = 0
        self.batch_rows_total = 0

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
            # (verdict UNKNOWN) and dropped below; their constant
            # "__pad__" fit key keeps warm ticks fit-free
            chunk = [tasks[i] for i in idxs]
            rows = bucket_length(len(chunk))
            if rows != len(chunk):
                chunk = chunk + [_PAD_TASK] * (rows - len(chunk))
            for v, i in zip(self._judge_bucket(chunk, th, tc), idxs):
                out[i] = v
        return [v for v in out if v is not None]

    # -- placement hooks (parallel.ShardedJudge overrides them) -----------

    def _place(self, tree):
        """Device placement of a tree of host operands (a ScoreBatch, or
        a tuple with one): numpy and CPU tensors uploaded to the judge's
        device (pinned, non-blocking), `Fill` constants made there. A
        ShardedJudge splits every leaf's leading axis over its mesh."""
        return meshlib.place(tree, self.device)

    def _place_cols(self, *arrays):
        """Placement of bare leading-axis-[B] operands (row indices, gap
        steps, fit uploads, the joint programs' buffers): one upload
        each here; a ShardedJudge splits them over its mesh."""
        return tuple(meshlib.place(a, self.device) for a in arrays)

    def _batch_multiple(self) -> int:
        """Every dispatched batch's leading axis is a multiple of this: 1
        here, the data-axis size on a ShardedJudge (fully masked pad
        rows make up the difference)."""
        return 1

    def _arena_sharding(self):
        """Placement of arena device buffers: None (the judge's device)
        here; a ShardedJudge's mesh placement, data-axis block-sharded
        or replicated (FOREMAST_ARENA_SHARDED=0)."""
        return None

    def _arena_shards(self) -> int:
        """Data-axis blocks the arena row space splits into: 1 here; a
        ShardedJudge's data-axis size, so each device hosts exactly its
        batch block's rows."""
        return 1

    def _host_copy(self, tree) -> _HostCopy:
        """Start the one copy of result tensors to the host (never
        blocks); a ShardedJudge over a pod with NCCL gathers every rank's
        rows on the card first."""
        return _HostCopy(tree)

    def _fetch(self, tree) -> tuple[np.ndarray, ...]:
        """Result tensors to the host: ONE copy (`_host_copy`), or the
        wait of one already started; a ShardedJudge times it, and over a
        pod gathers every rank's rows."""
        copy = tree if isinstance(tree, _HostCopy) else self._host_copy(tree)
        return copy.wait()

    # -- device state ----------------------------------------------------

    def _arena_for(self, m_need: int):
        """The (algorithm, season) arena, grown to season width m_need.

        Widening rebuilds the arena empty; host fit-cache entries
        persist, so the next assign re-scatters what it needs. None when
        arenas are disabled (FOREMAST_ARENA_BYTES=0)."""
        if _arena_bytes() <= 0:
            return None
        key = (self.config.algorithm, self.config.season_steps)
        arena = self._arenas.get(key)
        if arena is None or arena.m < m_need:
            if arena is not None:
                self._retire_counters(arena)
            arena = StateArena(
                m_need, device=self.device, sharding=self._arena_sharding(), shards=self._arena_shards()
            )
            self._arenas[key] = arena
        return arena

    def _retire_counters(self, arena) -> None:
        """Fold a dying arena's event counters into the monotone base."""
        c = arena.counters()
        for k in ("hits", "misses", "evictions", "shard_moves"):
            self._counters_base[k] += c.get(k, 0)

    def clear_device_state(self) -> None:
        """Release every arena's device buffers. The host fit cache is
        untouched — rows repopulate on the next tick. Event counters are
        folded into the monotone base first."""
        for arena in self._arenas.values():
            self._retire_counters(arena)
            arena.clear()
        self._arenas.clear()

    def device_state_counters(self) -> dict:
        """Aggregated arena hit/miss/eviction/fallback counters, MONOTONE
        across arena rebuilds."""
        agg = dict(self._counters_base, rows_live=0)
        for arena in self._arenas.values():
            c = arena.counters()
            for k in ("hits", "misses", "evictions", "rows_live", "shard_moves"):
                agg[k] += c.get(k, 0)
        return agg

    # -- the fit-cache path ----------------------------------------------

    def _pairwise_kwargs(self, algorithm: str) -> dict:
        pw = self.config.pairwise
        return dict(
            pairwise_algorithm=algorithm,
            p_threshold=pw.threshold,
            min_mw=pw.min_mann_white_points,
            min_wilcoxon=pw.min_wilcoxon_points,
            min_kruskal=pw.min_kruskal_points,
            min_friedman=pw.min_friedman_points,
        )

    def _score_with_fit_cache(
        self, batch: scoring.ScoreBatch, tasks: list[MetricTask], th: int
    ) -> scoring.ScoreResult:
        """Score reusing cached fits; fit only the cache-miss rows.

        Cache entries hold the forecaster's terminal state as host values
        (level, trend, season, season_phase, scale, n_hist) — everything
        `score_from_state` needs; the 7-day history scan runs once per
        (algorithm, fit_key), not once per re-check tick."""
        cfg = self.config
        # season_steps keys the cache too: season buffers of different
        # lengths must never stack into one batch
        keys = [
            (cfg.algorithm, cfg.season_steps, t.fit_key) if t.fit_key else None
            for t in tasks
        ]
        # tasks that carry their entry skip the lookup; everything else
        # goes through ONE batched cache get
        entries = [t.fit_entry for t in tasks]
        need = [i for i, e in enumerate(entries) if e is None]
        if need:
            fetched = self.fit_cache.get_many([keys[i] for i in need])
            for i, e in zip(need, fetched):
                entries[i] = e
        miss = [i for i, e in enumerate(entries) if e is None]
        # the fit stage spans the whole miss-refit loop; near-zero samples
        # on warm ticks show the fit cache doing its job
        with span("judge.fit", stage="fit", rows=len(tasks), misses=len(miss), device=True):
            self._fit_miss_rows(miss, tasks, keys, entries, th)
        gap = self._place_cols(_gap_steps(tasks))[0] if cfg.algorithm in GAP_SENSITIVE_FITS else None
        pw = self._pairwise_kwargs(cfg.pairwise.algorithm)
        return self._arena_score(batch, keys, entries, miss, gap, pw)

    def _fit_miss_rows(self, miss, tasks, keys, entries, th) -> None:
        """Fit the cache-miss rows in chunks of at most `_FIT_CHUNK`,
        filling `entries` in place and populating the fit cache.

        A chunk is padded to a power-of-two row count by repeating a real
        row. With the bf16 gate on (the default) a chunk ships anchor +
        bf16 deltas + lengths (2 B/point): the deployed default
        `moving_average_all` fits its moments from the deltas
        (`scoring.fit_ma_from_bf16_delta`), every other algorithm
        reconstructs f32 values on the device (`fit_forecast_bf16_delta`).
        With the gate off it ships f32 values + masks to
        `scoring.fit_forecast`. Each chunk's state comes back in ONE
        device-to-host copy. On a ShardedJudge a chunk (rounded to the
        data axis) fits block by block, one block a device."""
        cfg = self.config
        pin = self.device.type == "cuda"
        bf16_fit = scoring.bf16_delta_enabled()
        ma_fit = cfg.algorithm == "moving_average_all"
        zero_season = np.zeros(1, np.float32)
        mult = self._batch_multiple()
        for c0 in range(0, len(miss), _FIT_CHUNK):
            chunk = miss[c0 : c0 + _FIT_CHUNK]
            rows = meshlib.pad_to_multiple(bucket_length(len(chunk)), mult)
            pad = [chunk[0]] * (rows - len(chunk))  # repeat a real row
            ragged = [(tasks[i].hist_times, tasks[i].hist_values) for i in chunk + pad]
            puts = []
            if bf16_fit and ma_fit:
                anchor, delta, lens = _pack_hist_bf16_host(ragged, th, pin=pin)
                level, scale, nh = self._fetch(
                    per_block(scoring.fit_ma_from_bf16_delta, *self._place_cols(anchor, delta, lens))
                )
                for j, i in enumerate(chunk):
                    entry = (float(level[j]), 0.0, zero_season, 0, float(scale[j]), int(nh[j]))
                    entries[i] = entry
                    if keys[i] is not None:
                        puts.append((keys[i], entry))
            else:
                if bf16_fit:
                    anchor, delta, n_hist = self._place_cols(*_pack_hist_bf16_host(ragged, th, pin=pin))
                    fc = per_block(
                        scoring.fit_forecast_bf16_delta,
                        anchor,
                        delta,
                        n_hist,
                        algorithm=cfg.algorithm,
                        season_length=cfg.season_steps,
                    )
                else:
                    hist = MetricWindows.from_ragged(ragged, th, "cpu", device_times=False)
                    values, mask = self._place_cols(hist.values, hist.mask)
                    fc = per_block(
                        scoring.fit_forecast,
                        values,
                        mask,
                        algorithm=cfg.algorithm,
                        season_length=cfg.season_steps,
                    )
                    n_hist = per_block(lambda m: m.sum(dim=-1, dtype=torch.int32), mask)
                level, trend, season, phase, scale, nh = self._fetch(
                    (fc.level, fc.trend, fc.season, fc.season_phase, fc.scale, n_hist)
                )
                for j, i in enumerate(chunk):
                    entry = (
                        float(level[j]),
                        float(trend[j]),
                        season[j].copy(),
                        int(phase[j]),
                        float(scale[j]),
                        int(nh[j]),
                    )
                    entries[i] = entry
                    if keys[i] is not None:
                        puts.append((keys[i], entry))
            if puts:
                self.fit_cache.put_many(puts)

    def _arena_score(self, batch, keys, entries, force, gap, pw, n_real=None, merge=False):
        """Arena-gathered judgment shared by the object and columnar
        paths: assign rows, widen-rebuild if a scattered row carries a
        longer season buffer than the arena was built for, scatter the
        changed rows, and score via the on-device gather. Falls back to
        a one-off host stack when arenas are disabled or the batch
        exceeds the hard byte cap — counted and logged."""
        cfg = self.config
        arena = self._arenas.get((cfg.algorithm, cfg.season_steps))
        if arena is None:
            arena = self._arena_for(max(len(e[2]) for e in entries))
        if arena is not None:
            with span("judge.arena_assemble", stage="arena_assemble", rows=len(keys), device=True):
                assigned = arena.assign(keys, force, n_real)
                if assigned is not None and assigned[1]:
                    m_scat = max(len(entries[i][2]) for i in assigned[1])
                    if m_scat > arena.m:
                        # wider season than the arena was built for:
                        # rebuild (empty) at the new width, re-assign all
                        arena = self._arena_for(m_scat)
                        assigned = arena.assign(keys, force, n_real)
                    if assigned is not None and assigned[1]:
                        arena.scatter(assigned[0], assigned[1], entries)
            if assigned is not None:
                with span("judge.score", stage="score", rows=len(keys), device=True):
                    # rows of each device's own arena buffer (a sharded
                    # arena's row of position i lies on i's device),
                    # placed like every other [B] operand
                    (rows_dev,) = self._place_cols(arena.device_rows(assigned[0]))
                    return per_block(
                        scoring.score_from_arena, batch, *arena.state, rows_dev, gap_steps=gap, merge=merge, **pw
                    )
            # a fleet living on this path re-pays its whole state upload
            # every tick, which must never be silent
            self._counters_base["fallbacks"] += 1
            log.warning(
                "arena fallback: batch of %d rows exceeds the hard cap "
                "(%d rows at season_len=%d) — full state restack this "
                "tick; raise FOREMAST_ARENA_MAX_BYTES",
                len(keys),
                arena.hard_rows,
                arena.m,
            )
        with span("judge.score", stage="score", rows=len(keys), device=True):
            return self._stacked_score(batch, entries, gap, pw)

    def _stacked_score(self, batch, entries, gap, pw):
        """One-off host stack + upload of terminal state (the no-arena
        path: FOREMAST_ARENA_BYTES=0 or a batch over the byte budget)."""
        m = max(len(e[2]) for e in entries)
        stacked = (
            np.asarray([e[0] for e in entries], np.float32),
            np.asarray([e[1] for e in entries], np.float32),
            np.stack([scoring.tile_season(np.asarray(e[2], np.float32), m) for e in entries]),
            np.asarray([e[3] for e in entries], np.int32),
            np.asarray([e[4] for e in entries], np.float32),
            np.asarray([e[5] for e in entries], np.int32),
        )
        return per_block(scoring.score_from_state, batch, *self._place_cols(*stacked), gap_steps=gap, **pw)

    # -- the columnar warm path ------------------------------------------

    def judge_columnar(
        self,
        values: np.ndarray,
        mask: np.ndarray,
        keys: list,
        entries: list,
        nidx: np.ndarray,
        thr: np.ndarray,
        bound: np.ndarray,
        mlb: np.ndarray,
        gap_steps: np.ndarray | None = None,
        with_bands: bool = True,
        base_values: np.ndarray | None = None,
        base_mask: np.ndarray | None = None,
    ):
        """Columnar warm-tick scoring: arrays in, compact arrays out —
        `judge_columnar_async` then `ColumnarPending.wait()`, so the
        monolithic and pipelined paths cannot diverge.

        values/mask: [B, tc] current windows (host numpy, caller-packed);
        keys/entries: per-row fit-cache key + terminal-state entry;
        nidx: per-row last-valid index for the band-last gather;
        thr/bound/mlb: per-row anomaly operands. base_values/base_mask:
        an optional second [B, tc] pair of baseline windows (the canary
        bucket), judged with the configured pairwise rank tests; without
        them the PAIRWISE_NONE program runs.

        Returns (verdict int8 [B], anomaly flags uint8 0/1 [B, tc],
        upper_last [B], lower_last [B], p [B] | None, differs [B] |
        None); with_bands=False skips the bands (None); p/differs are
        None on the baseline-less variant."""
        return self.judge_columnar_async(
            values,
            mask,
            keys,
            entries,
            nidx,
            thr,
            bound,
            mlb,
            gap_steps=gap_steps,
            with_bands=with_bands,
            base_values=base_values,
            base_mask=base_mask,
        ).wait()

    def judge_columnar_async(
        self,
        values: np.ndarray,
        mask: np.ndarray,
        keys: list,
        entries: list,
        nidx: np.ndarray,
        thr: np.ndarray,
        bound: np.ndarray,
        mlb: np.ndarray,
        gap_steps: np.ndarray | None = None,
        with_bands: bool = True,
        base_values: np.ndarray | None = None,
        base_mask: np.ndarray | None = None,
    ) -> "ColumnarPending":
        """The dispatch half of `judge_columnar`: pad, upload (pinned,
        non-blocking), queue the arena gather, score and compact on the
        current stream, start the one non-blocking copy of the compact
        result to pinned host memory, and return WITHOUT synchronizing.

        Arena mutation (assign/scatter) happens HERE, so dispatch calls
        stay on one thread in slice order. `wait()` touches no arena
        state and may run on another thread."""
        cfg = self.config
        b0, tc = values.shape
        pairwise = base_values is not None
        rows_b = bucket_length(b0)
        # data-axis rounding on top of the pow2 bucket: a sharded judge
        # needs B divisible by its data axis (already true past 8 rows
        # for a power-of-two axis)
        mult = self._batch_multiple()
        if mult > 1 and rows_b % mult:
            rows_b += mult - rows_b % mult
        self.batch_rows_total += rows_b
        self.pad_rows_total += rows_b - b0
        if rows_b != b0:
            pad = rows_b - b0
            values = np.concatenate([values, np.zeros((pad, tc), np.float32)])
            mask = np.concatenate([mask, np.zeros((pad, tc), bool)])
            nidx = np.concatenate([nidx, np.zeros(pad, np.int32)])
            thr = np.concatenate([thr, np.ones(pad, np.float32)])
            bound = np.concatenate([bound, np.ones(pad, np.int32)])
            mlb = np.concatenate([mlb, np.zeros(pad, np.float32)])
            shards = self._arena_shards()
            if shards > 1:
                # shard-qualified pad keys: the tail's pad positions land
                # in whichever data-axis block b0 puts them, so one
                # stable pad row PER BLOCK keeps warm ticks scatter-free
                # where one shared key would migrate between blocks
                per = rows_b // shards
                keys = list(keys) + [f"{_PAD_COL_KEY}@{(b0 + j) // per}" for j in range(pad)]
            else:
                keys = list(keys) + [_PAD_COL_KEY] * pad
            entries = list(entries) + [_PAD_ENTRY] * pad
            if gap_steps is not None:
                gap_steps = np.concatenate([gap_steps, np.zeros(pad, np.int32)])
            if pairwise:
                # pad baseline rows all-masked: every rank-test gate
                # fails, (p=1, differs=False)
                base_values = np.concatenate([base_values, np.zeros((pad, tc), np.float32)])
                base_mask = np.concatenate([base_mask, np.zeros((pad, tc), bool)])
        if pairwise:
            base = MetricWindows(
                values=np.asarray(base_values, np.float32), mask=np.asarray(base_mask, bool), times=None
            )
        else:
            base = _zero_windows(rows_b, tc)
        batch = scoring.ScoreBatch(
            historical=_zero_windows(rows_b, 0),
            current=MetricWindows(values=np.asarray(values, np.float32), mask=np.asarray(mask, bool), times=None),
            baseline=base,
            threshold=np.asarray(thr, np.float32),
            bound=np.asarray(bound, np.int32),
            min_lower_bound=np.asarray(mlb, np.float32),
            min_points=Fill((rows_b,), cfg.min_historical_points, torch.int32),
        )
        band_last = with_bands and self.band_mode != "full"
        # ONE placement of every host operand (one upload a leaf, split
        # over the mesh on a ShardedJudge)
        batch, gap, nidx_dev = self._place(
            (
                batch,
                None if gap_steps is None else np.asarray(gap_steps, np.int32),
                np.asarray(nidx, np.int64) if band_last else None,
            )
        )
        # Two variants: the baseline-less bucket proves no baselines
        # exist, so PAIRWISE_NONE judges without the rank tests (an
        # empty baseline gates every test off anyway: identical
        # verdicts); the canary bucket runs the configured tests.
        pw = self._pairwise_kwargs(cfg.pairwise.algorithm if pairwise else scoring.PAIRWISE_NONE)
        # the warm dispatch runs ONE call a device over a mesh (the
        # blocks a device holds batched): its launches do not grow with
        # the blocks, and stay under the launch queue's depth
        res = self._arena_score(batch, keys, entries, (), gap, pw, b0, merge=True)
        v, a = res.verdict, res.anomalies
        if with_bands and not band_last:
            if pairwise:
                out = per_block(_compact_full_pair, v, a, res.upper, res.lower, res.p_value, res.dist_differs, merge=True)
            else:
                out = per_block(_compact_full_nopair, v, a, res.upper, res.lower, merge=True)
        elif with_bands:
            if pairwise:
                out = per_block(
                    _compact_result, v, a, res.upper, res.lower, res.p_value, res.dist_differs, nidx_dev, merge=True
                )
            else:
                out = per_block(_compact_result_nopair, v, a, res.upper, res.lower, nidx_dev, merge=True)
        elif pairwise:
            out = per_block(_compact_min_pair, v, a, res.p_value, res.dist_differs, merge=True)
        else:
            out = per_block(_compact_min, v, a, merge=True)
        return ColumnarPending(self, self._host_copy(out), b0, tc, rows_b, with_bands, pairwise)

    def _columnar_wait(self, pending: "ColumnarPending"):
        """The gather half: wait for the one copy of the compact result,
        then unpack on the host. Touches no judge state."""
        b0, tc = pending.b0, pending.tc
        ps = differs = None
        with span("judge.decode", stage="decode", rows=pending.rows, device=True):
            got = self._fetch(pending.dev)
        if pending.with_bands and pending.pairwise:
            v8, packed, ub, lb, ps, differs = got
            ub, lb = ub[:b0], lb[:b0]
        elif pending.with_bands:
            v8, packed, ub, lb = got
            ub, lb = ub[:b0], lb[:b0]
        elif pending.pairwise:
            v8, packed, ps, differs = got
            ub = lb = None
        else:
            v8, packed = got
            ub = lb = None
        anoms = np.unpackbits(packed, axis=1, count=tc)
        if ps is not None:
            ps, differs = ps[:b0], differs[:b0]
        return v8[:b0], anoms[:b0], ub, lb, ps, differs

    # -- the object path -------------------------------------------------

    def _judge_bucket(
        self, tasks: list[MetricTask], th: int, tc: int
    ) -> list[MetricVerdict]:
        cfg = self.config
        b = len(tasks)
        use_cache = self.fit_cache is not None
        # host operands, placed once below (uploaded, or split over the
        # mesh on a ShardedJudge)
        cur = MetricWindows.from_ragged(
            [(t.cur_times, t.cur_values) for t in tasks], tc, "cpu", device_times=False
        )
        if all(t.base_values is None for t in tasks):
            # baseline-less bucket: an all-masked baseline fails every
            # pairwise min-points gate, so zeros at the same shape, made
            # on the device
            base = _zero_windows(b, tc)
        else:
            empty = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            base = MetricWindows.from_ragged(
                [
                    (t.base_times, t.base_values) if t.base_values is not None else empty
                    for t in tasks
                ],
                tc,
                "cpu",
                device_times=False,
            )
        if use_cache:
            # the cached path packs and uploads histories only for
            # cache-miss rows; a fully warm tick ships zero history bytes
            hist = _zero_windows(b, 0)
        else:
            hist = MetricWindows.from_ragged(
                [(t.hist_times, t.hist_values) for t in tasks], th, "cpu", device_times=False
            )
        thr, bound, mlb = cfg.anomaly.gather([t.metric_type for t in tasks])
        batch = self._place(
            scoring.ScoreBatch(
                historical=hist,
                current=cur,
                baseline=base,
                threshold=thr,
                bound=bound,
                min_lower_bound=mlb,
                min_points=Fill((b,), cfg.min_historical_points, torch.int32),
            )
        )
        if use_cache:
            res = self._score_with_fit_cache(batch, tasks, th)
        else:
            with span("judge.score", stage="score", rows=len(tasks), device=True):
                res = per_block(
                    scoring.score,
                    batch,
                    gap_steps=(
                        self._place_cols(_gap_steps(tasks))[0]
                        if cfg.algorithm in GAP_SENSITIVE_FITS
                        else None
                    ),
                    algorithm=cfg.algorithm,
                    season_length=cfg.season_steps,
                    **self._pairwise_kwargs(cfg.pairwise.algorithm),
                )
        # the decode waits for the device (the score spans time the
        # queueing only), so the device time lands in the decode stage
        with span("judge.decode", stage="decode", rows=len(tasks), device=True):
            return self._decode_bucket(tasks, res, tc)

    def _decode_bucket(
        self, tasks: list[MetricTask], res: scoring.ScoreResult, tc: int
    ) -> list[MetricVerdict]:
        # ONE device-to-host copy of every result array
        compact = self.band_mode == "last"
        if compact:
            nidx = np.fromiter(
                (max(min(len(t.cur_values), tc) - 1, 0) for t in tasks),
                np.int64,
                count=len(tasks),
            )
            verdicts, packed, ub, lb, ps, differs = self._fetch(
                per_block(
                    _compact_result,
                    res.verdict,
                    res.anomalies,
                    res.upper,
                    res.lower,
                    res.p_value,
                    res.dist_differs,
                    self._place_cols(nidx)[0],
                )
            )
            anoms = np.unpackbits(packed, axis=1, count=tc)
            uppers = lowers = None
        else:
            verdicts, anoms, uppers, lowers, ps, differs = self._fetch(
                (
                    res.verdict,
                    res.anomalies,
                    res.upper,
                    res.lower,
                    res.p_value,
                    res.dist_differs,
                )
            )

        # decode anomaly positions for the whole batch in one pass (flags
        # are sparse and already mask-gated, so padding never fires)
        nz_r, nz_c = np.nonzero(anoms)
        row_start = np.searchsorted(nz_r, np.arange(len(tasks)))
        row_end = np.searchsorted(nz_r, np.arange(len(tasks)), side="right")

        empty_band = np.zeros(0, np.float32)
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
            if compact:
                # length-1 band (the last point) so `upper[-1]` consumers
                # work unchanged; length 0 for empty windows
                up = ub[i : i + 1] if n else empty_band
                lo = lb[i : i + 1] if n else empty_band
            else:
                up = uppers[i, :n]
                lo = lowers[i, :n]
            out.append(
                MetricVerdict(
                    job_id=t.job_id,
                    alias=t.alias,
                    verdict=int(verdicts[i]),
                    anomaly_pairs=pairs,
                    upper=up,
                    lower=lo,
                    p_value=float(ps[i]),
                    dist_differs=bool(differs[i]),
                )
            )
        return out


class ColumnarPending:
    """A dispatched-but-ungathered columnar judgment: the compact result
    on its way to pinned host memory (`_HostCopy`) plus the decode
    shape. `wait()` is the one blocking point and may run on any single
    consumer thread."""

    __slots__ = ("judge", "dev", "b0", "tc", "rows", "with_bands", "pairwise")

    def __init__(self, judge, dev, b0, tc, rows, with_bands, pairwise):
        self.judge = judge
        self.dev = dev
        self.b0 = b0
        self.tc = tc
        self.rows = rows
        self.with_bands = with_bands
        self.pairwise = pairwise

    def wait(self):
        return self.judge._columnar_wait(self)


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
