#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`foremast_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. device line (name, nvidia-smi name and power limit), kernel build;
  2. every kernel against its plain PyTorch version on the same CUDA
     tensors, at edge shapes (B in {1, 3, 37}, Th in {0, 5, 131, 10080},
     Tc in {1, 30, 64}, masked and near-empty rows, every bound selector,
     lens with 0), verdicts and flags exact, bands within tolerance;
  3. the judge path: HealthJudge.judge on the reference demo's golden
     traces and on a 4,096-task fleet with 7-day histories, checked
     against the same judge on the CPU for a slice of the fleet;
  4. the steady-state programs at full size (B=32768, Th=10080, Tc=30):
     score (ma_judgment), score_bf16_delta (ma_judgment_bf16_delta) and
     fit_forecast (masked_stats), each checked against the CPU, then timed
     with CUDA events, kernel by kernel beside its bound, its plain
     version and, where one exists, one PyTorch library call;
  5. the deployed fit-cache tick on a 16,384-task fleet (band_mode
     "last"): (a) a cold object tick (bf16-delta fits in four chunks,
     fit cache, state arena, score_from_arena), (b) a warm object tick
     (no fit, no scatter), (c) the worker's two columnar buckets and an
     async dispatch waited on a second thread, (d) the f32 cold fit of
     one chunk on a fresh judge (masked_stats); verdicts equal across
     (a)-(d), the first rows and every arena counter equal to a CPU
     judge run the same way; wall clock of each tick, and
     score_from_arena timed alone at B=32768 beside its bound;
  6. the worker's fleet tick: a BrainWorker on the card (warmed up first)
     over an in-memory store of 4,096 docs x 4 aliases (16,384 windows,
     7-day histories, half canaries; FOREMAST_SWEEP_SLICE_DOCS=0, the
     monolithic tick): (a) cold tick through the chunked object path,
     (b) warm tick through the two columnar buckets with 0 fits and 0
     scatters, (c) a warm tick with every 16th doc's latency spiked,
     which must flag exactly those docs, (d) the f32 cold tick of a fresh
     1,024-doc worker (masked_stats); every doc's (status, code, reason,
     anomaly_info) and the arena counters equal a CPU worker's after each
     tick; wall clock, docs/s, windows/s and the span breakdown.
  7. the univariate forecaster family at the default daily season
     (m=1440; Th=10,080 in its 16,384 bucket, Tc=30):
     (a) holt_winters_scan (grid G=8, per-series with predictions) and
     holt_scan bit for bit equal to their plain versions at edge shapes
     (m in 1, 16, 17, 24, 60, 160, 161, 1440: the season ring's depth and
     one above, the shared-memory season's limit and one above; T in 0,
     1, m-1, 2m-1, 2m, 2m+1, odd, and one tile -1/0/+1; B in 33, 37,
     129; all-masked, single-point, gapped, late-starting and early-ending
     rows in one block; a grid of more parameter sets than a launch
     takes); (b) one 4,096-row cold-fit chunk of
     every univariate algorithm through fit_forecast and
     fit_forecast_bf16_delta, timed, the first 256 rows against the CPU
     (state, then verdicts and flags through score_from_state); (c) phase
     5's 16,384-task fleet with quality-generator histories under
     auto_univariate and holt_winters: cold, warm object and columnar
     ticks, the first 1,024 tasks against a CPU judge; (d) the worker's
     fleet tick over seasonal docs (auto_univariate at m=1440 on 1,024
     docs, holt_winters at m=24, the JAX package's season-blocked regime,
     on 256; x 4 aliases), cold then spiked warm, every doc
     against a CPU worker; then both scan kernels timed at the main
     path's shapes (m=1440 and m=24) beside their bounds, the dependent
     chain's floor and the season's device-memory stream, and again with
     every row empty (no chain runs: what is left is the fill of `pred`
     past it and the state's set-up) and on 128 rows (no two blocks on
     one SM), held bit for bit to their plain versions there. A flag may
     differ from the CPU
     only where a current point lies within 1e-5 of a band edge (counted
     and printed), and a Holt-Winters grid choice only at an SSE near
     tie (gap under 1e-5, printed).
Launch counts are zeroed just before each main path (phases 3-4, 5, 6,
7b, 7c, 7d) and read just after its checked calls, so they count the
main paths' launches only: on the default worker path (phase 6) only the
f32 cold fit launches a kernel (masked_stats); the seasonal fits launch
holt_winters_scan (Holt-Winters, and auto_univariate at m <= 64),
holt_scan (double exponential smoothing) and masked_stats (every mean
model and identifiability guard).

`python3 chip_smoke.py --kernels-only` builds the kernels, runs phase 2
and 7(a), times the two scan kernels at full size and stops: the short
first call after a kernel change.

The last lines are the kernels line, the JSON kernel table, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 memory rates, bytes/s, by a substring of the device name
# (NVIDIA data sheets); the f32 rate outside the tensor cores is 67 TFLOP/s.
PEAK_BYTES = {"HBM3": 3.35e12, "SXM": 3.35e12, "NVL": 3.9e12, "PCIe": 2.0e12}
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50e6  # H100 L2 cache

FLEET = 4096  # one fit chunk of the JAX judge: a fleet-cold tick's batch
FIT_FLEET = 16384  # phase 5: four fit chunks
BUSY_CYCLES = 200_000_000  # ~0.1 s of the card's clock ahead of an async dispatch
FULL_B, FULL_TH, FULL_TC = 32768, 10080, 30  # bench.py's steady-state shape

KERNEL_FILES = {
    "ma_judgment": ("foremast_tpu_torch/ops/csrc/ma_judgment.cu", "foremast_tpu/ops/kernels.py:322"),
    "ma_judgment_bf16_delta": (
        "foremast_tpu_torch/ops/csrc/ma_judgment_bf16_delta.cu",
        "foremast_tpu/ops/kernels.py:264",
    ),
    "masked_stats": ("foremast_tpu_torch/ops/csrc/masked_stats.cu", "foremast_tpu/ops/kernels.py:126"),
    # no Pallas kernel: these replace the JAX package's lax.scan recurrences
    "holt_winters_scan": (
        "foremast_tpu_torch/ops/csrc/holt_winters_scan.cu",
        "foremast_tpu/ops/forecasters.py:349",
    ),
    "holt_scan": ("foremast_tpu_torch/ops/csrc/holt_scan.cu", "foremast_tpu/ops/forecasters.py:195"),
}
MA_KERNELS = ("ma_judgment", "ma_judgment_bf16_delta", "masked_stats")
TOL = {"ma_judgment": 1e-4, "ma_judgment_bf16_delta": 1e-5, "masked_stats": 1e-4}


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def close_err(got, want, tol: float) -> float:
    """Max |got - want|; fails unless |got - want| <= tol * (1 + |want|)."""
    import torch

    diff = (got.double() - want.double()).abs()
    if diff.numel() == 0:
        return 0.0
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    check(bool((diff <= tol * (1.0 + want.double().abs())).all()), f"max error {diff.max().item()} over tol {tol}")
    return float(diff.max().item()) if diff.numel() else 0.0


def cuda_ms(fn, iters: int = 10, repeats: int = 5) -> float:
    """Median over `repeats` of the mean device time of `iters` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at edge shapes
# ---------------------------------------------------------------------------


def edge_inputs(rng, b: int, th: int, tc: int, dev):
    import torch

    hv = rng.normal(2.0, 1.5, (b, th)).astype(np.float32)
    hm = rng.random((b, th)) > 0.2
    lens = rng.integers(0, th + 1, b).astype(np.int32)
    for r in range(b):
        if r % 4 == 1:  # fully masked history
            hm[r] = False
            lens[r] = 0
        elif r % 4 == 2:  # near-empty history
            hm[r] = False
            hm[r, : min(5, th)] = True
            lens[r] = min(5, th)
    delta = rng.normal(0.0, 0.5, (b, th)).astype(np.float32)
    delta[np.arange(th)[None, :] >= lens[:, None]] = 0.0
    anchor = rng.normal(2.0, 0.5, b).astype(np.float32)
    cv = rng.normal(2.0, 1.5, (b, tc)).astype(np.float32)
    cv[:, tc // 2] += np.where(np.arange(b) % 2 == 0, 40.0, -40.0)  # breaches
    cm = rng.random((b, tc)) > 0.1
    cm[3::5] = False  # no current data
    thr = rng.uniform(1.0, 3.0, b).astype(np.float32)
    bound = (np.arange(b) % 3 + 1).astype(np.int32)
    mlb = (np.arange(b) % 2).astype(np.float32)
    mnp = np.where(np.arange(b) % 7 == 6, 3, 10).astype(np.int32)

    def t(x):
        return torch.from_numpy(x).to(dev)

    return dict(
        hv=t(hv), hm=t(hm), anchor=t(anchor), delta=t(delta).to(torch.bfloat16),
        lens=t(lens), cv=t(cv), cm=t(cm), thr=t(thr), bound=t(bound), mlb=t(mlb), mnp=t(mnp),
    )


def compare_judgment(name, got, want) -> float:
    import torch

    check(torch.equal(got[0], want[0]), f"{name}: verdicts differ")
    check(torch.equal(got[1], want[1]), f"{name}: anomaly flags differ")
    return max(close_err(got[2], want[2], TOL[name]), close_err(got[3], want[3], TOL[name]))


def phase_kernels_vs_plain(dev) -> dict:
    import torch

    from foremast_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(2024)
    worst = {name: 0.0 for name in MA_KERNELS}
    cases = [(b, th, tc) for b in (1, 3, 37) for th in (0, 5, 131, 10080) for tc in (1, 30, 64)]
    for b, th, tc in cases:
        x = edge_inputs(rng, b, th, tc, dev)
        tail = (x["cv"], x["cm"], x["thr"], x["bound"], x["mlb"], x["mnp"])
        worst["ma_judgment"] = max(
            worst["ma_judgment"],
            compare_judgment(
                "ma_judgment",
                K.ma_judgment(x["hv"], x["hm"], *tail),
                K._ma_judgment_plain(x["hv"], x["hm"], *tail),
            ),
        )
        worst["ma_judgment_bf16_delta"] = max(
            worst["ma_judgment_bf16_delta"],
            compare_judgment(
                "ma_judgment_bf16_delta",
                K.ma_judgment_bf16_delta(x["anchor"], x["delta"], x["lens"], *tail),
                K._ma_judgment_bf16_delta_plain(x["anchor"], x["delta"], x["lens"], *tail),
            ),
        )
        got = K.masked_stats(x["hv"], x["hm"])
        want = K._masked_stats_plain(x["hv"], x["hm"])
        check(torch.equal(got[0], want[0]), "masked_stats: counts differ")
        worst["masked_stats"] = max(
            worst["masked_stats"],
            close_err(got[1], want[1], TOL["masked_stats"]),
            close_err(got[2], want[2], TOL["masked_stats"]),
        )
    # a contiguous history whose rows are not 16-byte aligned takes the
    # kernels' scalar path
    x = edge_inputs(rng, 37, 10080, 30, dev)
    hv = torch.empty(37 * 10080 + 1, device=dev)[1:].view(37, 10080)
    hv.copy_(x["hv"])
    tail = (x["cv"], x["cm"], x["thr"], x["bound"], x["mlb"], x["mnp"])
    worst["ma_judgment"] = max(
        worst["ma_judgment"],
        compare_judgment(
            "ma_judgment", K.ma_judgment(hv, x["hm"], *tail), K._ma_judgment_plain(hv, x["hm"], *tail)
        ),
    )
    torch.cuda.synchronize()
    print(f"phase 2: {len(cases) + 1} edge cases per kernel, all kernels equal their plain versions")
    for name, err in worst.items():
        print(f"phase 2: {name} worst band/moment error {err:.3e} (tolerance {TOL[name]:g})")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the judge
# ---------------------------------------------------------------------------


def load_trace(name: str):
    from datetime import datetime, timezone

    ts, vs = [], []
    with open(os.path.join(ROOT, "tests", "data", name)) as f:
        for line in f:
            line = line.strip()
            if line:
                t, v = line.split(",")
                dt = datetime.strptime(t, "%Y-%m-%d %H:%M:%S").replace(tzinfo=timezone.utc)
                ts.append(int(dt.timestamp()))
                vs.append(float(v))
    return np.asarray(ts, np.int64), np.asarray(vs, np.float32)


def fleet_tasks(n: int, seed: int = 7):
    from foremast_tpu_torch.engine.judge import MetricTask

    rng = np.random.default_rng(seed)
    mtypes = ["error5xx", "error4xx", "latency", "cpu", "memory", None, "custom"]
    t0 = 1_700_000_000
    ht = t0 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 * np.arange(1, FULL_TC + 1, dtype=np.int64)
    bt = ct - 60 * FULL_TC
    level = rng.uniform(0.2, 5.0, n).astype(np.float32)
    hist = level[:, None] * (1 + 0.05 * rng.standard_normal((n, FULL_TH))).astype(np.float32)
    cur = level[:, None] * (1 + 0.05 * rng.standard_normal((n, FULL_TC))).astype(np.float32)
    base = level[:, None] * (1 + 0.05 * rng.standard_normal((n, FULL_TC))).astype(np.float32)
    spiked = np.arange(n) % 16 == 5
    cur[spiked, FULL_TC // 2] += 40.0
    tasks = []
    for i in range(n):
        kw = {}
        if i % 2 == 0:  # half the fleet are canaries with a baseline
            kw = dict(base_times=bt, base_values=base[i])
        tasks.append(
            MetricTask(
                job_id=f"job{i}", alias=f"m{i % 5}", metric_type=mtypes[i % len(mtypes)],
                hist_times=ht, hist_values=hist[i], cur_times=ct, cur_values=cur[i], **kw,
            )
        )
    return tasks, spiked


def same_verdicts(got, want, what: str) -> None:
    check(len(got) == len(want), f"{what}: verdict counts differ")
    for g, w in zip(got, want):
        check(g.verdict == w.verdict, f"{what}: verdict of {g.job_id}")
        check(g.anomaly_pairs == w.anomaly_pairs, f"{what}: anomaly pairs of {g.job_id}")
        check(g.dist_differs == w.dist_differs, f"{what}: dist_differs of {g.job_id}")
        check(abs(g.p_value - w.p_value) <= 1e-5 * (1 + abs(w.p_value)), f"{what}: p of {g.job_id}")
        check(np.allclose(g.upper, w.upper, rtol=1e-4, atol=1e-4), f"{what}: upper of {g.job_id}")
        check(np.allclose(g.lower, w.lower, rtol=1e-4, atol=1e-4), f"{what}: lower of {g.job_id}")


def phase_judge() -> None:
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine.judge import HealthJudge, MetricTask
    from foremast_tpu_torch.engine.scoring import HEALTHY, UNHEALTHY, UNKNOWN
    from foremast_tpu_torch.ops import kernels as K

    judge = HealthJudge(BrainConfig())  # the default device: the card
    check(judge.device.type == "cuda", "HealthJudge() did not pick the card")
    nt, nv = load_trace("demo_canary_normal.csv")
    st, sv = load_trace("demo_canary_spike.csv")
    hist = np.tile(nv, 6)  # the normal trace as a stable history
    htimes = 1_700_000_000 + 60 * np.arange(len(hist), dtype=np.int64)
    golden = [
        MetricTask("g1", "error4xx", "error4xx", htimes, hist, nt, nv),
        MetricTask("g2", "error4xx", "error4xx", htimes, hist, st, sv),
    ]
    before = K.LAUNCHES["ma_judgment"]
    v_norm, v_spike = judge.judge(golden)
    check(v_norm.verdict == HEALTHY and v_norm.anomaly_pairs == [], "golden normal trace not healthy")
    check(v_spike.verdict == UNHEALTHY, "golden spike trace not unhealthy")
    check(any(abs(v - 40.134) < 1e-3 for v in v_spike.anomaly_pairs[1::2]), "40.134 spike not flagged")
    print(f"phase 3: golden traces: normal HEALTHY, spike UNHEALTHY, flagged {v_spike.anomaly_pairs[1::2]}")

    tasks, spiked = fleet_tasks(FLEET)
    walls = []
    for _ in range(2):  # the first run also warms the allocator
        t0 = time.perf_counter()
        verdicts = judge.judge(tasks)
        walls.append(time.perf_counter() - t0)
    counts = {k: sum(v.verdict == c for v in verdicts) for k, c in
              (("healthy", HEALTHY), ("unhealthy", UNHEALTHY), ("unknown", UNKNOWN))}
    check(all(verdicts[i].verdict == UNHEALTHY for i in np.flatnonzero(spiked)), "a spiked task was not flagged")
    check(counts["unknown"] == 0, "fleet tasks with full histories judged unknown")
    check(sum(v.dist_differs for v in verdicts[1::2]) == 0, "baseline-less tasks report differing distributions")
    n_cmp = 128
    same_verdicts(verdicts[:n_cmp], HealthJudge(BrainConfig(), device="cpu").judge(tasks[:n_cmp]), "fleet vs CPU")
    check(K.LAUNCHES["ma_judgment"] > before, "the judge did not launch ma_judgment")
    print(
        f"phase 3: fleet of {FLEET} tasks (Th={FULL_TH}, Tc={FULL_TC}, half canaries): {counts}, "
        f"differs={sum(v.dist_differs for v in verdicts)}; first {n_cmp} equal the CPU judge"
    )
    print(
        f"phase 3: judge wall clock {walls[0]:.3f} s then {walls[1]:.3f} s "
        f"= {FLEET / walls[1]:.0f} windows/s end to end (host packing + device + decode)"
    )


# ---------------------------------------------------------------------------
# phase 4: steady state at full size
# ---------------------------------------------------------------------------


def cpu_rows(batch, n: int):
    """The first n rows of a ScoreBatch, on the CPU."""
    import dataclasses

    from foremast_tpu_torch.ops.windows import MetricWindows

    def cut(x):
        return None if x is None else x[:n].cpu()

    def win(w):
        return MetricWindows(values=cut(w.values), mask=cut(w.mask), times=cut(w.times))

    return dataclasses.replace(
        batch,
        historical=win(batch.historical), current=win(batch.current), baseline=win(batch.baseline),
        threshold=cut(batch.threshold), bound=cut(batch.bound),
        min_lower_bound=cut(batch.min_lower_bound), min_points=cut(batch.min_points),
    )


def same_result(got, want, tol: float, what: str) -> None:
    import torch

    n = want.verdict.shape[0]
    check(torch.equal(got.verdict[:n].cpu(), want.verdict), f"{what}: verdicts differ from the CPU")
    check(torch.equal(got.anomalies[:n].cpu(), want.anomalies), f"{what}: flags differ from the CPU")
    check(torch.equal(got.dist_differs[:n].cpu(), want.dist_differs), f"{what}: differs bits differ")
    close_err(got.p_value[:n].cpu(), want.p_value, 1e-5)
    close_err(got.upper[:n].cpu(), want.upper, tol)
    close_err(got.lower[:n].cpu(), want.lower, tol)


def phase_steady_state(dev, peak_bytes: float) -> tuple[dict, dict, dict]:
    import torch

    from foremast_tpu_torch.config import PAIRWISE_ALL
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.parallel.batch import throughput_batch

    B, TH, TC = FULL_B, FULL_TH, FULL_TC
    t0 = time.perf_counter()
    batch = throughput_batch(B, TH, TC, device=dev)
    slim, anchor, delta = scoring.make_bf16_delta_batch(batch)
    torch.cuda.synchronize()
    print(f"phase 4: batch B={B} Th={TH} Tc={TC} built in {time.perf_counter() - t0:.1f} s")

    # the main path, once each, checked against the CPU on the first rows
    n_cmp = 256
    ref = cpu_rows(batch, n_cmp)
    res = scoring.score(batch)
    same_result(res, scoring.score(ref), 1e-4, "score")
    slim_ref, anchor_ref, delta_ref = scoring.make_bf16_delta_batch(ref)
    res16 = scoring.score_bf16_delta(slim, anchor, delta)
    check(torch.equal(delta[:n_cmp].cpu(), delta_ref), "bf16 packing differs from the CPU")
    same_result(res16, scoring.score_bf16_delta(slim_ref, anchor_ref, delta_ref), 1e-5, "score_bf16_delta")
    fc = scoring.fit_forecast(batch.historical.values, batch.historical.mask)
    fc_ref = scoring.fit_forecast(ref.historical.values, ref.historical.mask)
    close_err(fc.level[:n_cmp].cpu(), fc_ref.level, 1e-4)
    close_err(fc.scale[:n_cmp].cpu(), fc_ref.scale, 1e-4)
    torch.cuda.synchronize()
    print(
        f"phase 4: score, score_bf16_delta and fit_forecast equal the CPU on the first {n_cmp} rows; "
        f"verdicts {torch.bincount(res.verdict.long(), minlength=3).tolist()} (healthy/unhealthy/unknown)"
    )
    launches = dict(K.LAUNCHES)

    # end-to-end program times
    for name, fn in (
        ("score", lambda: scoring.score(batch)),
        ("score_bf16_delta", lambda: scoring.score_bf16_delta(slim, anchor, delta)),
        ("fit_forecast", lambda: scoring.fit_forecast(batch.historical.values, batch.historical.mask)),
    ):
        ms = cuda_ms(fn)
        print(f"phase 4: {name}: {ms:.3f} ms per batch = {B / (ms * 1e-3):.0f} windows/s")
    # the parts of those programs that are not kernels
    for name, fn in (
        ("pairwise_decision (rank tests)", lambda: scoring.pairwise_decision(
            batch.current, batch.baseline, PAIRWISE_ALL, 0.05, 20, 20, 5, 20)),
        ("valid counts from the mask (score_bf16_delta)", lambda: batch.historical.mask.sum(
            dim=-1, dtype=torch.int32)),
    ):
        print(f"phase 4: {name}: {cuda_ms(fn):.3f} ms per batch")

    # kernel by kernel, on the operands the main path gives each
    h, m = batch.historical.values, batch.historical.mask
    c = batch.current
    tail = (c.values, c.mask, batch.threshold, batch.bound, batch.min_lower_bound, batch.min_points)
    lens = m.sum(dim=-1, dtype=torch.int32)
    cur_bytes = B * TC * 5 + B * 16  # current values + mask, four per-row operands
    out_bytes = B * 4 + B * TC * 9  # verdict, flags, upper, lower
    work = {
        "ma_judgment": (
            lambda: K.ma_judgment(h, m, *tail),
            lambda: K._ma_judgment_plain(h, m, *tail),
            None,
            B * TH * 5 + cur_bytes + out_bytes,
            B * TH * 5,
        ),
        "ma_judgment_bf16_delta": (
            lambda: K.ma_judgment_bf16_delta(anchor, delta, lens, *tail),
            lambda: K._ma_judgment_bf16_delta_plain(anchor, delta, lens, *tail),
            None,
            B * TH * 2 + B * 8 + cur_bytes + out_bytes,
            B * TH * 4,
        ),
        "masked_stats": (
            lambda: K.masked_stats(h, m),
            lambda: K._masked_stats_plain(h, m),
            None,  # no single PyTorch call computes masked moments
            B * TH * 5 + B * 12,
            B * TH * 5,
        ),
    }
    full_err, timings = {}, {}
    for name, (kernel, plain, library, nbytes, flops) in work.items():
        got, want = kernel(), plain()
        if name == "masked_stats":
            check(torch.equal(got[0], want[0]), "masked_stats: counts differ at full size")
            full_err[name] = max(close_err(a, b, TOL[name]) for a, b in zip(got[1:], want[1:]))
        else:
            full_err[name] = compare_judgment(name, got, want)
        del got, want
        kernel_ms = cuda_ms(kernel, iters=20)
        plain_ms = cuda_ms(plain, iters=3, repeats=3)
        library_ms = cuda_ms(library, iters=20) if library else None
        bound_bytes_ms = nbytes / peak_bytes * 1e3
        bound_ops_ms = flops / PEAK_F32_FLOPS * 1e3
        timings[name] = dict(
            ms=kernel_ms,
            plain_ms=plain_ms,
            library_ms=library_ms,
            bound_ms=max(bound_bytes_ms, bound_ops_ms),
            bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            bytes=nbytes,
        )
        print(
            f"phase 4: {name}: kernel_ms={kernel_ms:.4f} bound_ms={timings[name]['bound_ms']:.4f} "
            f"({nbytes / 1e9:.3f} GB at {peak_bytes / 1e12:.2f} TB/s; {timings[name]['bound_by']}) "
            f"plain_ms={plain_ms:.4f} library_ms={'none' if library_ms is None else f'{library_ms:.4f}'} "
            f"achieved {nbytes / (kernel_ms * 1e-3) / 1e12:.2f} TB/s, full-size error {full_err[name]:.3e}"
        )
    # for reference only: the nearest library call ignores the mask, so it
    # is another function (4 B a point read where masked_stats reads 5)
    print(f"phase 4: reference, not the same function: torch.var_mean of the history without its mask "
          f"{cuda_ms(lambda: torch.var_mean(h, dim=-1, correction=0), iters=20):.4f} ms")
    return launches, timings, full_err


# ---------------------------------------------------------------------------
# phase 5: the deployed fit-cache tick (cold fit -> arena -> columnar re-check)
# ---------------------------------------------------------------------------


def fit_cache_fleet(n: int, seed: int = 11):
    """`n` tasks with 7-day histories, fit keys, half canaries, every 16th
    spiked. Histories lie on a 1/64 grid within a few units of their
    first point, so every bf16 delta and both moment sums are exact in
    any order: the bf16 and f32 cold fits then agree to f32 rounding of
    one division and one square root, and no flag sits on a band edge by
    accident of summation order. One times array is shared by all."""
    from foremast_tpu_torch.engine.judge import MetricTask

    rng = np.random.default_rng(seed)
    mtypes = ["error5xx", "error4xx", "latency", "cpu", "memory", None, "custom"]
    t0 = 1_700_000_000
    ht = t0 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 * np.arange(1, FULL_TC + 1, dtype=np.int64)
    bt = ct - 60 * FULL_TC
    level = rng.uniform(0.5, 4.0, n).astype(np.float32)
    hist = np.empty((n, FULL_TH), np.float32)
    for c0 in range(0, n, 4096):  # in slices: a float64 [n, Th] would be 1.3 GB
        sl = slice(c0, c0 + 4096)
        noise = rng.standard_normal((hist[sl].shape[0], FULL_TH), dtype=np.float32)
        hist[sl] = np.round(64 * level[sl, None] * (1 + 0.05 * noise)) / 64
    cur = level[:, None] * (1 + 0.05 * rng.standard_normal((n, FULL_TC))).astype(np.float32)
    base = level[:, None] * (1 + 0.05 * rng.standard_normal((n, FULL_TC))).astype(np.float32)
    spiked = np.arange(n) % 16 == 5
    cur[spiked, FULL_TC // 2] += 40.0
    tasks = []
    for i in range(n):
        kw = dict(base_times=bt, base_values=base[i]) if i % 2 == 0 else {}
        tasks.append(
            MetricTask(
                job_id=f"job{i}", alias=f"m{i % 5}", metric_type=mtypes[i % len(mtypes)],
                hist_times=ht, hist_values=hist[i], cur_times=ct, cur_values=cur[i],
                fit_key=f"app{i}|m{i % 5}|{int(ht[-1])}", **kw,
            )
        )
    return tasks, spiked, cur, base


def columnar_inputs(judge, tasks, cur, base, canary: bool):
    """One columnar bucket packed as the worker packs it: keys and entries
    from `fit_cache.peek`, nidx = len - 1, per-row thr/bound/mlb from the
    metric-type table; the canary bucket with its baseline pair."""
    from foremast_tpu_torch.engine.judge import GAP_SENSITIVE_FITS, _gap_steps, bucket_length

    cfg = judge.config
    idx = np.flatnonzero([(t.base_values is not None) == canary for t in tasks])
    keys = [(cfg.algorithm, cfg.season_steps, tasks[i].fit_key) for i in idx]
    entries = [judge.fit_cache.peek(k) for k in keys]
    tc = bucket_length(FULL_TC)
    values = np.zeros((len(idx), tc), np.float32)
    mask = np.zeros((len(idx), tc), bool)
    values[:, :FULL_TC] = cur[idx]
    mask[:, :FULL_TC] = True
    nidx = np.full(len(idx), FULL_TC - 1, np.int32)
    thr, bnd, mlb = cfg.anomaly.gather([tasks[i].metric_type for i in idx])
    kw = {}
    if canary:
        kw["base_values"] = np.zeros_like(values)
        kw["base_values"][:, :FULL_TC] = base[idx]
        kw["base_mask"] = mask.copy()
    if cfg.algorithm in GAP_SENSITIVE_FITS:
        kw["gap_steps"] = _gap_steps([tasks[i] for i in idx])
    return idx, (values, mask, keys, entries, nidx, thr, bnd, mlb), kw


def flag_cols(verdict, cur_times) -> np.ndarray:
    """Flagged current-window positions of an object-path verdict."""
    return np.searchsorted(cur_times, np.asarray(verdict.anomaly_pairs[0::2], np.int64))


def same_object_ticks(got, want, n: int, tol: float, what: str) -> None:
    for g, w in zip(got[:n], want[:n]):
        check(g.verdict == w.verdict, f"{what}: verdict of {g.job_id} differs from the CPU judge")
        check(g.anomaly_pairs == w.anomaly_pairs, f"{what}: anomaly pairs of {g.job_id}")
        check(g.dist_differs == w.dist_differs, f"{what}: dist_differs of {g.job_id}")
        check(abs(g.p_value - w.p_value) <= 1e-5 * (1 + abs(w.p_value)), f"{what}: p of {g.job_id}")
        check(len(g.upper) == len(w.upper) == 1, f"{what}: band_mode='last' band length")
        check(np.allclose(g.upper, w.upper, rtol=tol, atol=tol), f"{what}: upper of {g.job_id}")
        check(np.allclose(g.lower, w.lower, rtol=tol, atol=tol), f"{what}: lower of {g.job_id}")


def run_fit_cache_ticks(judge, tasks, cur, base, n_f32: int) -> dict:
    """Ticks (a) cold, (b) warm object, (c) columnar (both buckets, then an
    async dispatch waited on a second thread) on `judge`, then (d) the
    f32 cold fit on a fresh judge over the first `n_f32` tasks. Returns
    results, counters and host-clock seconds (after a device sync)."""
    import dataclasses
    import threading

    import torch

    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import HealthJudge
    from foremast_tpu_torch.models.cache import ModelCache

    cuda = judge.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"counters": {}, "seconds": {}}

    def tick(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        out["counters"][name] = judge.device_state_counters()
        return res

    out["a"] = tick("a", lambda: judge.judge(tasks))
    out["cached_a"] = len(judge.fit_cache)
    version = judge.fit_cache.version  # every fit is put in the cache
    warm = [dataclasses.replace(t, job_id=t.job_id + "-recheck") for t in tasks]
    out["b"] = tick("b", lambda: judge.judge(warm))
    out["fitted_b"] = judge.fit_cache.version != version
    buckets = [columnar_inputs(judge, tasks, cur, base, canary) for canary in (False, True)]
    out["c"] = tick("c", lambda: [(idx, judge.judge_columnar(*args, **kw)) for idx, args, kw in buckets])

    idx, args, kw = buckets[0]
    sync()
    if cuda:
        # keep the stream busy first: a hidden synchronization inside the
        # dispatch would make it wait out the busy kernel
        busy = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        busy[0].record()
        torch.cuda._sleep(BUSY_CYCLES)
        busy[1].record()
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")  # any synchronizing torch call raises
    try:
        pending = judge.judge_columnar_async(*args, **kw)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    out["dispatch_s"] = time.perf_counter() - t0
    out["done_at_return"] = pending.dev.event.query() if cuda else True
    box = []
    waiter = threading.Thread(target=lambda: box.append(pending.wait()))
    waiter.start()
    waiter.join(timeout=120)
    out["async_s"] = time.perf_counter() - t0
    check(not waiter.is_alive() and len(box) == 1, "ColumnarPending.wait() on a second thread did not finish")
    out["c_async"] = (idx, box[0])
    out["busy_ms"] = busy[0].elapsed_time(busy[1]) if cuda else 0.0
    out["counters"]["c_async"] = judge.device_state_counters()

    scoring.set_bf16_delta(False)
    try:
        fresh = HealthJudge(judge.config, device=judge.device)
        fresh.fit_cache = ModelCache(4 * n_f32)
        fresh.band_mode = "last"
        sync()
        t0 = time.perf_counter()
        out["d"] = fresh.judge(tasks[:n_f32])
        sync()
        out["seconds"]["d"] = time.perf_counter() - t0
        out["counters"]["d"] = fresh.device_state_counters()
    finally:
        scoring.set_bf16_delta(None)
    return out


def phase_fit_cache(dev, peak_bytes: float) -> dict:
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import (
        _FIT_CHUNK,
        HealthJudge,
        _fetch,
        _pack_hist_bf16_host,
        bucket_length,
    )
    from foremast_tpu_torch.models.cache import ModelCache
    from foremast_tpu_torch.ops.windows import MetricWindows, to_device

    n = FIT_FLEET
    t0 = time.perf_counter()
    tasks, spiked, cur, base = fit_cache_fleet(n)
    print(f"phase 5: fleet of {n} tasks (Th={FULL_TH}, Tc={FULL_TC}, half canaries) built in "
          f"{time.perf_counter() - t0:.1f} s")

    def new_judge(device):
        j = HealthJudge(BrainConfig(), device=device)
        j.fit_cache = ModelCache(4 * n)
        j.band_mode = "last"
        return j

    judge = new_judge(dev)
    check(judge.device == dev, "the fit-cache judge is not on the card")
    gpu = run_fit_cache_ticks(judge, tasks, cur, base, _FIT_CHUNK)
    cpu = run_fit_cache_ticks(new_judge("cpu"), tasks, cur, base, _FIT_CHUNK)

    # (a)-(d) on the card: counts of fits and scatters, then verdicts
    ca, cb, cc = (gpu["counters"][k] for k in ("a", "b", "c"))
    n_pad_keys = 1 if bucket_length(n) > n else 0  # pad rows share the one "__pad__" key
    check(gpu["cached_a"] == n + n_pad_keys, f"cold tick cached {gpu['cached_a']} fits, want {n}")
    check(ca["misses"] == n + n_pad_keys, f"cold tick scattered {ca['misses']} rows")
    check(not gpu["fitted_b"], "the warm object tick fitted rows")
    check(cb["misses"] == ca["misses"], "warm object tick scattered rows")
    check(cb["hits"] - ca["hits"] >= n, "warm object tick did not gather every row")
    check(cc["misses"] == cb["misses"] and cc["evictions"] == 0, "columnar ticks scattered rows")
    check(gpu["counters"]["d"]["misses"] >= _FIT_CHUNK, "the f32 cold fit scattered no rows")
    for k in ("a", "b", "c", "c_async", "d"):
        check(gpu["counters"][k] == cpu["counters"][k],
              f"({k}) arena counters {gpu['counters'][k]} differ from the CPU judge's {cpu['counters'][k]}")

    ct = tasks[0].cur_times
    verdict_a = np.asarray([v.verdict for v in gpu["a"]])
    flags_a = [flag_cols(v, ct) for v in gpu["a"]]
    check(all(verdict_a[spiked] == scoring.UNHEALTHY), "a spiked task was not judged UNHEALTHY")
    for name in ("b", "d"):
        got = gpu[name]
        check([v.verdict for v in got] == verdict_a[: len(got)].tolist(), f"({name}) verdicts differ from (a)")
        check(all(np.array_equal(flag_cols(v, ct), f) for v, f in zip(got, flags_a)), f"({name}) flags differ")
    for idx, (v8, anoms, ub, lb, ps, differs) in gpu["c"] + [gpu["c_async"]]:
        check(np.array_equal(v8, verdict_a[idx]), "(c) columnar verdicts differ from (a)")
        for row, i in zip(anoms, idx):
            check(np.array_equal(np.flatnonzero(row), flags_a[i]), "(c) columnar flags differ from (a)")
        check(np.allclose(ub, [gpu["a"][i].upper[-1] for i in idx], rtol=1e-6, atol=1e-6),
              "(c) columnar bands differ from (a)")

    # the first rows against the CPU judge run the same way
    n_cmp = 128
    for name, tol in (("a", 1e-5), ("b", 1e-5), ("d", 1e-4)):
        same_object_ticks(gpu[name], cpu[name], n_cmp, tol, f"({name})")
    for (idx, g), (_, w) in zip(gpu["c"], cpu["c"]):
        check(np.array_equal(g[0][:n_cmp], w[0][:n_cmp]) and np.array_equal(g[1][:n_cmp], w[1][:n_cmp]),
              "(c) columnar verdicts or flags differ from the CPU judge")
        check(np.allclose(g[2][:n_cmp], w[2][:n_cmp], rtol=1e-5, atol=1e-5), "(c) bands differ from the CPU")
    agree = sum(g.verdict == w.verdict and g.anomaly_pairs == w.anomaly_pairs for g, w in zip(gpu["a"], cpu["a"]))
    counts = np.bincount(verdict_a, minlength=3).tolist()
    print(f"phase 5: verdicts {counts} (healthy/unhealthy/unknown) equal across (a) cold, (b) warm, "
          f"(c) columnar and (d) f32 cold ({_FIT_CHUNK} rows); all {int(spiked.sum())} spiked tasks UNHEALTHY; "
          f"first {n_cmp} rows equal the CPU judge ({agree} of {n} cold rows equal it); "
          f"arena counters equal the CPU judge's at every tick")

    # wall clock of each tick on the card, and the cold tick's uploads
    th = bucket_length(FULL_TH)
    tc = bucket_length(FULL_TC)
    chunks = [min(_FIT_CHUNK, n - c0) for c0 in range(0, n, _FIT_CHUNK)]
    hist_bytes = sum(bucket_length(c) * (th * 2 + 8) for c in chunks)
    rows_b = bucket_length(n)
    other_bytes = rows_b * (2 * tc * 5 + 16) + rows_b * (7 * 4 + 8)  # cur+base, operands, scatter, rows
    s = gpu["seconds"]
    for name, what, rows in (
        ("a", f"cold object tick (bf16 fit in {len(chunks)} chunks, scatter, judge)", n),
        ("b", "warm object tick (0 fits, 0 scatters)", n),
        ("c", "columnar warm ticks (baseline-less + canary buckets)", n),
        ("d", f"f32 cold object tick ({_FIT_CHUNK} rows, masked_stats)", _FIT_CHUNK),
    ):
        print(f"phase 5: ({name}) {what}: {s[name]:.3f} s = {rows / s[name]:.0f} windows/s "
              f"(CPU judge: {cpu['seconds'][name]:.3f} s)")
    print(f"phase 5: (a) cold tick H2D {hist_bytes + other_bytes} B "
          f"(history {hist_bytes} B as anchor + bf16 deltas at Th bucket {th} + lens)")
    print(f"phase 5: (c) async columnar bucket of {len(gpu['c_async'][0])} rows queued behind a "
          f"{gpu['busy_ms']:.1f} ms busy kernel: dispatch returned after {gpu['dispatch_s'] * 1e3:.3f} ms "
          f"(device done at return: {gpu['done_at_return']}); wait() on a second thread done "
          f"{gpu['async_s'] * 1e3:.3f} ms after dispatch began")
    check(not gpu["done_at_return"] and gpu["dispatch_s"] * 1e3 < gpu["busy_ms"],
          "judge_columnar_async waited for the device")

    # one cold chunk stage by stage: host packing, pinned staging, the
    # copy to the card, then the fit and its one copy back
    ragged = [(t.hist_times, t.hist_values) for t in tasks[:_FIT_CHUNK]]
    t0 = time.perf_counter()
    anchor, delta, lens = _pack_hist_bf16_host(ragged, th)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    pinned = delta.pin_memory()
    t_pin = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    delta_dev = pinned.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fetch(scoring.fit_ma_from_bf16_delta(to_device(anchor, dev), delta_dev, to_device(lens, dev)))
    t_fit = time.perf_counter() - t0
    print(f"phase 5: one cold chunk of {_FIT_CHUNK} rows: host packing {t_pack:.4f} s, pinned staging "
          f"{t_pin:.4f} s, H2D {t_h2d:.4f} s ({delta.numel() * 2 / t_h2d / 1e9:.1f} GB/s), "
          f"fit + D2H {t_fit:.4f} s (host clock)")
    arena = next(iter(judge._arenas.values()))
    print(f"phase 5: arena {arena.counters()} device_bytes={arena.device_bytes()}")

    # score_from_arena alone at the steady-state batch, against its bound
    B = FULL_B
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, arena.cap, (B,), generator=g).to(dev)
    batch = scoring.ScoreBatch(
        historical=MetricWindows(
            values=torch.zeros((B, 0), device=dev), mask=torch.zeros((B, 0), dtype=torch.bool, device=dev),
            times=None,
        ),
        current=MetricWindows(
            values=(1 + 0.05 * torch.randn((B, FULL_TC), generator=g)).to(dev),
            mask=torch.ones((B, FULL_TC), dtype=torch.bool, device=dev), times=None,
        ),
        baseline=MetricWindows(
            values=torch.zeros((B, FULL_TC), device=dev),
            mask=torch.zeros((B, FULL_TC), dtype=torch.bool, device=dev), times=None,
        ),
        threshold=torch.full((B,), 2.0, device=dev),
        bound=torch.full((B,), 3, dtype=torch.int32, device=dev),
        min_lower_bound=torch.zeros(B, device=dev),
        min_points=torch.full((B,), 10, dtype=torch.int32, device=dev),
    )
    pw = dict(pairwise_algorithm=scoring.PAIRWISE_NONE, p_threshold=0.05, min_mw=20, min_wilcoxon=20,
              min_kruskal=5, min_friedman=20)
    res = scoring.score_from_arena(batch, *arena.state, rows, **pw)
    ref = scoring.score_from_arena(cpu_rows(batch, 256), *(t.cpu() for t in arena.state), rows[:256].cpu(), **pw)
    same_result(res, ref, 1e-6, "score_from_arena")
    ms = cuda_ms(lambda: scoring.score_from_arena(batch, *arena.state, rows, **pw), iters=20)
    # current values + mask, four per-row operands + the row index, the
    # gathered state (24 B a row at m=1), outputs (verdict, flags, bands, p, differs)
    nbytes = B * (FULL_TC * 5 + 16 + 8) + B * arena.row_bytes + B * (4 + FULL_TC * 9 + 4 + 1)
    bound_ms = nbytes / peak_bytes * 1e3
    print(f"phase 5: score_from_arena B={B} Tc={FULL_TC} (PAIRWISE_NONE, arena of {arena.cap} rows): "
          f"{ms:.4f} ms per batch = {B / (ms * 1e-3):.0f} windows/s; bound {bound_ms:.4f} ms "
          f"({nbytes} B at {peak_bytes / 1e12:.2f} TB/s; bytes)")
    return {"seconds": s, "score_from_arena_ms": ms, "score_from_arena_bound_ms": bound_ms}


# ---------------------------------------------------------------------------
# phase 6: the worker's fleet tick (claim -> fetch -> judge -> write back)
# ---------------------------------------------------------------------------

ALIASES = ("latency", "error4xx", "error5xx", "tps")
WORKER_DOCS = 4096  # x 4 aliases = 16,384 windows, phase 5's width
F32_DOCS = 1024  # (d): one 4,096-window cold chunk on the f32 route


def worker_fleet(n_docs: int, t_now: int, seed: int = 13):
    """The shape of `benchmarks/worker_bench.py`'s fleet: one document per
    service x 4 aliases, 7-day settled histories at a 60 s step, 30-point
    current windows riding inside the band (so the fleet stays on the
    re-check path, endTime an hour out), every even doc a canary with a
    baseline URL on every alias (its window the current signal plus
    noise). Histories lie on a 1/64 grid, as in phase 5. Returns
    (documents as JSON, URL -> series, each doc's latency current URL)."""
    from foremast_tpu_torch.jobs import Document

    rng = np.random.default_rng(seed)
    ht = t_now - 86_400 * 7 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(FULL_TC, dtype=np.int64)
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_now + 3600))
    hist = np.empty((n_docs * len(ALIASES), FULL_TH), np.float32)
    for r0 in range(0, len(hist), 4096):  # in slices: a float64 [n, Th] would be 1.3 GB
        rows = hist[r0 : r0 + 4096]
        rows[:] = np.round(64 * rng.normal(1.0, 0.1, rows.shape)) / 64
    cv = (1.0 + 0.05 * np.sin(np.arange(FULL_TC) / 3.0)).astype(np.float32)
    data, docs, latency = {}, [], []
    for i in range(n_docs):
        parts = {"current": [], "historical": [], "baseline": []}
        for k, a in enumerate(ALIASES):
            cur_url = f"http://prom/cur?q={a}:app{i}&end={int(ct[0]) - 60}&step=60"
            hist_url = f"http://prom/hist?q={a}:app{i}&end={int(ht[-1]) + 60}&step=60"
            data[cur_url] = (ct, cv)
            if a == "latency":
                latency.append(cur_url)
            data[hist_url] = (ht, hist[i * len(ALIASES) + k])
            parts["current"].append(f"{a}== {cur_url}")
            parts["historical"].append(f"{a}== {hist_url}")
            if i % 2 == 0:
                base_url = f"http://prom/base?q={a}:app{i}&step=60"
                data[base_url] = (ct - 3600, (cv + rng.normal(0, 0.01, FULL_TC)).astype(np.float32))
                parts["baseline"].append(f"{a}== {base_url}")
        docs.append(
            Document(
                id=f"job-{i}", app_name=f"app{i}", end_time=end_time,
                current_config=" ||".join(parts["current"]),
                historical_config=" ||".join(parts["historical"]),
                baseline_config=" ||".join(parts["baseline"]),
                strategy="canary" if i % 2 == 0 else "continuous",
            ).to_json()
        )
    return docs, data, latency


def run_worker_ticks(device, docs, data, latency, t_now: int, tracer=None) -> dict:
    """On one port worker over its own store (copies of `docs`) and
    source: (a) cold tick, (b) warm tick, (c) warm tick with the last 3
    latency points of every 16th doc spiked; then (d) the f32 cold tick of
    a fresh worker over the first F32_DOCS docs. After each: what the
    store holds, the arena counters, the fit-cache size, the columnar
    calls, the host-clock seconds (after a device sync) and the tracer's
    stage breakdown."""
    import gc

    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.metrics.source import MetricSource

    class ArraySource(MetricSource):
        concurrent_fetch = False  # in-memory: no fetch threads

        def __init__(self, series):
            self.data = dict(series)

        def fetch(self, url: str):
            return self.data[url]

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def new_worker(doc_json, tr=None):
        store = InMemoryStore()
        for d in doc_json:
            store.create(Document.from_json(d))
        cfg = BrainConfig(max_cache_size=len(doc_json) * len(ALIASES) + 64)
        worker = BrainWorker(
            store, ArraySource(data), config=cfg, device=device,
            claim_limit=len(doc_json), worker_id=f"smoke-{device}", tracer=tr,
        )
        return worker, store

    def written(store):
        return {
            d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
            for d in store._docs.values()
        }

    worker, store = new_worker(docs, tracer)
    if cuda:
        worker.warmup()
        check(len(worker._fit_cache) == 0 and not worker.judge._arenas, "warmup touched the real caches")
    calls = []
    orig = worker.judge.judge_columnar
    worker.judge.judge_columnar = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
    host = {}  # seconds of the host steps that no span covers

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] = host.get(name, 0.0) + time.perf_counter() - t0

        return run

    worker._admit_fast = timed("admission walk", worker._admit_fast)
    worker._pack_uni = timed("columnar packing", worker._pack_uni)
    out = {}

    gc_acc = [0.0, 0.0]  # collector pause seconds in the tick, last start

    def gc_timer(phase, info):
        # the collector's pauses inside a tick, which no span attributes
        if phase == "start":
            gc_acc[1] = time.perf_counter()
        else:
            gc_acc[0] += time.perf_counter() - gc_acc[1]

    def tick(name, now, w=worker, st=store):
        calls.clear()
        host.clear()
        versions = (w._fit_cache.version, w.judge.device_state_counters()["misses"])
        gc_acc[0] = 0.0
        sync()
        gc.callbacks.append(gc_timer)
        t0 = time.perf_counter()
        try:
            n = w.tick(now=now)
            sync()
        finally:
            gc.callbacks.remove(gc_timer)
        out[name] = dict(
            seconds=time.perf_counter() - t0, docs=n, written=written(st),
            gc_seconds=gc_acc[0], host=dict(host),
            counters=w.judge.device_state_counters(), fits=len(w._fit_cache),
            columnar=list(calls), refit=w._fit_cache.version != versions[0],
            scattered=w.judge.device_state_counters()["misses"] - versions[1],
            stages=dict(tracer.last_stage_seconds) if tracer is not None and w is worker else None,
            fast=dict(w._fast_kinds),
        )

    tick("a", t_now + 150)
    tick("b", t_now + 200)
    spiked = range(5, len(docs), 16)
    for i in spiked:
        t, v = worker.source.data[latency[i]]
        v = v.copy()
        v[-3:] = 40.0
        worker.source.data[latency[i]] = (t, v)
    tick("c", t_now + 250)
    out["spiked"] = [f"job-{i}" for i in spiked]

    scoring.set_bf16_delta(False)
    try:
        fresh, fstore = new_worker(docs[:F32_DOCS])
        tick("d", t_now + 150, w=fresh, st=fstore)
    finally:
        scoring.set_bf16_delta(None)
    return out


def phase_worker(dev, smi: str, columnar_s: float) -> dict:
    """Phase 6: the port's BrainWorker drives a 4,096-doc fleet on the card
    (cold, warm, spiked warm, f32 cold) and on the CPU; every tick's
    writes and arena counters must be equal, and the fast-path invariants
    must hold."""
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED
    from foremast_tpu_torch.observe.spans import Tracer

    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"  # the monolithic tick (no sliced sweeps yet)
    t_now = int(time.time())
    t0 = time.perf_counter()
    docs, data, latency = worker_fleet(WORKER_DOCS, t_now)
    n_win = WORKER_DOCS * len(ALIASES)
    print(f"phase 6: fleet of {WORKER_DOCS} docs x {len(ALIASES)} aliases = {n_win} windows "
          f"(Th={FULL_TH}, Tc={FULL_TC}, half canaries) built in {time.perf_counter() - t0:.1f} s")
    tracer = Tracer()
    gpu = run_worker_ticks(dev, docs, data, latency, t_now, tracer)
    cpu = run_worker_ticks("cpu", docs, data, latency, t_now)

    half = n_win // 2
    a, b, c, d = (gpu[k] for k in "abcd")
    check(a["docs"] == b["docs"] == c["docs"] == WORKER_DOCS and d["docs"] == F32_DOCS, "a tick lost docs")
    check(not a["columnar"] and a["fast"] == {"univariate": 0, "baseline": 0}, "(a) cold tick took the fast path")
    check(a["fits"] == n_win and a["scattered"] == n_win, f"(a) cold tick: {a['fits']} fits, {a['scattered']} scatters")
    for name, t in (("b", b), ("c", c)):
        check(sorted(t["columnar"]) == [half, half], f"({name}) columnar calls {t['columnar']}, want two of {half}")
        check(not t["refit"] and t["scattered"] == 0, f"({name}) warm tick fitted or scattered rows")
    check(b["fast"] == {"univariate": WORKER_DOCS // 2, "baseline": WORKER_DOCS // 2}, f"(b) buckets {b['fast']}")
    check(d["fits"] == F32_DOCS * len(ALIASES), "(d) f32 cold tick did not fit every window")
    unhealthy = sorted(k for k, v in c["written"].items() if json.loads(v)[0] == STATUS_COMPLETED_UNHEALTH)
    check(unhealthy == sorted(gpu["spiked"]), f"(c) flagged {len(unhealthy)} docs, want the {len(gpu['spiked'])} spiked")
    for doc_id in gpu["spiked"]:
        info = json.loads(c["written"][doc_id])[3]
        check(info["values"]["latency"][1::2][-3:] == [40.0] * 3, f"(c) {doc_id}: spike not in anomaly_info")
    for name in "ab":
        check({json.loads(v)[0] for v in gpu[name]["written"].values()} == {STATUS_PREPROCESS_COMPLETED},
              f"({name}) a healthy re-check doc left the re-check loop")
    for name in "abcd":
        check(gpu[name]["written"] == cpu[name]["written"],
              f"({name}) writes differ from the CPU worker's on "
              f"{sum(gpu[name]['written'][k] != v for k, v in cpu[name]['written'].items())} docs")
        check(gpu[name]["counters"] == cpu[name]["counters"],
              f"({name}) arena counters {gpu[name]['counters']} differ from the CPU worker's {cpu[name]['counters']}")
    print(f"phase 6: every tick's (status, code, reason, anomaly_info) of every doc and the arena counters equal "
          f"the CPU worker's; (b) and (c) took two columnar calls of {half} rows with 0 fits and 0 scatters; "
          f"(c) flagged exactly the {len(unhealthy)} spiked docs")

    print(f"phase 6 on {smi}:")
    for name, what, windows in (
        ("a", "cold tick (object path: bf16 fits in 4 chunks, scatter, judge, write)", n_win),
        ("b", "warm tick (columnar, both buckets)", n_win),
        ("c", "spiked warm tick (columnar)", n_win),
        ("d", f"f32 cold tick of {F32_DOCS} docs (masked_stats)", F32_DOCS * len(ALIASES)),
    ):
        t = gpu[name]
        print(f"phase 6: ({name}) {what}: {t['seconds']:.3f} s = {t['docs'] / t['seconds']:.0f} docs/s, "
              f"{windows / t['seconds']:.0f} windows/s (CPU worker: {cpu[name]['seconds']:.3f} s)")
    for name in "abc":
        t = gpu[name]
        stages = ", ".join(f"{k} {v:.4f}" for k, v in sorted(t["stages"].items(), key=lambda kv: -kv[1]))
        unspanned = ", ".join(f"{k} {v:.4f}" for k, v in t["host"].items())
        print(f"phase 6: ({name}) stage seconds: {stages}; outside the stage spans "
              f"{t['seconds'] - sum(t['stages'].values()):.4f}: {unspanned}, gc pauses {t['gc_seconds']:.4f}")
    print(f"phase 6: (b) warm worker tick {b['seconds']:.3f} s against phase 5 (c)'s columnar judge calls "
          f"{columnar_s:.3f} s: {b['seconds'] / columnar_s:.1f}x, the worker's share above the judge "
          f"{1 - columnar_s / b['seconds']:.1%}")
    return {k: gpu[k]["seconds"] for k in "abcd"}


# ---------------------------------------------------------------------------
# phase 7: the univariate forecaster family at the default daily season
# ---------------------------------------------------------------------------

SEASON = 1440  # ML_SEASON_STEPS default: a daily cycle at the 60 s step
TH_BUCKET = 16384  # bucket_length(10080): the judge's padded history length
UNIVARIATE = (
    "moving_average_all", "moving_average", "ewma", "exponential_smoothing",
    "double_exponential_smoothing", "holtwinters", "holt_winters", "phase_means",
    "auto_univariate", "seasonal", "prophet", "seasonal_hourly",
)
HW_ALGOS = ("holtwinters", "holt_winters")
KINDS = ("flat", "seasonal", "sharp-seasonal", "trend", "shift")
# state tolerance of each fit, card against CPU: the recurrences agree to
# f32 rounding of their initial state, the others sum in other orders
FIT_TOL = {
    "moving_average_all": 1e-4, "moving_average": 1e-4, "ewma": 1e-4, "exponential_smoothing": 1e-4,
    "double_exponential_smoothing": 2e-4, "holtwinters": 2e-4, "holt_winters": 2e-4,
    "phase_means": 1e-3, "auto_univariate": 1e-3, "seasonal": 1e-3, "prophet": 1e-3, "seasonal_hourly": 1e-3,
}
EDGE = 1e-5  # a flag may differ from the CPU only this close (relative) to a band edge
CMP_TASKS = 1024  # 7(c): tasks held to a CPU judge
SEASONAL_DOCS = 1024  # 7(d): x 4 aliases = 4,096 windows, auto_univariate at m = 1440
HW_DOCS = 256  # 7(d): x 4 aliases = 1,024 windows, holt_winters at m = 24
HW_SEASON = 24  # the JAX package's season-blocked regime (m <= 64)
SEASONAL_ALIASES = {"latency": "seasonal", "error4xx": "flat", "error5xx": "trend", "tps": "sharp-seasonal"}


def quality_signal(kind: str, t, period: int, th: int):
    """`benchmarks/quality.py`'s `gen` signals, copied (that module imports
    JAX): flat, seasonal, sharp-seasonal (a 10-step daily burst), trend
    and shift (a mid-history level step on the seasonal signal)."""
    if kind == "flat":
        return 1.0 + 0.0 * t
    if kind == "seasonal":
        return 1.0 + 0.5 * np.sin(2 * np.pi * t / period)
    if kind == "sharp-seasonal":
        return 1.0 + 0.5 * ((t % period) < max(10, period // 144)).astype(float)
    if kind == "trend":
        return 1.0 + 0.002 * t
    if kind == "shift":
        return 1.0 + 0.5 * np.sin(2 * np.pi * t / period) + 0.5 * (t >= 0.55 * th)
    raise ValueError(kind)


def quality_fleet(n: int, seed: int):
    """n rows of the five kinds in even shares at period SEASON: 7-day
    histories and 30-point currents continuing the signal, N(0, 0.05)
    noise on both, every 16th current spiked by +40."""
    rng = np.random.default_rng(seed)
    hist = np.empty((n, FULL_TH), np.float32)
    cur = np.empty((n, FULL_TC), np.float32)
    t_hist, t_cur = np.arange(FULL_TH), FULL_TH + np.arange(FULL_TC)
    for k, kind in enumerate(KINDS):
        idx = np.arange(k, n, len(KINDS))
        for c0 in range(0, len(idx), 1024):  # in slices: float64 noise of [n, Th] is large
            rows = idx[c0 : c0 + 1024]
            noise = 0.05 * rng.standard_normal((len(rows), FULL_TH), dtype=np.float32)
            hist[rows] = quality_signal(kind, t_hist, SEASON, FULL_TH)[None, :] + noise
        cur[idx] = quality_signal(kind, t_cur, SEASON, FULL_TH)[None, :] + 0.05 * rng.standard_normal((len(idx), FULL_TC))
    spiked = np.arange(n) % 16 == 5
    cur[spiked, FULL_TC // 2] += 40.0
    return hist, cur, spiked


def near_edge(cur, upper, lower) -> np.ndarray:
    """[B] rows with a current point within EDGE of a band edge."""
    out = np.zeros(cur.shape[0], bool)
    for edge in (upper, lower):
        out |= (np.abs(cur - edge) <= EDGE * (1 + np.abs(edge))).any(axis=1)
    return out


def same_judgment_or_edge(got, want, cur, what: str, skip) -> int:
    """ScoreResults of the card and the CPU (first rows): verdicts and flags
    equal except on rows with a point within EDGE of the CPU's band edge
    (and `skip` rows); p within 1e-5. Returns the count of edge rows that
    differ."""
    import torch

    n = want.verdict.shape[0]
    gv, wv = got.verdict[:n].cpu().numpy(), want.verdict.numpy()
    ga, wa = got.anomalies[:n].cpu().numpy(), want.anomalies.numpy()
    differ = ((gv != wv) | (ga != wa).any(axis=1)) & ~skip
    edge = near_edge(cur[:n], want.upper.numpy(), want.lower.numpy())
    check(not (differ & ~edge).any(), f"{what}: verdicts or flags of rows {np.flatnonzero(differ & ~edge)[:8]} "
          "differ from the CPU away from any band edge")
    check(torch.equal(got.dist_differs[:n].cpu(), want.dist_differs), f"{what}: differs bits differ")
    close_err(got.p_value[:n].cpu(), want.p_value, 1e-5)
    return int(differ.sum())


def hw_flips(values, mask, values_cpu, mask_cpu, what: str) -> np.ndarray:
    """Rows whose Holt-Winters grid choice on the card differs from the
    CPU's; each must be a near tie (SSE gap under 1e-5 relative), printed
    with its gap. Returns the [n] bool mask of those rows."""
    from foremast_tpu_torch.ops import forecasters as F
    from foremast_tpu_torch.ops import kernels as K

    n = values_cpu.shape[0]
    counted = dict(K.LAUNCHES)  # a comparison: its launches do not count
    g = F.hw_grid_sse(values[:n], mask[:n], SEASON).cpu().numpy()
    K.LAUNCHES.update(counted)
    c = F.hw_grid_sse(values_cpu, mask_cpu, SEASON).numpy()
    flips = g.argmin(axis=0) != c.argmin(axis=0)
    for r in np.flatnonzero(flips):
        gap = abs(c[g[:, r].argmin(), r] - c[:, r].min()) / max(c[:, r].min(), 1e-30)
        print(f"phase 7: {what}: row {r} grid choice {g[:, r].argmin()} on the card, {c[:, r].argmin()} on the "
              f"CPU, SSE gap {gap:.3e}")
        check(gap < 1e-5, f"{what}: a grid choice differs from the CPU with an SSE gap of {gap:.3e}")
    return flips


def same_bits(got, want, what: str) -> float:
    """Fails unless `got` and `want` hold the same bits (dtype, shape and
    every value, zero signs included); returns the worst |got - want|
    over the finite values (0 when they pass)."""
    import torch

    worst = 0.0
    for name, a, w in zip(("level", "trend", "season", "sse", "pred"), got, want):
        if a is None and w is None:
            continue
        check(a is not None and w is not None and a.dtype == w.dtype and a.shape == w.shape,
              f"{what}: {name} has another dtype or shape than the plain version")
        ints = torch.int32 if a.dtype == torch.float32 else torch.int64
        same = torch.equal(a.contiguous().view(ints), w.contiguous().view(ints))
        check(same, f"{what}: {name} differs from the plain version")
        diff = (a.double() - w.double()).abs()
        diff = diff[torch.isfinite(diff)]
        if diff.numel():
            worst = max(worst, float(diff.max()))
    return worst


def scan_mask(b: int, t_len: int) -> np.ndarray:
    """7(a)'s masks: rows cycle through all-masked, one valid point, an
    interior gap, leading masked steps, trailing padding and a full row;
    every second block of 32 rows ends by T/3 but for its last row, which
    starts at T/2, after every other row of its block has ended."""
    r = np.arange(b)
    k = r % 6
    mk = np.ones((b, t_len), bool)
    mk[k == 0] = False
    mk[k == 1] = False
    if t_len:
        mk[k == 1, t_len // 2] = True
    mk[k == 2, t_len // 4 : t_len // 2] = False
    mk[k == 3, : t_len // 3] = False
    mk[k == 4, (2 * t_len) // 3 :] = False
    early = (r // 32) % 2 == 1
    mk[early, t_len // 3 :] = False
    late = early & (r % 32 == 31)
    mk[late] = False
    mk[late, t_len // 2 :] = True
    return mk


def phase_scan_kernels_vs_plain(dev) -> dict:
    """7(a): holt_winters_scan (grid G=8 and per-series with predictions)
    and holt_scan against their plain versions on the same CUDA tensors,
    bit for bit, at edge shapes of the kernels' layout: the season ring's
    depth D and D+1, the shared-memory season's last m and the first in
    device memory, T around one tile, B around a block of rows, rows of
    one block that end at different steps, and more parameter sets than
    one launch takes (the wrapper splits them). The layout is read from
    the built kernel."""
    import torch

    from foremast_tpu_torch.ops import forecasters as F
    from foremast_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(77)
    worst = {"holt_winters_scan": 0.0, "holt_scan": 0.0}
    grid = torch.tensor(F._HW_GRID, dtype=torch.float32, device=dev)
    layout = K.scan_layout()
    tile, ring = layout["tile"], layout["ring"]
    m_smem = layout["smem_m"]  # the last m whose season stays on chip
    check(K._MAX_G == layout["max_g"], f"kernels._MAX_G is {K._MAX_G}, the entry point takes {layout['max_g']}")
    hw_cases = [(37, m, t_len)
                for m in sorted({1, ring, ring + 1, 24, 60, m_smem, m_smem + 1, SEASON})
                for t_len in sorted({0, 1, max(m - 1, 0), 2 * m - 1, 2 * m, 2 * m + 1, 2 * m + 37})]
    hw_cases += [(b, m, t_len) for b in (33, 129) for m in (1, 24, m_smem + 1)
                 for t_len in (tile - 1, tile, tile + 1, 3 * tile + 5)]
    for b, m, t_len in hw_cases:
        v = 2.0 + np.sin(2 * np.pi * np.arange(t_len) / max(m, 2))[None, :] + rng.normal(0, 0.1, (b, t_len))
        values = torch.from_numpy(v.astype(np.float32)).to(dev)
        mask = torch.from_numpy(scan_mask(b, t_len)).to(dev)
        il, isn = F._hw_init(values, mask, m)
        what = f"holt_winters_scan B={b} m={m} T={t_len}"
        got = K.holt_winters_scan(values, mask, il, isn, grid)
        want = K._holt_winters_scan_plain(values, mask, il, isn, grid, False, False)
        worst["holt_winters_scan"] = max(worst["holt_winters_scan"], same_bits(got, want, what + " grid"))
        params = grid[got[3].argmin(dim=0)].contiguous()
        got = K.holt_winters_scan(values, mask, il, isn, params, per_series=True, want_pred=True)
        want = K._holt_winters_scan_plain(values, mask, il, isn, params, True, True)
        worst["holt_winters_scan"] = max(worst["holt_winters_scan"], same_bits(got, want, what + " per-series"))
    # more parameter sets than a launch takes: two launches, one result
    b, m, t_len = 37, 24, 85
    g_split = layout["max_g"] + 44
    values = torch.from_numpy(rng.normal(2.0, 0.3, (b, t_len)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(scan_mask(b, t_len)).to(dev)
    il, isn = F._hw_init(values, mask, m)
    params = torch.from_numpy(rng.uniform(0.02, 0.9, (g_split, 3)).astype(np.float32)).to(dev)
    before = K.LAUNCHES["holt_winters_scan"]
    got = K.holt_winters_scan(values, mask, il, isn, params)
    split = K.LAUNCHES["holt_winters_scan"] - before
    check(split == 2, f"holt_winters_scan at G={g_split} ran {split} launches, not 2")
    want = K._holt_winters_scan_plain(values, mask, il, isn, params, False, False)
    worst["holt_winters_scan"] = max(worst["holt_winters_scan"],
                                     same_bits(got, want, f"holt_winters_scan G={g_split} B={b} m={m} T={t_len}"))
    holt_cases = [(b, t_len) for b in (1, 33, 37, 129)
                  for t_len in (0, 1, 5, tile - 1, tile, tile + 1, 131, FULL_TH)]
    for b, t_len in holt_cases:
        v = (rng.normal(0, 1, (b, t_len)).cumsum(axis=1) * 0.1 + 3.0).astype(np.float32)
        mk = scan_mask(b, t_len) & (rng.random((b, t_len)) > 0.2)
        values = torch.from_numpy(v).to(dev)
        mask = torch.from_numpy(mk).to(dev)
        per_series = tuple(torch.from_numpy(rng.uniform(lo, hi, b).astype(np.float32)).to(dev)
                           for lo, hi in ((0.05, 0.9), (0.01, 0.5)))
        for alpha, beta in ((0.3, 0.1), per_series):
            got = K.holt_scan(values, mask, alpha, beta)
            want = K._holt_scan_plain(values, mask, K._row(alpha, b, torch.float32, dev),
                                      K._row(beta, b, torch.float32, dev))
            worst["holt_scan"] = max(worst["holt_scan"], same_bits(got, want, f"holt_scan B={b} T={t_len}"))
    torch.cuda.synchronize()
    print(f"phase 7: (a) holt_winters_scan bit for bit equal to its plain version (level, trend, season, SSE; "
          f"then pred) at {len(hw_cases)} (B, m, T) cases, grid G=8 then per-series with predictions "
          f"(m in 1, {ring}, {ring + 1}, 24, 60, {m_smem}, {m_smem + 1}, {SEASON}; T in 0, 1, m-1, 2m-1, 2m, 2m+1, "
          f"2m+37 at B=37; T in {tile - 1}, {tile}, {tile + 1}, {3 * tile + 5} at B in 33, 129), so 0 grid-choice "
          f"differences; and a grid of G={g_split} in two launches")
    print(f"phase 7: (a) holt_scan bit for bit equal to its plain version at {2 * len(holt_cases)} cases (B in 1, 33, "
          f"37, 129; T in 0, 1, 5, {tile - 1}, {tile}, {tile + 1}, 131, {FULL_TH}; scalar and per-series parameters)")
    return worst


def phase_cold_fits(dev) -> dict:
    """7(b): one cold-fit chunk (4,096 rows, Th=10,080 in its 16,384 bucket,
    m=1440) of every univariate algorithm through `fit_forecast` and
    `fit_forecast_bf16_delta`, timed with CUDA events; the first 256 rows
    against the CPU: state to tolerance, equal verdicts and flags after
    `score_from_state`."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import _pack_hist_bf16_host
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.ops.windows import MetricWindows

    n, n_cmp = FLEET, min(256, FLEET)
    t0 = time.perf_counter()
    hist, cur, _ = quality_fleet(n, seed=71)
    lens = np.full(n, FULL_TH, np.int32)
    lens[7::50] = 2 * SEASON - 1  # under two cycles of real points: the mean model
    lens[11::50] = FULL_TH - 3 * SEASON
    values = np.zeros((n, TH_BUCKET), np.float32)
    mask = np.arange(TH_BUCKET)[None, :] < lens[:, None]
    values[:, :FULL_TH] = hist
    mask[13::50, 3000:3400] = False  # interior gaps (the bf16 route left-packs them)
    values[~mask] = 0.0
    anchor, delta, plens = _pack_hist_bf16_host([(None, values[i][mask[i]]) for i in range(n)], TH_BUCKET)
    thr, bnd, mlb = BrainConfig().anomaly.gather(["latency"] * n)
    dv, dm = torch.from_numpy(values).to(dev), torch.from_numpy(mask).to(dev)
    d16 = (torch.from_numpy(anchor).to(dev), delta.to(dev), torch.from_numpy(plens).to(dev))
    c16 = (torch.from_numpy(anchor[:n_cmp]), delta[:n_cmp], torch.from_numpy(plens[:n_cmp]))
    cv, cm = torch.from_numpy(values[:n_cmp]), torch.from_numpy(mask[:n_cmp])
    n_hist = torch.from_numpy(mask.sum(axis=1).astype(np.int32))

    def batch(rows, device):
        def win(v, m):
            return MetricWindows(values=torch.from_numpy(v).to(device), mask=torch.from_numpy(m).to(device), times=None)

        return scoring.ScoreBatch(
            historical=win(np.zeros((rows, 0), np.float32), np.zeros((rows, 0), bool)),
            current=win(cur[:rows], np.ones((rows, FULL_TC), bool)),
            baseline=win(np.zeros((rows, FULL_TC), np.float32), np.zeros((rows, FULL_TC), bool)),
            threshold=torch.from_numpy(thr[:rows]).to(device), bound=torch.from_numpy(bnd[:rows]).to(device),
            min_lower_bound=torch.from_numpy(mlb[:rows]).to(device),
            min_points=torch.full((rows,), 10, dtype=torch.int32, device=device),
        )

    gb, cb = batch(n, dev), batch(n_cmp, "cpu")
    pw = dict(pairwise_algorithm=scoring.PAIRWISE_NONE)
    torch.cuda.synchronize()
    print(f"phase 7: (b) chunk of {n} rows (Th={FULL_TH} in a {TH_BUCKET} bucket, m={SEASON}, the five quality "
          f"kinds; short, late-ending and gapped rows) built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for algo in UNIVARIATE:
        kw = dict(algorithm=algo, season_length=SEASON)
        row = {}
        for route, fit, gpu_in, cpu_in in (
            ("f32", scoring.fit_forecast, (dv, dm), (cv, cm)),
            ("bf16", scoring.fit_forecast_bf16_delta, d16, c16),
        ):
            counted = dict(K.LAUNCHES)  # a warm-up for the timing: its launches do not count
            fit(*gpu_in, **kw)  # first call: library handles (cuBLAS, cuSOLVER), allocator
            torch.cuda.synchronize()
            K.LAUNCHES.update(counted)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fc = fit(*gpu_in, **kw)
            end.record()
            end.synchronize()
            row[route] = start.elapsed_time(end)
            ref = fit(*cpu_in, **kw)
            skip = np.zeros(n_cmp, bool)
            if algo in HW_ALGOS:
                g_vm = gpu_in if route == "f32" else scoring.bf16_delta_values(*gpu_in)
                c_vm = cpu_in if route == "f32" else scoring.bf16_delta_values(*cpu_in)
                skip = hw_flips(*g_vm, *c_vm, f"(b) {algo} {route}")
            keep = torch.from_numpy(~skip)
            err = 0.0
            for name in ("level", "trend", "season", "scale"):
                got_s = getattr(fc, name)[:n_cmp].cpu()[keep]
                err = max(err, close_err(got_s, getattr(ref, name)[keep], FIT_TOL[algo]))
            check(torch.equal(fc.season_phase[:n_cmp].cpu(), ref.season_phase), f"(b) {algo} {route}: phases differ")
            nh = n_hist if route == "f32" else torch.from_numpy(plens)
            got = scoring.score_from_state(gb, fc.level, fc.trend, fc.season, fc.season_phase, fc.scale,
                                           nh.to(dev), **pw)
            want = scoring.score_from_state(cb, ref.level, ref.trend, ref.season, ref.season_phase, ref.scale,
                                            nh[:n_cmp], **pw)
            row[route + "_edge"] = same_judgment_or_edge(got, want, cur, f"(b) {algo} {route}", skip)
            row[route + "_err"] = err
            row[route + "_unhealthy"] = int((got.verdict == scoring.UNHEALTHY).sum())
            del fc, ref, got, want
        out[algo] = row
        print(f"phase 7: (b) {algo}: fit_forecast {row['f32']:.2f} ms, fit_forecast_bf16_delta {row['bf16']:.2f} ms "
              f"per {n}-row chunk; first {n_cmp} rows vs CPU: state error {row['f32_err']:.2e} / "
              f"{row['bf16_err']:.2e} (tolerance {FIT_TOL[algo]:g}), verdicts and flags equal "
              f"({row['f32_edge']} / {row['bf16_edge']} rows differ at a band edge); unhealthy "
              f"{row['f32_unhealthy']} / {row['bf16_unhealthy']} of {n}")
    return out


def seasonal_fit_cache_fleet(n: int, seed: int):
    """7(c)'s fleet: phase 5's shape (fit keys, half canaries, every 16th
    current spiked) with quality-generator histories at the daily season."""
    from foremast_tpu_torch.engine.judge import MetricTask

    hist, cur, spiked = quality_fleet(n, seed)
    rng = np.random.default_rng(seed + 1)
    base = (cur - 0.03 + 0.05 * rng.standard_normal(cur.shape)).astype(np.float32)
    mtypes = ["error5xx", "error4xx", "latency", "cpu", "memory", None, "custom"]
    ht = 1_700_000_000 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 * np.arange(1, FULL_TC + 1, dtype=np.int64)
    bt = ct - 60 * FULL_TC
    tasks = []
    for i in range(n):
        kw = dict(base_times=bt, base_values=base[i]) if i % 2 == 0 else {}
        tasks.append(MetricTask(
            job_id=f"job{i}", alias=f"m{i % 5}", metric_type=mtypes[i % len(mtypes)],
            hist_times=ht, hist_values=hist[i], cur_times=ct, cur_values=cur[i],
            fit_key=f"app{i}|m{i % 5}|{int(ht[-1])}", **kw,
        ))
    return tasks, spiked, cur, base


def same_verdicts_or_edge(got, want, tasks, tol: float, what: str) -> int:
    """MetricVerdicts (band_mode "full") of the card and a CPU judge:
    verdicts and anomaly pairs equal except where a current point lies
    within EDGE of the CPU's band edge; differs exact, p within 1e-5,
    bands within `tol`. Returns the count of edge rows that differ."""
    edge_rows = 0
    for g, w, t in zip(got, want, tasks):
        if g.verdict != w.verdict or g.anomaly_pairs != w.anomaly_pairs:
            cur = np.asarray(t.cur_values, np.float32)[None]
            check(near_edge(cur, w.upper[None], w.lower[None])[0],
                  f"{what}: {g.job_id} differs from the CPU judge away from any band edge")
            edge_rows += 1
            continue
        check(g.dist_differs == w.dist_differs, f"{what}: dist_differs of {g.job_id}")
        check(abs(g.p_value - w.p_value) <= 1e-5 * (1 + abs(w.p_value)), f"{what}: p of {g.job_id}")
        check(np.allclose(g.upper, w.upper, rtol=tol, atol=tol), f"{what}: upper of {g.job_id}")
        check(np.allclose(g.lower, w.lower, rtol=tol, atol=tol), f"{what}: lower of {g.job_id}")
    return edge_rows


def run_seasonal_ticks(cfg, device, tasks, cur, base) -> dict:
    """Cold, warm object and columnar (both buckets) ticks of one judge
    (band_mode "full", fit cache) over `tasks`; host-clock seconds after a
    device sync."""
    import dataclasses

    import torch

    from foremast_tpu_torch.engine.judge import HealthJudge
    from foremast_tpu_torch.models.cache import ModelCache

    judge = HealthJudge(cfg, device=device)
    judge.fit_cache = ModelCache(4 * len(tasks))
    judge.band_mode = "full"
    cuda = judge.device.type == "cuda"
    out = {"seconds": {}}

    def tick(name, fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        if cuda:
            torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0

    tick("a", lambda: judge.judge(tasks))
    version = judge.fit_cache.version
    warm = [dataclasses.replace(t, job_id=t.job_id + "-recheck") for t in tasks]
    tick("b", lambda: judge.judge(warm))
    out["refit"] = judge.fit_cache.version != version
    buckets = [columnar_inputs(judge, tasks, cur, base, canary) for canary in (False, True)]
    tick("c", lambda: [(idx, judge.judge_columnar(*args, **kw)) for idx, args, kw in buckets])
    out["counters"] = judge.device_state_counters()
    out["m"] = max(a.m for a in judge._arenas.values())
    return out


def phase_seasonal_fit_cache(dev) -> dict:
    """7(c): the fit-cache fleet at the daily season with ML_ALGORITHM =
    auto_univariate, then holt_winters, bf16 gate on: cold, warm object
    and columnar ticks on the card; the first CMP_TASKS tasks on a CPU
    judge, tick for tick."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring

    n = FIT_FLEET
    t0 = time.perf_counter()
    tasks, spiked, cur, base = seasonal_fit_cache_fleet(n, seed=73)
    print(f"phase 7: (c) fleet of {n} tasks (quality kinds at m={SEASON}, Th={FULL_TH}, Tc={FULL_TC}, half "
          f"canaries, every 16th spiked) built in {time.perf_counter() - t0:.1f} s")
    out = {}
    scoring.set_bf16_delta(True)
    try:
        for algo, tol in (("auto_univariate", 1e-3), ("holt_winters", 2e-4)):
            cfg = BrainConfig(algorithm=algo, season_steps=SEASON)
            gpu = run_seasonal_ticks(cfg, dev, tasks, cur, base)
            cpu = run_seasonal_ticks(cfg, "cpu", tasks[:CMP_TASKS], cur[:CMP_TASKS], base[:CMP_TASKS])
            check(not gpu["refit"], f"(c) {algo}: the warm object tick fitted rows")
            check(gpu["m"] == SEASON, f"(c) {algo}: arena season width {gpu['m']}, want {SEASON}")
            verdict_a = np.asarray([v.verdict for v in gpu["a"]])
            check(all(verdict_a[spiked] == scoring.UNHEALTHY), f"(c) {algo}: a spiked task was not UNHEALTHY")
            check([v.verdict for v in gpu["b"]] == verdict_a.tolist(), f"(c) {algo}: warm verdicts differ from cold")
            edges = [same_verdicts_or_edge(gpu[k][:CMP_TASKS], cpu[k], tasks, tol, f"(c) {algo} ({k})") for k in "ab"]
            n_col = 0
            for (idx, g), (_, w) in zip(gpu["c"], cpu["c"]):
                check(np.array_equal(g[0], verdict_a[idx]), f"(c) {algo}: columnar verdicts differ from the cold tick")
                k = len(w[0])
                differ = (g[0][:k] != w[0]) | (g[1][:k] != w[1]).any(axis=1)
                rows = idx[:k][differ]
                check(near_edge(cur[rows], w[2][differ][:, :FULL_TC], w[3][differ][:, :FULL_TC]).all(),
                      f"(c) {algo}: columnar verdicts differ from the CPU judge away from any band edge")
                n_col += int(differ.sum())
                check(np.allclose(g[2][:k][~differ], w[2][~differ], rtol=tol, atol=tol), f"(c) {algo}: columnar bands")
            s, cs = gpu["seconds"], cpu["seconds"]
            print(f"phase 7: (c) {algo}: (a) cold {s['a']:.3f} s = {n / s['a']:.0f} windows/s, (b) warm object "
                  f"{s['b']:.3f} s, (c) columnar, both buckets, {s['c']:.3f} s (CPU judge over {CMP_TASKS} tasks: "
                  f"{cs['a']:.3f} / {cs['b']:.3f} / {cs['c']:.3f} s); verdicts "
                  f"{np.bincount(verdict_a, minlength=3).tolist()} (healthy/unhealthy/unknown); first {CMP_TASKS} "
                  f"equal the CPU judge at every tick ({edges[0]} / {edges[1]} / {n_col} differ at a band edge); "
                  f"arena m={gpu['m']}, counters {gpu['counters']}")
            out[algo] = s
    finally:
        scoring.set_bf16_delta(None)
    return out


def seasonal_worker_fleet(n_docs: int, t_now: int, seed: int, period: int):
    """Phase 6's fleet shape (docs x 4 aliases, half canaries, 7-day
    histories, endTime an hour out) with a cycle of `period` steps: each
    alias carries one quality kind (`SEASONAL_ALIASES`; the trend at a
    twentieth of the generator's slope) plus N(0, 0.05) noise, its current
    window continues the clean signal at its true time with a 0.01
    wiggle, and a canary's baseline is its current plus small noise."""
    from foremast_tpu_torch.jobs import Document

    rng = np.random.default_rng(seed)
    ht = t_now - 86_400 * 7 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(FULL_TC, dtype=np.int64)
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_now + 3600))

    def signal(kind, t):
        s = quality_signal(kind, t, period, FULL_TH)
        return 1.0 + (s - 1.0) / 20 if kind == "trend" else s

    clean = {a: signal(k, np.arange(FULL_TH)).astype(np.float32) for a, k in SEASONAL_ALIASES.items()}
    currents = {
        a: (signal(k, FULL_TH + np.arange(FULL_TC)) + 0.01 * np.sin(np.arange(FULL_TC) / 3.0)).astype(np.float32)
        for a, k in SEASONAL_ALIASES.items()
    }
    data, docs, latency = {}, [], []
    for i in range(n_docs):
        parts = {"current": [], "historical": [], "baseline": []}
        for a in SEASONAL_ALIASES:
            cur_url = f"http://prom/cur?q={a}:app{i}&end={int(ct[0]) - 60}&step=60"
            hist_url = f"http://prom/hist?q={a}:app{i}&end={int(ht[-1]) + 60}&step=60"
            data[cur_url] = (ct, currents[a])
            data[hist_url] = (ht, clean[a] + 0.05 * rng.standard_normal(FULL_TH, dtype=np.float32))
            if a == "latency":
                latency.append(cur_url)
            parts["current"].append(f"{a}== {cur_url}")
            parts["historical"].append(f"{a}== {hist_url}")
            if i % 2 == 0:
                base_url = f"http://prom/base?q={a}:app{i}&step=60"
                data[base_url] = (ct - 3600, (currents[a] + rng.normal(0, 0.01, FULL_TC)).astype(np.float32))
                parts["baseline"].append(f"{a}== {base_url}")
        docs.append(Document(
            id=f"job-{i}", app_name=f"app{i}", end_time=end_time,
            current_config=" ||".join(parts["current"]), historical_config=" ||".join(parts["historical"]),
            baseline_config=" ||".join(parts["baseline"]), strategy="canary" if i % 2 == 0 else "continuous",
        ).to_json())
    return docs, data, latency


def run_seasonal_worker(device, cfg, docs, data, latency, t_now: int) -> dict:
    """A port worker over its own store and source: (a) cold tick, (b) warm
    tick with every 16th doc's last 3 latency points spiked. What the
    store holds, the arena counters, fits and columnar calls after each,
    host-clock seconds after a device sync."""
    import torch

    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.metrics.source import MetricSource

    class ArraySource(MetricSource):
        concurrent_fetch = False

        def __init__(self, series):
            self.data = dict(series)

        def fetch(self, url: str):
            return self.data[url]

    store = InMemoryStore()
    for d in docs:
        store.create(Document.from_json(d))
    worker = BrainWorker(store, ArraySource(data), config=cfg, device=device, claim_limit=len(docs),
                         worker_id=f"smoke7-{device}")
    calls = []
    orig = worker.judge.judge_columnar
    worker.judge.judge_columnar = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
    cuda = torch.device(device).type == "cuda"
    out = {}
    for name, now in (("a", t_now + 150), ("b", t_now + 200)):
        if name == "b":
            for i in range(5, len(docs), 16):
                t, v = worker.source.data[latency[i]]
                v = v.copy()
                v[-3:] = 40.0
                worker.source.data[latency[i]] = (t, v)
        calls.clear()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = worker.tick(now=now)
        if cuda:
            torch.cuda.synchronize()
        out[name] = dict(
            seconds=time.perf_counter() - t0, docs=n, columnar=list(calls), fits=len(worker._fit_cache),
            counters=worker.judge.device_state_counters(),
            written={d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                     for d in store._docs.values()},
        )
    out["m"] = max(a.m for a in worker.judge._arenas.values())
    return out


def phase_seasonal_worker(dev) -> dict:
    """7(d): the worker's fleet tick over seasonal histories:
    ML_ALGORITHM=auto_univariate at the daily season over SEASONAL_DOCS
    docs, then holt_winters at m = HW_SEASON over HW_DOCS docs, cold and
    spiked-warm ticks; every doc's (status, code, reason, anomaly_info)
    and the arena counters equal a CPU worker's."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED

    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"  # the monolithic tick (no sliced sweeps yet)
    t_now = int(time.time())
    out = {}
    for algo, n_docs, m in (("auto_univariate", SEASONAL_DOCS, SEASON), ("holt_winters", HW_DOCS, HW_SEASON)):
        t0 = time.perf_counter()
        docs, data, latency = seasonal_worker_fleet(n_docs, t_now, seed=79, period=m)
        n_win = n_docs * len(SEASONAL_ALIASES)
        cfg = BrainConfig(algorithm=algo, season_steps=m, max_cache_size=n_win + 64)
        print(f"phase 7: (d) {algo}: fleet of {n_docs} docs x {len(SEASONAL_ALIASES)} aliases = {n_win} windows "
              f"(cycle m={m}, Th={FULL_TH}, half canaries) built in {time.perf_counter() - t0:.1f} s")
        gpu = run_seasonal_worker(dev, cfg, docs, data, latency, t_now)
        cpu = run_seasonal_worker("cpu", cfg, docs, data, latency, t_now)
        a, b = gpu["a"], gpu["b"]
        check(a["docs"] == n_docs and a["fits"] >= n_win and not a["columnar"],
              f"(d) {algo}: cold tick: {a['docs']} docs, {a['fits']} fits, columnar {a['columnar']}")
        check(gpu["m"] == m, f"(d) {algo}: arena season width {gpu['m']}, want {m}")
        healthy_a = sum(json.loads(v)[0] == STATUS_PREPROCESS_COMPLETED for v in a["written"].values())
        check(b["columnar"] and sum(b["columnar"]) == len(ALIASES) * healthy_a,
              f"(d) {algo}: warm columnar calls {b['columnar']} for {healthy_a} re-checked docs")
        spiked = {f"job-{i}" for i in range(5, n_docs, 16)}
        unhealthy = {k for k, v in b["written"].items() if json.loads(v)[0] == STATUS_COMPLETED_UNHEALTH}
        check(spiked <= unhealthy, f"(d) {algo}: a spiked doc was not flagged")
        for name in "ab":
            differ = sum(gpu[name]["written"][k] != v for k, v in cpu[name]["written"].items())
            check(differ == 0, f"(d) {algo} ({name}): writes differ from the CPU worker's on {differ} docs")
            check(gpu[name]["counters"] == cpu[name]["counters"], f"(d) {algo} ({name}): arena counters differ")
        print(f"phase 7: (d) {algo}: every doc's (status, code, reason, anomaly_info) and the arena counters equal "
              f"the CPU worker's on both ticks; {healthy_a} of {n_docs} docs stayed in the re-check loop after the "
              f"cold tick; the warm tick took columnar calls of {b['columnar']} rows and flagged all {len(spiked)} "
              f"spiked docs ({len(unhealthy)} unhealthy in all); (a) cold {a['seconds']:.3f} s = "
              f"{n_docs / a['seconds']:.0f} docs/s, {n_win / a['seconds']:.0f} windows/s, (b) warm "
              f"{b['seconds']:.3f} s = {n_win / b['seconds']:.0f} windows/s (CPU worker: {cpu['a']['seconds']:.3f} / "
              f"{cpu['b']['seconds']:.3f} s)")
        out[algo] = {k: gpu[k]["seconds"] for k in "ab"}
    return out


def time_scan_kernels(dev, peak_bytes: float, sm_clock_hz: float) -> dict:
    """The two scan kernels at the main path's shapes: one 4,096-row cold
    chunk, T=16,384 with every row valid to Th=10,080; holt_winters_scan's
    grid launch of G=8 and its per-series launch that writes predictions,
    at m=1440 and m=24; holt_scan. Each is called as the product calls it:
    holt_winters_scan with the `last_valid` that fit_holt_winters computes
    once for its two launches (timed apart), holt_scan computing its own.
    Each is held bit for bit to its plain version (one call of it, timed),
    then timed beside its bound (the larger of bytes over the memory rate
    and f32 operations over the f32 peak, operations counted over the
    steps the data need), the dependent chain's floor and the floor of the
    season's device-memory stream; and timed again with every row empty
    (no chain runs: the fill of `pred` and the set-up alone) and on the
    first 128 rows only (at most 8 blocks, none sharing an SM: the chain
    without contention)."""
    import torch

    from foremast_tpu_torch.ops import forecasters as F
    from foremast_tpu_torch.ops import kernels as K

    b, t_len, g = FLEET, TH_BUCKET, len(F._HW_GRID)
    steps = FULL_TH  # every row's last valid step + 1: what the chain must run
    hist, _, _ = quality_fleet(b, seed=83)
    values = torch.zeros((b, t_len), device=dev)
    values[:, :FULL_TH] = torch.from_numpy(hist).to(dev)
    mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
    mask[:, :FULL_TH] = True
    grid = torch.tensor(F._HW_GRID, dtype=torch.float32, device=dev)
    params = grid[torch.arange(b, device=dev) % g].contiguous()
    lv = K.last_valid_index(mask)  # passed in, as fit_holt_winters does; timed apart below
    no_mask = torch.zeros_like(mask)  # every row empty: no chain runs
    no_rows = torch.full_like(lv, -1)
    few = 128
    # a lane-step: ~16 f32 operations (3 adds/subs of the forecast, 3 x
    # (sub, 2 mul, add) of level, trend and season, the residual square)
    # and one f64 add. The chain: level/trend -> level + trend -> product
    # -> new level -> difference -> product -> new trend, ~7 dependent
    # f32 operations a step at ~4 cycles (6 for Holt). A season larger
    # than L2 streams from device memory: 4 B read and 4 B written a
    # lane-step. Bytes: the history up to the last valid step (what the
    # results depend on; every row here has a valid point), the state,
    # and all T columns of `pred` where it is written; holt_scan, which
    # finds each row's last valid step itself, reads the whole mask.
    work = []
    for m in (SEASON, HW_SEASON):
        il, isn = F._hw_init(values, mask, m)
        for label, lanes, p, per_series in (("grid G=8", b * g, grid, False), ("per-series, with predictions", b, params, True)):
            season_bytes = lanes * m * 4

            def hw(n, empty, il=il, isn=isn, p=p, ps=per_series):
                return K.holt_winters_scan(values[:n], (no_mask if empty else mask)[:n], il[:n], isn[:n],
                                           p[:n] if ps else p, ps, ps, (no_rows if empty else lv)[:n])

            work.append((
                f"holt_winters_scan {label} m={m}",
                hw,
                lambda il=il, isn=isn, p=p, ps=per_series: K._holt_winters_scan_plain(values, mask, il, isn, p, ps, ps),
                b * steps * 5 + b * 4 + b * m * 4 + p.numel() * 4 + lanes * (4 + 4 + 8) + season_bytes
                + (b * t_len * 4 if per_series else 0),
                lanes * steps * 16, 7 * 4,
                lanes * steps * 8 if season_bytes > L2_BYTES else 0, season_bytes,
            ))
    work.append((
        "holt_scan",
        lambda n, empty: K.holt_scan(values[:n], (no_mask if empty else mask)[:n], 0.3, 0.1),
        lambda: K._holt_scan_plain(values, mask, K._row(0.3, b, torch.float32, dev), K._row(0.1, b, torch.float32, dev)),
        b * steps * 4 + b * t_len + b * 8 + b * 8 + b * t_len * 4, b * steps * 10, 6 * 4, 0, 0,
    ))
    timings = {}
    for name, kernel, plain, nbytes, flops, chain_cycles, stream_bytes, season_bytes in work:
        got = kernel(b, False)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        full_err = same_bits(got, want, f"{name} at full size")
        del got, want
        kernel_ms = cuda_ms(lambda: kernel(b, False), iters=3, repeats=3)
        empty_ms = cuda_ms(lambda: kernel(b, True), iters=3, repeats=3)
        few_ms = cuda_ms(lambda: kernel(few, False), iters=3, repeats=3)
        bytes_ms = nbytes / peak_bytes * 1e3
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        chain_ms = steps * chain_cycles / sm_clock_hz * 1e3
        stream_ms = stream_bytes / peak_bytes * 1e3
        timings[name] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", chain_ms=chain_ms, stream_ms=stream_ms,
            full_err=full_err, empty_ms=empty_ms, few_ms=few_ms,
        )
        season = (f"season stream {stream_ms:.4f} ms ({stream_bytes / 1e9:.3f} GB: the {season_bytes / 1e6:.1f} MB "
                  f"season exceeds L2)" if stream_bytes else
                  f"season stream 0 (season {season_bytes / 1e6:.1f} MB, within L2)" if season_bytes else "no season")
        print(f"phase 7: {name} B={b} T={t_len} steps={steps}: kernel_ms={kernel_ms:.4f} "
              f"({kernel_ms * 1e-3 * sm_clock_hz / steps:.1f} cycles of the launch a chain step; with every row "
              f"empty, no chain, {empty_ms:.4f} ms; on the first {few} rows {few_ms:.4f} ms) "
              f"bound_ms={max(bytes_ms, ops_ms):.4f} ({nbytes / 1e9:.3f} GB at {peak_bytes / 1e12:.2f} TB/s = "
              f"{bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = {ops_ms:.4f} ms); "
              f"chain floor {chain_ms:.4f} ms ({chain_cycles} cycles a step at {sm_clock_hz / 1e9:.2f} GHz); {season}; "
              f"plain_ms={plain_ms:.1f} (one call, bit for bit equal); library_ms=none")
    lv_ms = cuda_ms(lambda: K.last_valid_index(mask), iters=3, repeats=3)
    print(f"phase 7: last_valid_index on that chunk: {lv_ms:.4f} ms (once a fit_holt_winters, outside the "
          "holt_winters_scan rows above; inside the holt_scan row)")
    for m in (SEASON, HW_SEASON):
        fit_ms = cuda_ms(lambda: F.fit_holt_winters(values, mask, m), iters=1, repeats=3)
        print(f"phase 7: fit_holt_winters m={m} (both launches, init, guard, scale) on that chunk: {fit_ms:.3f} ms")
    timings["holt_winters_scan"] = dict(
        timings[f"holt_winters_scan grid G=8 m={SEASON}"],
        full_err=max(t["full_err"] for k, t in timings.items() if k.startswith("holt_winters_scan")),
    )
    return timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from foremast_tpu_torch.ops import _build
    from foremast_tpu_torch.ops import kernels as K

    kernels_only = "--kernels-only" in sys.argv[1:]
    # the seasonal model's f32 products must not round through TF32 (its
    # normal equations run in float64, which never does)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_clock_hz = float(clock) * 1e6
    peak_key = next((k for k in PEAK_BYTES if k in name), "HBM3")
    peak_bytes = PEAK_BYTES[peak_key]
    print(f"phase 1: device {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    print(f"phase 1: memory peak used for bounds: {peak_bytes / 1e12:.2f} TB/s ({peak_key} part); max SM clock "
          f"{sm_clock_hz / 1e9:.3f} GHz; torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    build_s = _build.build_all()
    print(f"phase 1: kernels built in {build_s:.1f} s")
    for kname in KERNEL_FILES:
        for line in _build.build_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: {kname}: {line.strip()}")

    worst = phase_kernels_vs_plain(dev)
    worst.update(phase_scan_kernels_vs_plain(dev))
    if kernels_only:
        time_scan_kernels(dev, peak_bytes, sm_clock_hz)
        print("chip_smoke: --kernels-only: every kernel built and equals its plain version; the scans were timed")
        return 0

    # each main path runs with the launch counts zeroed just before it and
    # read just after; the timing loops run after the readings
    def path(fn, *args):
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        result = fn(*args)
        return result, dict(K.LAUNCHES)

    def object_path():
        phase_judge()
        return phase_steady_state(dev, peak_bytes)

    # phase 4 reads its counts itself, before its timing loops
    (launched_object, timings, full_err), _ = path(object_path)
    for kname in MA_KERNELS:
        check(launched_object[kname] > 0, f"the object path (phases 3-4) never launched {kname}")
    fit_cache, launched_fit_cache = path(phase_fit_cache, dev, peak_bytes)
    check(launched_fit_cache["masked_stats"] > 0, "the fit-cache path (phase 5) never launched masked_stats")
    _, launched_worker = path(phase_worker, dev, smi, fit_cache["seconds"]["c"])
    check(launched_worker["masked_stats"] > 0, "the worker's f32 cold tick (phase 6) never launched masked_stats")
    _, launched_fits = path(phase_cold_fits, dev)
    for kname in ("masked_stats", "holt_winters_scan", "holt_scan"):
        check(launched_fits[kname] > 0, f"the cold fits of every algorithm (phase 7b) never launched {kname}")
    _, launched_seasonal = path(phase_seasonal_fit_cache, dev)
    _, launched_seasonal_worker = path(phase_seasonal_worker, dev)
    for label, got in (("fit-cache fleet (phase 7c)", launched_seasonal),
                       ("worker fleet tick (phase 7d)", launched_seasonal_worker)):
        for kname in ("masked_stats", "holt_winters_scan"):
            check(got[kname] > 0, f"the seasonal {label} never launched {kname}")
    paths = {
        "object path (phases 3-4)": launched_object,
        "fit-cache path (phase 5)": launched_fit_cache,
        "worker fleet tick (phase 6)": launched_worker,
        "cold fits of every algorithm (phase 7b)": launched_fits,
        "seasonal fit-cache fleet (phase 7c)": launched_seasonal,
        "seasonal worker fleet tick (phase 7d)": launched_seasonal_worker,
    }
    print("launches: " + "; ".join(f"{label} {counts}" for label, counts in paths.items()))
    launches = {k: sum(counts[k] for counts in paths.values()) for k in KERNEL_FILES}

    scan = time_scan_kernels(dev, peak_bytes, sm_clock_hz)
    for kname in ("holt_winters_scan", "holt_scan"):
        timings[kname] = scan[kname]
        full_err[kname] = scan[kname]["full_err"]

    print("kernels: " + ", ".join(f"{k} launches={launches[k]} phase2=pass" for k in KERNEL_FILES))
    table = []
    for kname, (source, replaces) in KERNEL_FILES.items():
        t = timings[kname]
        table.append(
            {
                "name": kname,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": max(worst[kname], full_err[kname]),
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            }
        )
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
