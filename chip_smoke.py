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
Launch counts are zeroed just before each main path (phases 3-4, then
phase 5, then phase 6) and read just after its checked calls, so they
count the main paths' launches only: on the worker's path (phase 6) only
the f32 cold fit launches a kernel (masked_stats); the bf16-delta cold
fit and the warm program (score_from_arena) are plain torch.

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
}
TOL = {"ma_judgment": 1e-4, "ma_judgment_bf16_delta": 1e-5, "masked_stats": 1e-4}


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def close_err(got, want, tol: float) -> float:
    """Max |got - want|; fails unless |got - want| <= tol * (1 + |want|)."""
    import torch

    diff = (got.double() - want.double()).abs()
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
    worst = {name: 0.0 for name in KERNEL_FILES}
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
    from foremast_tpu_torch.engine.judge import bucket_length

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from foremast_tpu_torch.ops import _build
    from foremast_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    peak_key = next((k for k in PEAK_BYTES if k in name), "HBM3")
    peak_bytes = PEAK_BYTES[peak_key]
    print(f"phase 1: device {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    print(f"phase 1: memory peak used for bounds: {peak_bytes / 1e12:.2f} TB/s ({peak_key} part)")
    build_s = _build.build_all()
    print(f"phase 1: kernels built in {build_s:.1f} s")
    for kname in KERNEL_FILES:
        for line in _build.build_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: {kname}: {line.strip()}")

    worst = phase_kernels_vs_plain(dev)

    # each main path runs with the launch counts zeroed just before it and
    # read just after; phase 4's timing loop runs after its reading
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    phase_judge()
    object_path, timings, full_err = phase_steady_state(dev, peak_bytes)
    for kname, n in object_path.items():
        check(n > 0, f"the object path (phases 3-4) never launched {kname}")
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    fit_cache = phase_fit_cache(dev, peak_bytes)
    fit_cache_path = dict(K.LAUNCHES)
    check(fit_cache_path["masked_stats"] > 0, "the fit-cache path (phase 5) never launched masked_stats")
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    phase_worker(dev, smi, fit_cache["seconds"]["c"])
    worker_path = dict(K.LAUNCHES)
    check(worker_path["masked_stats"] > 0, "the worker's f32 cold tick (phase 6) never launched masked_stats")
    print(f"launches: object path (phases 3-4) {object_path}; fit-cache path (phase 5) {fit_cache_path}; "
          f"worker fleet tick (phase 6) {worker_path}")
    launches = {k: object_path[k] + fit_cache_path[k] + worker_path[k] for k in KERNEL_FILES}

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
