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
     tick; wall clock, docs/s, windows/s and the span breakdown; then (a)-(c)
     again as sliced sweeps (FOREMAST_SWEEP_SLICE_DOCS unset, 2,048 docs a
     slice, and 1,024), the columnar dispatches on the tick thread under
     set_sync_debug_mode("error"): writes and arena counters equal the
     monolithic tick's, each sweep's wall clock beside the monolithic
     one, slice and preemption counters.
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
  8. the joint detectors (bivariate normal, LSTM autoencoder + residual
     MVN, `auto`): (a) lstm_ae_forward and lstm_ae_backward against
     their plain versions at 96 shapes (S in {1, 3, 37}, W in {1, 3, 8,
     32}, T in {1, 8, 32, 33, 64}, F in {1, 2, 3, 4, 8}), with
     all-masked, single-step and ragged windows and rows gathers with
     repeated rows (err within 1e-5 relative, saved activations within
     1e-5, gradients from that act within 1e-4 of float64 autograd of
     the plain loop where W <= 8; two forward and two backward calls
     bit-identical); (b)
     one cold LSTM group at the joint fleet's width (512 jobs, W=8, T=32,
     F=4, H=32, 60 steps) through MultivariateJudge.judge, held to a CPU
     judge given the trained entries; then fit_many's loss curve and
     both kernels timed beside their bounds (and share of it), their
     plain versions and cuDNN's unmasked nn.LSTM (another function); the
     backward's chain and product launches timed apart, beside torch.bmm
     of its dW_h products; both kernels' ptxas registers, shared memory
     and spill for every entry function; (c) the joint quality
     gates of tests/test_benchmarks.py at 256 jobs a scenario; (d) the
     worker's joint fleet tick, 1,024 docs under `auto` at Th=10,080 and
     m=1440: cold, warm (joint columnar, 0 trainings, 0 MVN fits),
     spiked warm (exactly the spiked docs flag) and (e) the warm joint
     dispatch again under set_sync_debug_mode("error") behind a busy
     kernel; the first 64 docs against a CPU worker given the card's
     trained entries; after the timings, the cold tick again under
     cProfile on a fresh worker over a quarter of the fleet (top 10
     functions by cumulative and by own time).
  9. the deployable worker: (a) a BrainWorker over ElasticsearchStore and
     PrometheusSource (claim limit 256, the CLI's default) against a fake
     Elasticsearch and a fake Prometheus (tests/torch_fake_services.py)
     on loopback sockets in this process, over phase 6's fleet shape at
     320 docs x 4 aliases (1,280 query_range histories of 7 days): a
     cold pass, a warm pass and a spiked warm pass, every doc's (status,
     code, reason, anomaly_info) equal to phase 6's in-memory worker on
     the same fleet, exactly the spiked docs flagged; (e) the push arm:
     every series of the fleet pushed as FMW1 frames to the port's
     receiver (foremast_tpu_torch/ingest) in this process, then the same
     three passes through RingSource(ring, fallback=PrometheusSource) and
     one more cold pass on the f32 route (FOREMAST_BF16_DELTA=0, a fresh
     worker): writes equal the pull arm's (the f32 pass phase 6's f32
     tick), 0 Prometheus requests, 0 ring evictions, every cold history
     read from the ring, masked_stats launched; (b) each tick's wall
     clock, docs/s, metric_fetch share, Prometheus requests, cold reads
     by source and claim / metric_fetch / fit / score / write_back
     spans, and PrometheusSource.fetch of a sample of history and
     current windows split into HTTP round trip, json.loads and the
     per-point loop; (c) phase 5's cold chunk packed as before (numpy
     rows into an f32 scratch, then the bf16 cast, then pinned staging;
     timed apart) and by the native library into a pinned buffer, bit
     for bit equal, and phase 5's and phase 6's cold ticks before and
     after; (d) `python3 -m foremast_tpu_torch worker` as a subprocess
     with FOREMAST_SNAPSHOT_DIR set: it judges the fleet to (a)'s writes
     and exits 0 on SIGTERM; restarted on the same directory it judges
     the reset fleet with 0 history fetches and an all-warm first tick;
     an f32 run (FOREMAST_BF16_DELTA=0, fresh directory, 128 docs)
     launches masked_stats, which it reports when it stops; with
     FOREMAST_INGEST=1 it takes the fleet's samples on its receiver,
     judges the fleet to (a)'s writes with 0 Prometheus requests, exits
     0 on SIGTERM, and restarted on the same directory restores the ring
     and judges the reset fleet with 0 requests and an all-warm first
     tick; (f) short-history admission: 512 newcomers pushed with 1-2
     days of a 7-day window into a pure-push ring with an admission floor
     are judged on their first tick from provisional fits, a backfill
     makes refinement invalidate and refit them, the window's close makes
     the terminal refit; the final fits equal a fresh worker's
     from-scratch fit on the same columns, and a spiked warm tick writes
     the same statuses, on the bf16-delta route and the f32 one (which
     launches masked_stats); (g) micro-ticks: phase 6's 4,096-doc fleet,
     its series with their docs' `app` label bulk-loaded to a receiver
     with the dirty set wired, a worker's run loop (sweeps in four slices
     of 1,024 docs, micro-ticks every 0.05 s between them), 40 docs
     spread over the fleet spiked through the receiver per condition,
     shuffled, from the end of a sweep: quiet, with sweeps every 5 s,
     half evenly over 2.5 s and half in a burst as the next sweep starts
     (into its slice boundaries); evenly over 5 s
     with sweeps every 30 s (micro-ticks alone) 2 s into a remote-write
     stream from a pusher subprocess at 6,667 samples/s and back to
     back, back to back again with the stream's
     apps owned by another worker (decoded, never marked), then with
     micro-ticks off (no dirty set in the worker: sweeps back to back):
     push->verdict latency, p50 and p99 of the worker's
     foremast_verdict_latency_seconds observations and of each doc's
     client-seen latency, each sweep's wall clock, the boundaries'
     promotions, in-flight requeues and nested micro-ticks (each must
     have happened); every doc's writes equal one full cold tick's.
 10. fault injection and the tenant plane, at phase 6's width (4,096 docs
     x 4 aliases, every selector labelled with its doc's tenant: `whale`
     3,584 docs, `quiet-a` and `quiet-b` 256 each, interleaved late in
     the claim order; FOREMAST_TENANTS weights 1, the whale's arena_rows
     envelope 3,072 below its 14,336 windows): (a) cold, warm and spiked
     warm sweeps in 1,024-doc slices, tenanted against untenanted, writes
     equal, every quiet doc in the first slice, the last 512 docs against
     a tenanted CPU worker, each tenant's last slice and time-to-verdict
     p50 / p99, the columnar dispatches under set_sync_debug_mode("error");
     (b) every arena eviction charged to the whale, the quiet tenants'
     rows all resident; (c) a tenanted f32 cold sweep
     (FOREMAST_BF16_DELTA=0, masked_stats) with (a)'s statuses; (d) chaos
     on 512 docs over the fake Elasticsearch (claim 512, slices of 256):
     a store outage over one warm sweep's writes goes to write-behind and
     the next sweep replays each verdict once; a seeded 0.2 error rate on
     the Prometheus edge (the pulled path) releases docs un-judged and
     later sweeps judge them all; a receiver rule answers 503; injections
     by (edge, kind) and breaker transitions; (e) the whale floods a
     receiver over its ingest byte-rate and ring-bytes envelopes while
     quiet-a pushes at 6,670 samples/s: only the whale is shed (429
     naming it) and evicted, accepted samples/s per tenant beside an
     untenanted receiver's; (f) `python3 -m foremast_tpu_torch worker`
     with FOREMAST_TENANTS, FOREMAST_CHAOS_PLAN and FOREMAST_INGEST=1
     judges 256 pushed docs to (a)'s writes through a store outage, its
     receiver's /debug/state carries the tenants section and its stop
     record the plan's injections and the tenant ledger.
 11. the worker mesh (foremast_tpu_torch/mesh/), every member a BrainWorker
     on the card over one shared in-memory store, with its own ring,
     RingSource (a counting fallback behind it), receiver (router and
     handoff wired) and MeshNode, over phase 6's 4,096 docs x 4 aliases
     with `app` the route label; every arm's writes equal a single card
     worker's on the same fleet: (a) three members partition the fleet
     (rings loaded in process through RingStore.push: an HTTP bulk load of
     166 M samples would not fit the time), cold then warm, no doc claimed
     twice in a round, warm dispatches under set_sync_debug_mode("error");
     (b) a fourth joins fenced and the others stream it its partition over
     /api/v1/transfer: series, fits, bytes, seconds to active, and its
     first tick makes 0 cold fits and 0 history reads; (c) one drains
     while the others tick (a survivor's tick timed while the stream is
     applied), then leaves, and the survivors refit nothing; (d) one dies
     with its claims in flight, its `clock` chaos edge skewing its lease
     past expiry: the survivors take the orphans over through the
     stuck-claim CAS and refit them on the f32 route (masked_stats), held
     to an f32 single worker; (e) three fresh members, a RoutingPusher
     (FMW1 frames) pushes 512 docs' series to one seed: one cycle learns
     every owner from the hints, the histories then land with 0 hints,
     evict_unowned leaves each ring its own partition, and the members'
     cold ticks write the pull path's writes with 0 fallback reads; (f) a
     joiner behind a blackholed `transfer` edge activates at its 5 s
     deadline and cold-refits what moved to it; (g) two `python3 -m
     foremast_tpu_torch worker` processes with FOREMAST_MESH=1 and
     FOREMAST_INGEST=1 judge 256 pushed docs together (both members on the
     first receiver's /debug/state), and after SIGTERM the second drains
     to the first, which judges the whole fleet on the warm path.
 12. the device mesh of one process (foremast_tpu_torch/parallel/): on
     one card the mesh is the card listed 4 times (a one-card mesh; its
     times are the per-block overhead on one card, not the scaling of
     several cards): (a) phase 6's fleet (4,096 docs x 4 aliases) through
     a sharded-arena mesh worker, a replicated-arena one
     (FOREMAST_ARENA_SHARDED=0) and the single-device worker, phase 6's
     ticks (cold, warm, spiked warm, f32 cold of 1,024 docs): writes,
     hook bands and fit-key sets equal in bytes, every sharded arena 4
     blocks of capacity/4 rows, the f32 cold tick's masked_stats
     launches 4x the single worker's; padded-row fraction, placement and
     fetch seconds and bytes, each tick beside the single worker's; (b)
     ShardedJudge.judge without a fit cache on 4,096 tasks (ma_judgment)
     and a bf16-delta batch placed by it (ma_judgment_bf16_delta), equal
     to the single judge, one launch a block; (c) the sharded worker's
     warm columnar dispatch behind a busy kernel under
     set_sync_debug_mode("error"), its device operations beside the
     single device's; (d) 256 joint docs (bivariate and LSTM, m=1440)
     through the sharded joint arenas, writes equal the single worker's
     given the trained entries; (e) score_time_sharded over a 1 x 4 mesh
     at B=4,096, Th=40,320 (moving_average_all, phase_means at m=1440)
     against scoring.score and fit_forecast + score_from_state on one
     device, sharded_ewma against ewma_levels. With more than one card,
     (a) and (c) run again over every card.
 13. the control loop (the gateway, the watch plane and the worker): one
     release wave of 256 Deployments over 8 namespaces on
     tests/fake_kube_server.py (real HTTP), each rolling v1 -> v2 with
     old and new pods, 4 monitored metrics of 7-day histories (Th=10,080;
     every one of the 1,024 its own) on the fake Prometheus, every 2nd
     app's new pods 0.1 sigma above the band on two metrics and the
     others' closest point 0.1 sigma below it, the monitors' remediation
     alternating AutoRollback / AutoPause; the gateway is `python3 -m
     foremast_tpu_torch serve` over the fake Elasticsearch, the watch
     plane (`WatchPlane` over `HttpKube`) and a BrainWorker on the card
     run in this process on a stepped clock:
     (a) rollout -> Barrelman -> one job per Deployment through the
     gateway -> the worker's ticks -> the controller's polls -> rollback
     or pause, then the same loop with a CPU worker: every job's
     (status, code, reason, anomaly) and every verdict's (verdict,
     flagged points) equal, every band within 1e-4 and the cold bands
     within 1e-4 of their float64 value, every monitor's (phase,
     remediation taken, anomaly, job) and every Deployment's (image,
     paused) equal, no plane step failed and none was repeated; wall
     clock from rollout to the last terminal monitor, tick and poll
     times, the gateway's requests by route (its /metrics); (b) the same
     card loop with FOREMAST_BF16_DELTA=0 (masked_stats), against (a)'s
     CPU loop; (c) the streaming informer (FOREMAST_WATCH_STREAM's path)
     with one torn stream and one 410, the stream alone making one job
     per rollout, and, in the same run, (d) a 0.2 error rate on the kube
     edge's read paths (the watch's connects among them), with retries
     and the breaker, every failed plane step an injected fault: equal
     to (a); one job per rollout in every arm; (e), after the timed
     arms, `score --device cuda` on a spike, a normal and an untraced
     request as processes (exit 0, 0, 1, answers equal to the CPU's),
     beside them `watch` / `unwatch` / `watch ghost` (exit 0, 0, 1) and
     `watch-plane` under a kube chaos plan until its monitors exist,
     then SIGTERM (exit 0).
 14. the dashboard and demo loop: the demo runbook of
     tests/test_system_e2e.py over 256 demo apps (8 namespaces), each a
     Deployment with its own DeploymentMetadata monitoring error5xx, its
     own 7-day history (Th=10,080) and its own scale and offset on the
     demo traces (tests/data/demo_canary_*.csv), every 2nd v2 replaying
     the spike trace and a quarter of the apps with a point 0.1 sigma
     across or short of the band: WatchPlane over InMemoryKube,
     LocalAnalyst over an in-memory store, a BrainWorker ticking every
     60 s through the current window on a stepped clock.
     (a) the runbook with the worker on the card, with the default route
     and with FOREMAST_BF16_DELTA=0 (masked_stats): every spiked app
     Unhealthy and rolled back to v1, every other Healthy, each first
     verdict and its flagged points as placed; (b) each against the same
     runbook with a CPU worker: monitors, images, jobs, events, verdicts
     and flagged points equal at every tick, bands within 1e-5
     (bf16-delta) and 1e-4 (f32); no step, tick or resync failed and no
     module logged a warning; (c) the card worker's BrainGauges scraped
     into the fake Prometheus after each tick, proxied by `python3 -m
     foremast_tpu_torch serve --query-endpoint`, charted by a `ui`
     process for each of 8 apps: the anomaly dots on the worker's
     flagged points at their measured values, the band points the
     published bands, the body equal to the CPU arm's (bands within
     1e-5); one `ui --demo` panel; (d) `rules` as a process prints the
     manifest's YAML, and `rule_expr` resolves every series the
     runbook's queries and panels use. Seconds per arm, rollout -> first
     verdict and rollout -> last terminal monitor, with the card's name
     and power limit.
 15. the diagnosis surface: (a) fit_forecast of a 4,096-row f32 history
     (masked_stats), score at B=4,096, Th=10,080, Tc=30 (ma_judgment),
     score_bf16_delta (ma_judgment_bf16_delta) and a cold fit-cache judge
     pass inside `observe.trace_scoring` (torch.profiler): the Chrome
     trace holds each kernel as a device event under its __global__ name,
     one for each launch its wrapper counted, and the judge's
     record_function markers; the profiled results equal the same calls'
     without the profiler; each kernel's device µs summed from the trace
     beside the call's cuda_ms; (b) the port's lock witness in process
     over a journaled ring's push, a snapshot pass and two worker ticks
     of 256 docs over RingSource: no observed edge outside
     analysis_lockgraph_torch.json; (c) the CLI worker with
     FOREMAST_LOCK_WITNESS=1 and FOREMAST_INGEST=1 judging a pushed fleet:
     /debug/state env_overrides are the registered knobs it was started
     with, and its exit log says every observed edge lies within the
     static graph; (d) the manifests rendered into a tempdir equal the
     committed deploy_torch/, and the metric lint finds nothing in (b)'s
     worker's registry.
 16. pod mode: two ranks of one worker over torch.distributed (the JAX_*
     rendezvous; host objects over gloo; on one card both ranks share it
     and the result gather runs over gloo, on a host of 2+ cards each
     rank gets its own (CUDA_VISIBLE_DEVICES) and the gather runs over
     NCCL; the line says which), the kernels and the native library built
     before the ranks start: (a) PodWorkers over 512 docs x 4 aliases
     (phase 6's fleet shape, Th=10,080, Tc=30): a cold and a warm tick
     on the default route, then a fresh pod's cold tick over 256 docs
     with only the leader's environment setting FOREMAST_BF16_DELTA=0;
     every doc's (status, code, reason, anomaly_info) equal to a single
     worker's on the card after each tick, last band points within 1e-5,
     masked_stats launched on every rank in the f32 tick; each tick's
     seconds beside the single worker's, each rank's broadcasts (calls,
     bytes, seconds), result gathers (calls, bytes, seconds) and
     launches; (b) two `python -m foremast_tpu_torch worker --sharded
     --device cuda` processes on the fake Elasticsearch and Prometheus
     judge a 64-doc fleet to the single worker's writes, the leader
     alone serving /metrics, both exiting 0 on the leader's SIGTERM; (c)
     on 64 docs the leader calls os._exit on its 3rd fetch under
     FOREMAST_POD_TIMEOUT_SECONDS=10: the follower exits nonzero within
     25 s of it, and a single takeover worker judges every parked doc
     exactly once, to the single worker's writes.
Launch counts are zeroed just before each main path (phases 3-4, 5, 6,
7b, 7c, 7d, 8b, 8c, 8d, 9, 10, 11, 12, 13, 14, 15; phase 16's ranks
count their own around their ticks) and read just after its checked calls, so they
count the main paths' launches only: on the default worker path (phases
6 and 9) only the f32 cold fit launches a kernel (masked_stats); the seasonal
fits launch holt_winters_scan (Holt-Winters, and auto_univariate at m <=
64), holt_scan (double exponential smoothing) and masked_stats (every
mean model and identifiability guard); the joint paths launch
lstm_ae_forward (training, moments, every scoring), lstm_ae_backward
(training) and holt_winters_scan (the residual MVN's per-series fit).

`python3 chip_smoke.py --kernels-only` builds the kernels, runs phase 2,
7(a) and 8(a), times the two scan kernels at full size and stops: the
short first call after a kernel change. `python3 chip_smoke.py
--deployable-only` runs phase 9 alone (on fleets built for it), and
`--tenants-only` phase 10 alone, with two arms more in 10(a) that part
tenancy's costs: the same tenants without the arena envelope, and the
arenas' host seconds of `assign` and `scatter` in each sweep.
`--mesh-only` runs phase 11 alone, `--device-mesh-only` phase 12 alone,
`--control-loop-only` phase 13 alone, `--dashboard-only` phase 14 alone,
`--ops-only` phase 15 alone, `--pod-only` phase 16 alone. `--pod-rank`
is phase 16's own: one rank of its pods.

The last lines are the kernels line, the JSON kernel table, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import urllib.parse
import urllib.request

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
QUEUE_CYCLES = 60_000_000  # ~0.03 s ahead of a queued kernel timing: room to enqueue its calls
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
    # no Pallas kernel: these replace the LSTM autoencoder's lax.scan cell
    # and its jax.grad, inside the JAX package's vmapped training program
    "lstm_ae_forward": ("foremast_tpu_torch/ops/csrc/lstm_ae_forward.cu", "foremast_tpu/models/lstm_ae.py:82"),
    "lstm_ae_backward": ("foremast_tpu_torch/ops/csrc/lstm_ae_backward.cu", "foremast_tpu/models/lstm_ae.py:128"),
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


def queued_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Median over `repeats` of the mean device time of `iters` calls,
    queued behind a busy kernel: the host enqueues them all while the card
    sleeps, so a kernel shorter than its wrapper's host time (tens of
    microseconds a call) is timed back to back, not at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(QUEUE_CYCLES)
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
    out["done_at_return"] = pending.dev.done()
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
    anchor, delta, lens = _pack_hist_bf16_host(ragged, th, pin=True)
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
    return {"seconds": s, "score_from_arena_ms": ms, "score_from_arena_bound_ms": bound_ms, "tasks": tasks}


# ---------------------------------------------------------------------------
# phase 6: the worker's fleet tick (claim -> fetch -> judge -> write back)
# ---------------------------------------------------------------------------

ALIASES = ("latency", "error4xx", "error5xx", "tps")
WORKER_DOCS = 4096  # x 4 aliases = 16,384 windows, phase 5's width
F32_DOCS = 1024  # (d): one 4,096-window cold chunk on the f32 route


def worker_fleet(n_docs: int, t_now: int, seed: int = 13, labelled: bool = False, tenant_of=None):
    """The shape of `benchmarks/worker_bench.py`'s fleet: one document per
    service x 4 aliases, 7-day settled histories at a 60 s step, 30-point
    current windows riding inside the band (so the fleet stays on the
    re-check path, endTime an hour out), every even doc a canary with a
    baseline URL on every alias (its window the current signal plus
    noise, an hour earlier, under its own series name). Histories lie on
    a 1/64 grid, as in phase 5. Each URL's query names its series and
    its start and end bound exactly the samples it answers, so the ingest
    plane's ring (phase 9's push arm) resolves every window the pull
    path fetches; a doc's history and current window are one series.
    `labelled` names each series as a selector with the doc's `app`
    label (`latency{app="app7"}`), the routing label the receiver marks
    dirty. `tenant_of` (doc index -> tenant name) labels every selector
    with its doc's `tenant` as well (phase 10). Returns (documents as
    JSON, URL -> series, each doc's latency current URL)."""
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
        tenant = f',tenant="{tenant_of(i)}"' if tenant_of is not None else ""
        for k, a in enumerate(ALIASES):
            q = urllib.parse.quote(f'{a}{{app="app{i}"{tenant}}}') if labelled or tenant else f"{a}:app{i}"
            cur_url = f"http://prom/cur?q={q}&start={int(ct[0])}&end={int(ct[-1])}&step=60"
            hist_url = f"http://prom/hist?q={q}&start={int(ht[0])}&end={int(ht[-1])}&step=60"
            data[cur_url] = (ct, cv)
            if a == "latency":
                latency.append(cur_url)
            data[hist_url] = (ht, hist[i * len(ALIASES) + k])
            parts["current"].append(f"{a}== {cur_url}")
            parts["historical"].append(f"{a}== {hist_url}")
            if i % 2 == 0:
                bt = ct - 3600
                bq = (urllib.parse.quote(f'{a}_baseline{{app="app{i}"{tenant}}}') if labelled or tenant
                      else f"{a}_baseline:app{i}")
                base_url = f"http://prom/base?q={bq}&start={int(bt[0])}&end={int(bt[-1])}&step=60"
                data[base_url] = (bt, (cv + rng.normal(0, 0.01, FULL_TC)).astype(np.float32))
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


def array_source(series: dict):
    """An in-memory MetricSource over URL -> (times, values): exact-match
    lookups, no fetch threads."""
    from foremast_tpu_torch.metrics.source import MetricSource

    class ArraySource(MetricSource):
        concurrent_fetch = False

        def __init__(self):
            self.data = dict(series)

        def fetch(self, url: str):
            return self.data[url]

    return ArraySource()


@contextlib.contextmanager
def slice_env(n: int | None):
    """FOREMAST_SWEEP_SLICE_DOCS = n (None: unset) for the workers built
    inside, restored after."""
    saved = os.environ.pop("FOREMAST_SWEEP_SLICE_DOCS", None)
    if n is not None:
        os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = str(n)
    try:
        yield
    finally:
        os.environ.pop("FOREMAST_SWEEP_SLICE_DOCS", None)
        if saved is not None:
            os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = saved


def run_worker_ticks(device, docs, data, latency, t_now: int, tracer=None, f32: bool = True,
                     slice_docs: int | None = 0, hook=None, device_mesh=None) -> dict:
    """On one port worker over its own store (copies of `docs`) and
    source: (a) cold tick, (b) warm tick, (c) warm tick with the last 3
    latency points of every 16th doc spiked; then (d) the f32 cold tick of
    a fresh worker over the first F32_DOCS docs. After each: what the
    store holds, the arena counters, the fit-cache size, the columnar
    calls, the host-clock seconds (after a device sync), the tracer's
    stage breakdown and the sliced sweep's record. `slice_docs` is
    FOREMAST_SWEEP_SLICE_DOCS for the workers (None: unset, the default
    2,048; 0: the monolithic tick); a sliced worker on the card dispatches
    its columnar programs under set_sync_debug_mode("error"). `hook(worker,
    store)`, if given, runs on the main worker before its first tick.
    `device_mesh` is the workers' (phase 12 passes a mesh, or None for
    the single-device judge). Each tick records the kernel launches it
    made."""
    import gc

    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.ops import kernels as K

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def new_worker(doc_json, tr=None):
        store = InMemoryStore()
        for d in doc_json:
            store.create(Document.from_json(d))
        cfg = BrainConfig(max_cache_size=len(doc_json) * len(ALIASES) + 64)
        with slice_env(slice_docs):
            worker = BrainWorker(
                store, array_source(data), config=cfg, device=device,
                claim_limit=len(doc_json), worker_id=f"smoke-{device}", tracer=tr, device_mesh=device_mesh,
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
        check(len(worker._fit_cache) == 0 and not worker._uni._arenas, "warmup touched the real caches")
    calls = []
    orig = worker._uni.judge_columnar
    worker._uni.judge_columnar = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
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
    if cuda and worker._sweep_sliceable():
        dispatch = worker._dispatch_uni

        def strict_dispatch(packed):
            # the tick thread's async columnar dispatch must not synchronize
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(packed)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        worker._dispatch_uni = strict_dispatch
    if hook is not None:
        hook(worker, store)
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
        versions = (w._fit_cache.version, w._uni.device_state_counters()["misses"])
        launches = dict(K.LAUNCHES)
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
            counters=w._uni.device_state_counters(), fits=len(w._fit_cache),
            columnar=list(calls), refit=w._fit_cache.version != versions[0],
            scattered=w._uni.device_state_counters()["misses"] - versions[1],
            stages=dict(tracer.last_stage_seconds) if tracer is not None and w is worker else None,
            fast=dict(w._fast_kinds), sweep=dict(w._last_sweep) if w._last_sweep else None,
            launched={k: K.LAUNCHES[k] - v for k, v in launches.items()},
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

    if f32:
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

    # the monolithic tick outside the sliced arm (a worker of the later
    # phases built with a claim above 2,048 would otherwise slice)
    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
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
    check(not a["columnar"] and not any(a["fast"].values()), "(a) cold tick took the fast path")
    check(a["fits"] == n_win and a["scattered"] == n_win, f"(a) cold tick: {a['fits']} fits, {a['scattered']} scatters")
    for name, t in (("b", b), ("c", c)):
        check(sorted(t["columnar"]) == [half, half], f"({name}) columnar calls {t['columnar']}, want two of {half}")
        check(not t["refit"] and t["scattered"] == 0, f"({name}) warm tick fitted or scattered rows")
    check(b["fast"] == {"univariate": WORKER_DOCS // 2, "bivariate": 0, "lstm": 0, "baseline": WORKER_DOCS // 2},
          f"(b) buckets {b['fast']}")
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

    # the sliced arm: the same ticks as sliced sweeps, the knob unset (its
    # default, 2,048 docs a slice) and at 1,024; the columnar dispatches
    # on the tick thread under set_sync_debug_mode("error")
    for slice_docs, want_slices in ((None, WORKER_DOCS // 2048), (1024, WORKER_DOCS // 1024)):
        arm = run_worker_ticks(dev, docs, data, latency, t_now, f32=False, slice_docs=slice_docs)
        label = f"{slice_docs or 2048}-doc slices" + (" (the default)" if slice_docs is None else "")
        for name, what in (("a", "cold"), ("b", "warm"), ("c", "spiked warm")):
            t, sweep = arm[name], arm[name]["sweep"]
            check(t["docs"] == WORKER_DOCS and sweep is not None, f"sliced ({label}) ({name}): {t['docs']} docs, {sweep}")
            check(sweep["slices"] == want_slices, f"sliced ({label}) ({name}): {sweep['slices']} slices")
            diff = sum(t["written"][k] != v for k, v in gpu[name]["written"].items())
            check(t["written"] == gpu[name]["written"],
                  f"sliced ({label}) ({name}): writes differ from the monolithic tick's on {diff} docs")
            check(t["counters"] == gpu[name]["counters"], f"sliced ({label}) ({name}): arena counters {t['counters']}")
            pipe = sweep["pipeline"] or {}
            print(f"phase 6: sliced sweep, {label}, ({name}) {what}: {t['seconds']:.3f} s against the monolithic "
                  f"tick's {gpu[name]['seconds']:.3f} s; {sweep['slices']} slices, {sweep['slow_docs']} slow docs, "
                  f"preemptions: promoted {sweep['promoted']}, in-flight requeued {sweep['inflight_requeued']}, "
                  f"micro-ticks {sweep['preempt_microticks']}; warm pipeline overlap "
                  f"{pipe.get('overlap_ratio', 0.0):.2f}, judge stall {pipe.get('judge_stall_seconds', 0.0):.3f} s")
    print(f"phase 6: the sliced sweeps (2,048 and 1,024 docs a slice) wrote every doc's (status, code, reason, "
          f"anomaly_info) and the arena counters of the monolithic tick, cold, warm and spiked; their columnar "
          f"dispatches ran under set_sync_debug_mode(\"error\")")
    return {"seconds": {k: gpu[k]["seconds"] for k in "abcd"}, "fleet": (docs, data, t_now)}


# ---------------------------------------------------------------------------
# phase 9: the deployable worker (Elasticsearch + Prometheus over HTTP, the
# native packing library, fit journals, `python -m foremast_tpu_torch`)
# ---------------------------------------------------------------------------

# phase 6's fleet shape at 1,024 docs took 5.4 minutes for phase 9 alone
# (H100 80GB HBM3 at 700 W, `--deployable-only`), 4,096 JSON histories
# parsed per pass; cut to 512 docs, then to 384 when phase 10 came, then
# to 320 when phase 15 came: two claims of the CLI's default limit
# (256 + 64), so every pass still claims again over a half-judged fleet
DEPLOY_DOCS = 320  # x 4 aliases = 1,280 query_range histories of 7 days
DEPLOY_CLAIM = 256  # the CLI's default --claim-limit (FOREMAST_CLAIM_LIMIT)
DEPLOY_F32_DOCS = 128  # (d) the f32 CLI run: one claim
CLI_TIMEOUT = 240  # seconds for one CLI run to judge its fleet
# (e) the push arm's ring: 2,048 series of a 7-day history and its
# current window (10,110 points: a 16,384-point ring of 196,608 B) and
# 1,024 baselines (30 points: 3,072 B), about 406 MB. The default budget
# (256 MB) would evict about a third of the histories, whose cold fits
# would then fall back to HTTP without any error
PUSH_BUDGET_BYTES = 1 << 30
PUSH_BODY_SERIES = 64  # series per FMW1 body: <= 7.8 MB, under the receiver's 8 MiB cap
# (e) steady remote-write traffic while the push arm's warm passes tick:
# successive 15 s scrapes of STEADY_SERIES series that no document reads
# (one sample each, one scrape to a body: Prometheus' remote-write
# default max_samples_per_send is 2,000), spread over the ring's shards
# like the fleet's own, pushed by one client in a subprocess; the bodies
# wrap round (then as revisions) past the last. One warm pass takes them
# at STEADY_RATE, the stream of 100,000 active series scraped every 15 s
# (one mid-sized Prometheus sending all it scrapes); another back to
# back, the most one client gets the receiver to take while it ticks
STEADY_SERIES = 2_000
STEADY_BODIES = 256
STEADY_RATE = 100_000 / 15
STEADY_PUSHER = r"""
import json, os, signal, sys, time, urllib.request
url, folder, ctype, rate = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
bodies = [open(os.path.join(folder, f), "rb").read() for f in sorted(os.listdir(folder))]
stop = []
signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
n = samples = 0
t0 = time.perf_counter()
while not stop:
    if n and rate > 0:
        time.sleep(max(0.0, t0 + samples / rate - time.perf_counter()))
        if stop:
            break
    req = urllib.request.Request(url, data=bodies[n % len(bodies)], method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        samples += json.loads(resp.read())["accepted_samples"]
    if not n:
        print("answered", flush=True)
    n += 1
print(json.dumps({"bodies": n, "samples": samples, "seconds": time.perf_counter() - t0}), flush=True)
"""
FETCH_SPLIT_SAMPLE = 64  # history and current-window fetches timed part by part


def fetch_split(urls) -> list:
    """Mean ms per fetch of `PrometheusSource.fetch`'s three parts over
    `urls`: the HTTP round trip (request to the body's last byte), the
    `json.loads` of the body, and the per-point loop (`series_from_body`);
    each split result equal to `fetch`'s own."""
    from foremast_tpu_torch.metrics.source import PrometheusSource, series_from_body

    src = PrometheusSource()
    parts = []
    for url in urls:
        t0 = time.perf_counter()
        resp = src._get_with_retries(url)
        resp.raise_for_status()
        t1 = time.perf_counter()
        body = json.loads(resp.content)
        t2 = time.perf_counter()
        ts, vs = series_from_body(body)
        t3 = time.perf_counter()
        want = src.fetch(url)
        check(np.array_equal(ts, want[0]) and np.array_equal(vs, want[1]), f"the split fetch of {url} differs")
        parts.append((t1 - t0, t2 - t1, t3 - t2))
    return [1e3 * statistics.mean(p[i] for p in parts) for i in range(3)]


def push_entries(data: dict) -> list:
    """(key, times, values, start) of every ring series of a fleet: the
    samples of every URL whose query names the series, in time order,
    with the series' first sample as its coverage start; keys resolved
    from the URLs as the ring resolves them."""
    from foremast_tpu_torch.ingest import resolve_query_range

    series: dict = {}
    for url, (t, v) in data.items():
        series.setdefault(resolve_query_range(url)[0], []).append((t, v))
    out = []
    for key, parts in series.items():
        parts.sort(key=lambda p: int(p[0][0]))
        t = np.concatenate([p[0] for p in parts])
        check(bool(np.all(np.diff(t) > 0)), f"the windows of {key} overlap")
        out.append((key, t, np.concatenate([p[1] for p in parts]), float(t[0])))
    return out


def push_frames(url: str, entries: list, wait: float = 0.0) -> tuple:
    """POST `entries` to a receiver as FMW1 frames of PUSH_BODY_SERIES
    series each; (seconds, samples accepted, body bytes), the encoding
    included in the seconds. Only a failure to connect before the
    receiver's first answer is retried, for `wait` seconds while it comes
    up: an answer of 413 or 429 (an HTTPError) raises at once."""
    import urllib.error
    import urllib.request

    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, encode_frame

    deadline = time.monotonic() + wait
    t0 = time.perf_counter()
    samples = nbytes = 0
    for i in range(0, len(entries), PUSH_BODY_SERIES):
        body = encode_frame(entries[i : i + PUSH_BODY_SERIES])
        while True:
            req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": BINARY_CONTENT_TYPE})
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    samples += json.loads(resp.read())["accepted_samples"]
                break
            except urllib.error.HTTPError:
                raise
            except (urllib.error.URLError, ConnectionError):
                if nbytes or time.monotonic() > deadline:
                    raise
                time.sleep(0.25)
                if not nbytes:
                    t0 = time.perf_counter()  # time the push from the receiver's first answer
        nbytes += len(body)
    return time.perf_counter() - t0, samples, nbytes


def steady_bodies(folder: str, t_start: int) -> int:
    """Write STEADY_BODIES FMW1 bodies into `folder`: body k is the scrape
    at `t_start + 15 k` of STEADY_SERIES series that no document of the
    fleet reads. Returns the bytes of one body."""
    from foremast_tpu_torch.ingest import encode_frame

    rng = np.random.default_rng(11)
    keys = [f'foremast_smoke_scrape{{instance="i-{j}",job="steady"}}' for j in range(STEADY_SERIES)]
    vals = rng.normal(1.0, 0.1, (STEADY_BODIES, STEADY_SERIES)).astype(np.float32)
    for k in range(STEADY_BODIES):
        t = np.array([t_start + 15 * k], np.int64)
        body = encode_frame([(key, t, vals[k, j : j + 1], None) for j, key in enumerate(keys)])
        with open(os.path.join(folder, f"{k:04d}.fmw1"), "wb") as fh:
            fh.write(body)
    return len(body)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tick_lines(label: str, ticks: list) -> None:
    """Print each tick's wall clock, docs/s, spans, metric_fetch share,
    and (when recorded) Prometheus requests and cold-history reads."""
    names = ("claim", "metric_fetch", "fit", "score", "write_back")
    for k, t in enumerate(ticks):
        st = t["stages"]
        spans = ", ".join(f"{s} {st.get(s, 0.0):.4f}" for s in names)
        extra = ""
        if "prom" in t:
            cold = t["cold"]
            extra = (f"; {t['prom']} Prometheus requests; cold reads so far ring_full {cold['ring_full']} / http "
                     f"{cold['http']} / cache {cold['cache']}")
        print(f"phase 9: (b) {label} tick {k + 1}: {t['seconds']:.3f} s, {t['docs']} docs = "
              f"{t['docs'] / t['seconds']:.0f} docs/s; metric_fetch {100 * st.get('metric_fetch', 0.0) / t['seconds']:.1f} "
              f"% of the tick; spans {spans}; other spans {sum(st.values()) - sum(st.get(s, 0.0) for s in names):.4f}"
              f"{extra}")
    tot = sum(t["seconds"] for t in ticks)
    print(f"phase 9: (b) {label} pass: {len(ticks)} ticks, {tot:.3f} s = {DEPLOY_DOCS / tot:.0f} docs/s")


def pack_hist_before(series, length: int, pin: bool = False):
    """The judge's bf16-delta packing before the native library: rows
    copied into a zeroed f32 [B, L] scratch in a numpy loop, then the
    whole block cast to bf16 by torch (the upload pinned it afterwards).
    Returns (anchor, delta, lens) and records the two steps' seconds in
    `pack_hist_before.split`."""
    import torch

    t0 = time.perf_counter()
    b = len(series)
    delta = np.zeros((b, length), np.float32)
    anchor = np.zeros(b, np.float32)
    lens = np.zeros(b, np.int32)
    for i, (_, v) in enumerate(series):
        n = min(len(v), length)
        if n:
            row = np.asarray(v, np.float32)[:n]
            anchor[i] = row[0]
            np.subtract(row, anchor[i], out=delta[i, :n])
        lens[i] = n
    t1 = time.perf_counter()
    out = torch.from_numpy(delta).to(torch.bfloat16)
    pack_hist_before.split = (t1 - t0, time.perf_counter() - t1)
    return anchor, out, lens


class before_packing:
    """Within the block the judge packs as it did before the native
    library: `pack_hist_before` for the bf16-delta histories and the numpy
    loop for every `MetricWindows.from_ragged`."""

    def __enter__(self):
        from foremast_tpu_torch import native
        from foremast_tpu_torch.engine import judge

        self.saved = (judge._pack_hist_bf16_host, native.pack_windows)
        judge._pack_hist_bf16_host = pack_hist_before
        native.pack_windows = lambda *a, **kw: None
        return self

    def __exit__(self, *exc):
        from foremast_tpu_torch import native
        from foremast_tpu_torch.engine import judge

        judge._pack_hist_bf16_host, native.pack_windows = self.saved
        return False


def es_written(sources: dict) -> dict:
    """What phase 6's `written` records, from the fake index's documents."""
    from foremast_tpu_torch.jobs import Document

    out = {}
    for doc_id, src in sources.items():
        d = Document.from_json(src)
        out[doc_id] = json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
    return out


def all_judged(es, base: dict) -> bool:
    """Every document written back since `base` (its claim and its
    verdict: two writes) and none left in progress."""
    with es.lock:
        return all(
            es.writes[k] >= base.get(k, 0) + 2 and r["_source"].get("status") not in ("initial", "preprocess_inprogress")
            for k, r in es.docs.items()
        )


def sync_card() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def es_pass(worker, es, now: float, tracer, prom=None) -> list:
    """Tick the in-process worker until every document was judged once
    more; one record per tick (wall clock, docs, stage seconds, and with
    `prom` the fake Prometheus' requests in the tick and the worker's
    cold-history reads by source after it). The documents are first
    stamped as written long ago (the re-check loop at its poll interval):
    ticks that finish within one second would otherwise tie on the
    index's one-second stamps and re-claim docs of the pass while others
    wait."""
    es.set_status(None)
    base = dict(es.writes)
    ticks = []
    # the claim shuffles an oversampled page (2x the limit) of the oldest
    # claimable docs: once that page holds the whole fleet, a doc waits
    # about fleet/limit ticks for its turn, like a coupon collector
    for _ in range(24 * -(-len(es.docs) // worker.claim_limit)):
        sync_card()
        asked = sum(prom.requests.values()) if prom is not None else 0
        t0 = time.perf_counter()
        n = worker.tick(now=now)
        sync_card()
        ticks.append(dict(seconds=time.perf_counter() - t0, docs=n, stages=dict(tracer.last_stage_seconds)))
        if prom is not None:
            ticks[-1].update(prom=sum(prom.requests.values()) - asked, cold=dict(worker._cold_counts))
        if all_judged(es, base):
            return ticks
    check(False, f"{len(ticks)} ticks did not judge every document once")


def cli_run(es_url: str, snap_dir: str, es, workdir: str, tag: str, device, env_extra=None, started=None,
            gauge_port: int = 0, judged=None, fleet_docs: int | None = None) -> dict:
    """`python -m foremast_tpu_torch worker` as the deployed container runs
    it, until every document of the fake index was judged once; then
    SIGTERM, which must exit 0. `started()`, if given, runs once the
    process is started and before the wait (it may fill the index: then
    give the fleet's size as `fleet_docs`, which sizes the worker's fit
    cache, MAX_CACHE_SIZE; by default the index's documents at the call);
    `judged()`, if given, once the fleet is judged and before the SIGTERM
    (the worker serves /metrics and /debug/state on `gauge_port`, 0 for
    none). Returns the statuses, the startup lines, the JSON log records
    and the environment it ran in. Its stderr is printed on any failure."""
    import signal

    err_path = os.path.join(workdir, f"cli-{tag}.err")
    n_docs = len(es.docs) if fleet_docs is None else fleet_docs
    env = dict(os.environ, FOREMAST_SNAPSHOT_DIR=snap_dir, MAX_CACHE_SIZE=str(4 * n_docs + 64),
               PYTHONPATH=ROOT, **(env_extra or {}))
    cmd = [sys.executable, "-m", "foremast_tpu_torch", "worker", "--device", str(device), "--elastic-url", es_url,
           "--claim-limit", str(DEPLOY_CLAIM), "--gauge-port", str(gauge_port), "--poll", "0.2"]
    base = dict(es.writes)
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            if started is not None:
                started()
            while not all_judged(es, base):
                if proc.poll() is not None or time.perf_counter() - t0 > CLI_TIMEOUT:
                    break
                time.sleep(0.25)
            judged_s = time.perf_counter() - t0
            all_done = all_judged(es, base)
            if all_done and judged is not None:
                judged()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(err_path).read()
    if not all_done or rc != 0:
        print(f"({tag}) CLI stderr:\n{text[-20000:]}", file=sys.stderr)
    check(all_done, f"({tag}) the CLI worker did not judge the fleet within {CLI_TIMEOUT} s (rc={proc.returncode})")
    check(rc == 0, f"({tag}) the CLI worker exited {rc} on SIGTERM")
    records = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                records.append(json.loads(line))
            except ValueError:
                pass
    return dict(written=es_written(es.sources()), seconds=judged_s, stderr=text, records=records,
                lines=[ln for ln in text.splitlines() if not ln.startswith("{")], env=env)


def report_journal_keys(journal_dir: str, docs, first_tick) -> None:
    """A restart whose first tick was not all warm: each document's fit
    keys (`app|alias|history URL`, as the worker builds them) against
    the fit journal the restart restored (`journal_dir`, copied before
    it started). A doc with a key the journal lacks had to fit cold; a
    cold doc whose keys the journal holds missed its restored fits."""
    from foremast_tpu_torch.metrics import promql
    from foremast_tpu_torch.models.cache import FitJournal

    restored = FitJournal(os.path.join(journal_dir, "fit-fits")).restore()
    held = {k[-1] if isinstance(k, tuple) else k for k in restored}
    lacking = []
    for d in docs:
        for alias, url in promql.decode_config(d["historicalConfig"]).items():
            key = f"{d['appName']}|{alias}|{url}"
            if key not in held:
                lacking.append((d["id"], key))
    docs_lacking = sorted({doc for doc, _ in lacking})
    print(f"phase 9: (d) the restarted ingest CLI's first tick {first_tick}: the restored journal holds "
          f"{len(restored)} fits; {len(docs_lacking)} of {len(docs)} docs lack a fit key in it "
          f"({len(docs) - len(docs_lacking)} hold every key)")
    for doc, key in lacking:
        print(f"phase 9: (d) {doc}: fit key {key} held by the restored journal: False")


def cold_tick_before_after(dev, fit_tasks, worker_fleet_args) -> dict:
    """Phase 5's cold judge tick and phase 6's cold worker tick on fresh
    judges and workers, packed as before (`before_packing`) and with the
    native library, in the order before, after, after, before."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine.judge import HealthJudge
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.metrics.source import MetricSource
    from foremast_tpu_torch.models.cache import ModelCache

    docs, data, t_now = worker_fleet_args

    class ArraySource(MetricSource):
        concurrent_fetch = False

        def fetch(self, url: str):
            return data[url]

    def judge_tick():
        j = HealthJudge(BrainConfig(), device=dev)
        j.fit_cache = ModelCache(4 * len(fit_tasks))
        j.band_mode = "last"
        sync_card()
        t0 = time.perf_counter()
        j.judge(fit_tasks)
        sync_card()
        return time.perf_counter() - t0

    def worker_tick():
        store = InMemoryStore()
        for d in docs:
            store.create(Document.from_json(d))
        w = BrainWorker(store, ArraySource(), config=BrainConfig(max_cache_size=4 * len(docs) + 64),
                        device=dev, claim_limit=len(docs), worker_id="smoke-ab")
        sync_card()
        t0 = time.perf_counter()
        w.tick(now=t_now + 150)
        sync_card()
        return time.perf_counter() - t0

    out = {"judge": {"before": [], "after": []}, "worker": {"before": [], "after": []}}
    for arm in ("before", "after", "after", "before"):
        if arm == "before":
            with before_packing():
                out["judge"][arm].append(judge_tick())
                out["worker"][arm].append(worker_tick())
        else:
            out["judge"][arm].append(judge_tick())
            out["worker"][arm].append(worker_tick())
    return out


# (f) short-history admission and refinement: newcomers pushed with 1-2 days
# of their 7-day window into a pure-push ring with an admission floor
ADMIT_DOCS = 512
ADMIT_FLOOR = 80_000.0  # FOREMAST_ADMIT_MIN_COVERAGE_SECONDS: a day's coverage (86,400 s) clears it
ADMIT_HEAD_GAP = 4  # the pushes stop 4 steps short of the window's end: the head stays uncovered, the span fresh
# (g) micro-ticks: phase 6's 4,096-doc fleet, whose sweeps run sliced
# (MICRO_SLICES slices of 1,024 docs) with the dirty set wired, so a sweep
# takes longer than a micro-tick and arrivals meet its preemption points.
# MICRO_SPIKED docs a condition get a spike through the receiver, in a
# shuffled order, evenly over MICRO_WINDOW seconds from the end of a
# sweep, while the worker's run loop drains the dirty set every
# MICRO_SECONDS (FOREMAST_MICROTICK_SECONDS) between sweeps. Quiet, it
# sweeps every MICRO_POLL seconds (the CLI's default --poll): half the
# spikes meet the gap's micro-ticks, and the other half go in a burst
# as the next sweep starts, to meet its promotions, in-flight requeues
# and nested micro-ticks. Under a stream it sweeps
# every MICRO_STREAM_POLL seconds, and the spikes start MICRO_STREAM_WARM
# seconds into the stream: the window holds micro-ticks alone, whose
# latency is what the stream's share of the process costs
MICRO_DOCS = 4096
MICRO_SLICES = 4  # FOREMAST_SWEEP_SLICE_DOCS = MICRO_DOCS // MICRO_SLICES
# the 4,096-doc ring: 8x (e)'s 406 MB, with room for the shards' spread
MICRO_BUDGET_BYTES = 6 << 30
MICRO_SPIKED = 40  # with MICRO_WINDOW: one spike every 0.125 s
MICRO_SECONDS = 0.05
MICRO_POLL = 5.0
MICRO_STREAM_POLL = 30.0
MICRO_STREAM_WARM = 2.0
MICRO_WINDOW = 5.0
MICRO_BURST_SPACING = 0.01  # s between the quiet condition's pushes at a sweep's start
# the stream under which each condition runs: none, STEADY_RATE and back
# to back (rate 0); the last stream's series belong to apps another
# worker owns (the dirty set's ownership predicate refuses them): decoded,
# never marked, so no micro-tick claims for them. The two rates between
# STEADY_RATE and one client's most (10,000 and 15,000 samples/s) were
# cut to make room for phase 16: one client's accepted rate there
# scattered from run to run, so they measured the client more than the
# worker
MICRO_RATES = (("quiet", None, False), ("paced", STEADY_RATE, False), ("back to back", 0.0, False),
               ("back to back, another worker's apps", 0.0, True))
MICRO_STREAM_APPS = 250  # the stream's 2,000 series belong to 250 apps that have no document


class _Quiet:
    """Takes any WorkerMetrics call and keeps nothing."""

    def __getattr__(self, name):
        return _Quiet()

    def __call__(self, *a, **kw):
        return _Quiet()


class _Observations:
    def __init__(self):
        self.by_labels: dict = {}

    def labels(self, **labels):
        obs = self.by_labels.setdefault(tuple(sorted(labels.items())), [])
        return type("Child", (), {"observe": staticmethod(obs.append)})()

    def take(self, path: str) -> list:
        """The observations of `path` (every tenant) since the last take."""
        out = []
        for labels, obs in self.by_labels.items():
            if dict(labels).get("path") == path:
                out += obs
                obs.clear()
        return out


class LatencyMetrics(_Quiet):
    """WorkerMetrics' surface for the worker, keeping only the raw
    observations of foremast_verdict_latency_seconds, by its labels, and
    each sliced sweep's wall clock and counters (observe_sweep, the feed
    of foremast_sweep_slices_total and
    foremast_sweep_preempt_events_total): the card's machine has no
    prometheus_client, and raw values give exact quantiles where the
    family's buckets would interpolate."""

    def __init__(self):
        self.verdict_latency = _Observations()
        self.sweeps: list = []

    def observe_sweep(self, stats, counters: dict) -> None:
        self.sweeps.append(dict(counters, seconds=stats.wall_seconds if stats is not None else None))


def newcomer_fleet(n: int, t1: int, seed: int = 21):
    """(f)'s newcomers: one latency series each, whose doc asks for the
    7-day window ending at `t1` (FULL_TH points at a 60 s step) and a
    FULL_TC-point current window at the end of what is pushed. The series'
    values over the whole window (history noise on a 1/64 grid, the
    current window the band-centred signal of phase 6), and the three
    pushes: the first 1 or 2 days (alternating) ending ADMIT_HEAD_GAP
    steps short of `t1`, a backfill to 5 days, the oldest 2 days, and the
    head. Returns (docs as JSON, keys, ht, values, pushes, each doc's
    current window's stamps)."""
    from foremast_tpu_torch.ingest import canonical_series
    from foremast_tpu_torch.jobs import Document

    rng = np.random.default_rng(seed)
    ht = t1 - 60 * (FULL_TH - 1) + 60 * np.arange(FULL_TH, dtype=np.int64)
    hv = (np.round(64 * rng.normal(1.0, 0.1, (n, FULL_TH))) / 64).astype(np.float32)
    cv = (1.0 + 0.05 * np.sin(np.arange(FULL_TC) / 3.0)).astype(np.float32)
    end = FULL_TH - ADMIT_HEAD_GAP  # one past the last stamp of the first pushes
    hv[:, end - FULL_TC - 1 : end - 1] = cv
    ct = ht[end - FULL_TC - 1 : end - 1]
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t1 + 3600))
    docs, keys, pushes = [], [], ([], [], [], [])
    for i in range(n):
        expr = f'namespace_app_per_pod:latency{{namespace="ns",app="newcomer{i}"}}'
        key = canonical_series(expr)
        keys.append(key)
        day = 1440 * (1 + i % 2)
        for stage, sl in enumerate((slice(end - day, end), slice(end - 5 * 1440, end - day),
                                    slice(0, end - 5 * 1440), slice(end, FULL_TH))):
            pushes[stage].append((key, ht[sl], hv[i, sl], None))
        cur = f"http://prom/api/v1/query_range?query={urllib.parse.quote(expr)}&start={int(ct[0])}&end={int(ct[-1])}&step=60"
        hist = f"http://prom/api/v1/query_range?query={urllib.parse.quote(expr)}&start={int(ht[0])}&end={int(ht[-1])}&step=60"
        docs.append(Document(id=f"newcomer-{i}", app_name=f"newcomer{i}", end_time=end_time,
                             current_config=f"latency== {cur}", historical_config=f"latency== {hist}",
                             strategy="continuous").to_json())
    return docs, keys, ht, hv, pushes, ct


def admission_arm(dev, t1: int) -> dict:
    """Phase 9 (f): short-history admission and refinement on the card, on
    the bf16-delta route and the f32 one. Newcomers pushed with 1-2 days
    of coverage into a pure-push ring (`RingSource(fallback=None,
    admit_floor=ADMIT_FLOOR)`) through a receiver are judged on their
    first tick from provisional fits; a backfill to 5 days makes
    refinement invalidate every fit (one all-warm tick) and the next claim
    refit it; the window's head and oldest days close the window, and the
    terminal refit follows. The final fits must equal a fresh worker's
    from-scratch fit on the same ring within the band tolerance (their
    exact equality printed); then every 16th doc's current window is
    spiked, and one warm tick of each worker must write the same statuses,
    exactly the spiked docs flagged. Returns each route's record, and the
    launches of the refining worker's ticks (zeroed after its warmup; the
    from-scratch reference is not counted)."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.ingest import RingSource, RingStore, start_ingest_server, stop_ingest_server
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.models.cache import is_pad_fit_key
    from foremast_tpu_torch.ops import kernels as K

    cuda = torch.device(dev).type == "cuda"
    docs, keys, ht, hv, pushes, ct = newcomer_fleet(ADMIT_DOCS, t1)
    spiked = list(range(5, ADMIT_DOCS, 16))
    spikes = [(keys[i], ct[-3:], np.full(3, 40.0, np.float32), None) for i in spiked]
    launched = dict.fromkeys(K.LAUNCHES, 0)
    out = {}

    def written(store):
        return {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                for d in store._docs.values()}

    def new_worker(source, wid):
        store = InMemoryStore()
        for d in docs:
            store.create(Document.from_json(d))
        w = BrainWorker(store, source, config=BrainConfig(max_cache_size=2 * ADMIT_DOCS + 64), device=dev,
                        claim_limit=ADMIT_DOCS, worker_id=wid)
        # FOREMAST_REFINE_DOCS_PER_TICK at the fleet: one all-warm tick
        # invalidates every grown fit (the default 256 takes two)
        w.refine_docs_per_tick = ADMIT_DOCS
        return w, store

    for route, bf16 in (("bf16-delta", True), ("f32", False)):
        ring = RingStore(budget_bytes=PUSH_BUDGET_BYTES)
        srv, _ = start_ingest_server(0, ring, host="127.0.0.1")
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write"
        scoring.set_bf16_delta(bf16)
        try:
            source = RingSource(ring, fallback=None, admit_floor=ADMIT_FLOOR)
            w, store = new_worker(source, f"smoke-admit-{route}")
            if cuda:
                w.warmup()
            book = w._refine_book
            rec = {"ticks": []}

            def tick(what, now, expect):
                sync_card()
                t0 = time.perf_counter()
                n = w.tick(now=now)
                sync_card()
                rec["ticks"].append((what, time.perf_counter() - t0, n, dict(book.debug_state())))
                check(n == expect, f"(f) {route} {what}: {n} docs, want {expect}")

            rec["push_s"] = [push_frames(url, pushes[0])[0]]
            for k in K.LAUNCHES:
                K.LAUNCHES[k] = 0
            tick("first tick: provisional fits", t1 + 150, ADMIT_DOCS)
            cold = dict(w._cold_counts)
            check(cold["ring_partial"] == ADMIT_DOCS and len(book) == ADMIT_DOCS,
                  f"(f) {route} first tick: cold reads {cold}, {len(book)} provisional records")
            check({json.loads(v)[0] for v in written(store).values()} == {"preprocess_completed"},
                  f"(f) {route}: a newcomer's provisional judgment was not a healthy re-check")
            rec["push_s"].append(push_frames(url, pushes[1])[0])  # backfill to 5 days
            tick("all warm: refinement invalidates", t1 + 160, ADMIT_DOCS)
            check(book.debug_state()["refit"] == ADMIT_DOCS, f"(f) {route}: refinement {book.debug_state()}")
            tick("refit from 5 days", t1 + 170, ADMIT_DOCS)
            check(len(book) == ADMIT_DOCS and w._cold_counts["ring_partial"] == 2 * ADMIT_DOCS,
                  f"(f) {route}: after the refits {book.debug_state()}, cold reads {w._cold_counts}")
            rec["push_s"] += [push_frames(url, pushes[2])[0], push_frames(url, pushes[3])[0]]  # the window closes
            tick("all warm: refinement finalizes", t1 + 180, ADMIT_DOCS)
            check(book.debug_state()["finalized"] == ADMIT_DOCS and len(book) == 0,
                  f"(f) {route}: refinement {book.debug_state()}")
            tick("terminal refit, full window", t1 + 190, ADMIT_DOCS)
            check(w._cold_counts["ring_full"] == ADMIT_DOCS and len(book) == 0,
                  f"(f) {route}: cold reads {w._cold_counts}, book {book.debug_state()}")
            for k, v in K.LAUNCHES.items():
                launched[k] += v
            rec["launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
            if not bf16:
                check(K.LAUNCHES["masked_stats"] > 0, "(f) the f32 route launched no masked_stats")

            # the reference: a fresh worker's from-scratch fit of the same
            # columns (not counted), then one spiked warm tick of both
            fresh, fstore = new_worker(RingSource(ring, fallback=None, admit_floor=ADMIT_FLOOR), "smoke-scratch")
            sync_card()
            t0 = time.perf_counter()
            check(fresh.tick(now=t1 + 190) == ADMIT_DOCS, f"(f) {route}: the from-scratch worker lost docs")
            sync_card()
            rec["scratch_s"] = time.perf_counter() - t0
            fits, ref = ({k: v for k, v in c.snapshot().items() if not is_pad_fit_key(k)}
                         for c in (w._fit_cache, fresh._fit_cache))
            check(set(fits) == set(ref) and len(fits) == ADMIT_DOCS, f"(f) {route}: fit keys differ")
            err, exact = 0.0, 0
            for key, e in fits.items():
                r = ref[key]
                check(e[3] == r[3] and e[5] == r[5] == len(ht), f"(f) {route} {key}: phase or points {e[3:6:2]}, {r[3:6:2]}")
                e_err = max(abs(e[0] - r[0]), abs(e[1] - r[1]), abs(e[4] - r[4]),
                            float(np.max(np.abs(np.asarray(e[2]) - np.asarray(r[2])), initial=0.0)))
                err = max(err, e_err)
                exact += int(e_err == 0.0)
            # the same refit path over the same ring columns: equal bits,
            # not a tolerance, so a change of bucket or chunking shows
            check(exact == ADMIT_DOCS, f"(f) {route}: {ADMIT_DOCS - exact} refined fits differ from the "
                                       f"from-scratch fits (worst by {err:.3g})")
            push_frames(url, spikes)
            for k in K.LAUNCHES:
                K.LAUNCHES[k] = 0
            tick("spiked warm", t1 + 200, ADMIT_DOCS)
            for k, v in K.LAUNCHES.items():
                launched[k] += v
            check(fresh.tick(now=t1 + 200) == ADMIT_DOCS, f"(f) {route}: the from-scratch worker lost docs")
            got, want = written(store), written(fstore)
            diff = sum(got[k] != v for k, v in want.items())
            check(got == want, f"(f) {route}: the refined worker's writes differ from a from-scratch fit's on {diff} docs")
            unhealthy = sorted(k for k, v in got.items() if json.loads(v)[0] == STATUS_COMPLETED_UNHEALTH)
            check(unhealthy == sorted(f"newcomer-{i}" for i in spiked),
                  f"(f) {route}: flagged {len(unhealthy)} docs, want the {len(spiked)} spiked")
            rec.update(err=err, exact=exact, cold=dict(w._cold_counts), book=book.debug_state())
            out[route] = rec
            fresh.close()
            w.close()
        finally:
            scoring.set_bf16_delta(None)
            stop_ingest_server(srv)
    out["launches"] = launched
    return out


def micro_stream_bodies(folder: str, t_start: int) -> int:
    """(g)'s stream: STEADY_BODIES FMW1 bodies, body k the scrape at
    `t_start + 15 k` of STEADY_SERIES series of MICRO_STREAM_APPS apps
    that no document judges (the receiver marks each app dirty, and the
    micro-ticks find no document for it). Returns the bytes of one body."""
    from foremast_tpu_torch.ingest import encode_frame

    rng = np.random.default_rng(12)
    per_app = STEADY_SERIES // MICRO_STREAM_APPS
    keys = [f'foremast_smoke_scrape{{app="stream{j // per_app}",instance="i-{j}"}}' for j in range(STEADY_SERIES)]
    vals = rng.normal(1.0, 0.1, (STEADY_BODIES, STEADY_SERIES)).astype(np.float32)
    for k in range(STEADY_BODIES):
        t = np.array([t_start + 15 * k], np.int64)
        body = encode_frame([(key, t, vals[k, j : j + 1], None) for j, key in enumerate(keys)])
        with open(os.path.join(folder, f"{k:04d}.fmw1"), "wb") as fh:
            fh.write(body)
    return len(body)


def not_the_streams(key: str) -> bool:
    """(g)'s ownership predicate for the foreign-stream condition: the
    stream's apps belong to another worker, the fleet's to this one."""
    return 'app="stream' not in key


def microtick_arm(dev, n_docs: int, t_now: int, workdir: str) -> dict:
    """Phase 9 (g): push->verdict latency of micro-ticks against a
    sweep-only worker. Phase 6's fleet shape at `n_docs` docs, each series
    named with its doc's `app` label (the route key the receiver marks),
    bulk-loaded as FMW1 to a receiver with the dirty set wired. One worker
    over a fake Elasticsearch and that receiver's ring (claim limit above
    the fleet: a sweep claims every doc and is not saturated; sweeps
    sliced in MICRO_SLICES slices) runs its loop on a thread, started
    afresh for each condition: a sweep at once and then every MICRO_POLL
    s (MICRO_STREAM_POLL s under a stream), and between sweeps a
    micro-tick every MICRO_SECONDS s over what the dirty set holds.

    Each condition starts just after that first sweep ends. Quiet,
    MICRO_SPIKED docs spread over the fleet get their current window's
    last 3 points pushed as 40.0, in a shuffled order: half evenly in the
    gap, where they meet micro-ticks, and half in a burst (one a push
    every MICRO_BURST_SPACING s) as the next sweep starts, where they meet
    its slice boundaries (promotion, in-flight requeue, nested
    micro-tick). Under a stream (STEADY_SERIES-sample bodies of
    MICRO_STREAM_APPS apps without documents from a pusher subprocess at
    its rate, started at the sweep's end) the spikes go evenly over
    MICRO_WINDOW s from MICRO_STREAM_WARM s into it and meet micro-ticks
    alone; with micro-ticks off, evenly over MICRO_WINDOW s. The
    condition ends when all of them are written unhealthy and no arrival
    is pending. The latencies are the
    worker's foremast_verdict_latency_seconds observations (the
    receiver's arrival stamp to the verdict's write), by path, and each
    doc's as a client sees it (its push sent to its status unhealthy in
    the index, polled every 10 ms). Then one condition again with
    micro-ticks off, as the CLI runs without FOREMAST_MICROTICK_SECONDS
    (no dirty set in the worker): the loop sweeps back to back (a
    re-check fleet always has claimable docs), and the sweeps alone judge
    the arrivals. The sweeps must have promoted, requeued and
    micro-ticked arrivals at their boundaries, and every doc's writes
    must equal a full cold tick's over the same ring. Returns the
    conditions and the launches of the worker's ticks."""
    import signal
    import threading

    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.ingest import (
        BINARY_CONTENT_TYPE, RingSource, RingStore, resolve_query_range, start_ingest_server, stop_ingest_server,
    )
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.reactive import DirtySet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, serve_fake_es

    cuda = torch.device(dev).type == "cuda"
    stream_dir = os.path.join(workdir, "micro-stream")
    os.makedirs(stream_dir)
    body_bytes = micro_stream_bodies(stream_dir, int(time.time()) - 86_400)
    conditions = [*MICRO_RATES, ("sweeps only, quiet", None, False)]
    stride = n_docs // MICRO_SPIKED
    check(len(conditions) <= stride, "(g) not enough docs for a fresh spiked set per condition")
    rdocs, data, latency = worker_fleet(n_docs, t_now, seed=19, labelled=True)
    ring = RingStore(budget_bytes=MICRO_BUDGET_BYTES)
    dirty = DirtySet()
    srv, _ = start_ingest_server(0, ring, host="127.0.0.1", dirty=dirty)
    url = f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write"
    entries = push_entries(data)
    load_s, load_n, _ = push_frames(url, entries)
    check(load_n == sum(len(t) for _, t, _, _ in entries) and len(dirty) == n_docs,
          f"(g) bulk load: {load_n} samples accepted, {len(dirty)} route keys marked (want {n_docs} apps)")
    dirty.take_all()  # the bulk load is no arrival to judge
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    es.load(rdocs)
    metrics = LatencyMetrics()
    store = ElasticsearchStore(es_url)
    check(store.wait_ready(max_wait=30), f"the store did not connect: {store.connect_state}")
    worker = BrainWorker(store, RingSource(ring, fallback=None), config=BrainConfig(max_cache_size=4 * len(rdocs) + 64),
                         device=dev, claim_limit=len(rdocs) + 16, worker_id="smoke-micro", dirty=dirty,
                         metrics=metrics)
    worker.microtick_seconds = MICRO_SECONDS  # FOREMAST_MICROTICK_SECONDS
    worker.sweep_slice_docs = n_docs // MICRO_SLICES  # FOREMAST_SWEEP_SLICE_DOCS
    if cuda:
        worker.warmup()
    results = []
    stop = threading.Event()
    loop = None

    def start_loop(poll: float):
        t = threading.Thread(target=worker.run, kwargs=dict(poll_seconds=poll, stop=stop.is_set), daemon=True)
        t.start()
        return t

    def stop_loop() -> None:
        stop.set()
        loop.join(timeout=120)
        check(not loop.is_alive(), "(g) the worker's loop did not stop")
        stop.clear()

    try:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        check(worker.tick() == len(rdocs), "(g) the cold sweep lost docs")
        cold_s = time.perf_counter() - t0
        check(metrics.sweeps and metrics.sweeps[-1]["slices"] == MICRO_SLICES,
              f"(g) the cold sweep ran {metrics.sweeps[-1]['slices'] if metrics.sweeps else 0} slices")
        for c, (label, rate, foreign) in enumerate(conditions):
            # a fresh loop each condition: its first sweep starts at once
            if loop is not None:
                stop_loop()
            if label.startswith("sweeps only"):
                # the CLI without FOREMAST_MICROTICK_SECONDS: no dirty set
                # in the worker, so no micro-tick and no preemption point;
                # the loop then sweeps back to back
                worker.microtick_seconds = 0.0
                worker.dirty = None
            loop = start_loop(MICRO_POLL if rate is None else MICRO_STREAM_POLL)
            dirty.owns = not_the_streams if foreign else None
            pusher = None
            try:
                at = worker._last_tick["at"]
                deadline = time.monotonic() + 4 * MICRO_POLL + 120
                while worker._last_tick["at"] == at:  # start just after a sweep
                    check(time.monotonic() < deadline and loop.is_alive(), f"(g) {label}: no sweep finished")
                    time.sleep(0.005)
                if rate is not None:
                    pusher = subprocess.Popen([sys.executable, "-c", STEADY_PUSHER, url, stream_dir,
                                               BINARY_CONTENT_TYPE, str(rate)], stdout=subprocess.PIPE, text=True)
                    check(pusher.stdout.readline().strip() == "answered", "(g) the stream's first body got no answer")
                    time.sleep(MICRO_STREAM_WARM)
                metrics.verdict_latency.take("micro")
                metrics.verdict_latency.take("sweep")
                counts0, n_sweeps0, runs0 = dirty.counts(), len(metrics.sweeps), worker._last_micro["runs"]
                # spread over the fleet, pushed in a shuffled order: an
                # arrival during a sweep may meet its doc in any slice
                order = np.random.default_rng(c).permutation(MICRO_SPIKED)
                ids = [f"job-{c + stride * int(k)}" for k in order]
                spikes = []
                for doc_id in ids:
                    t, _ = data[latency[int(doc_id[4:])]]
                    spikes.append((resolve_query_range(latency[int(doc_id[4:])])[0], t[-3:],
                                   np.full(3, 40.0, np.float32), None))
                sent: dict = {}

                # quiet, with micro-ticks: half the spikes in the gap, the
                # other half in a burst as the next sweep starts, so that
                # they meet its slice boundaries with docs pooled, in
                # flight and written
                n_even = MICRO_SPIKED // 2 if rate is None and worker.dirty is not None else MICRO_SPIKED

                def push_spread(spikes=spikes, ids=ids, sent=sent, n_even=n_even):
                    t_start = time.perf_counter()
                    for k, (doc_id, spike) in enumerate(zip(ids, spikes)):
                        if k < n_even:
                            time.sleep(max(0.0, t_start + k * MICRO_WINDOW / MICRO_SPIKED - time.perf_counter()))
                        elif k == n_even:
                            while not worker._sweep_active and time.perf_counter() - t_start < 4 * MICRO_POLL + 60:
                                time.sleep(0.001)
                        else:
                            time.sleep(MICRO_BURST_SPACING)
                        sent[doc_id] = time.perf_counter()
                        push_frames(url, [spike])

                pushing = threading.Thread(target=push_spread, daemon=True)
                t_push = time.perf_counter()
                pushing.start()
                seen: dict = {}
                while len(seen) < len(ids):
                    check(time.perf_counter() - t_push < MICRO_WINDOW + 4 * MICRO_POLL + 120 and loop.is_alive(),
                          f"(g) {label}: {len(seen)} of {len(ids)} spiked docs judged")
                    now_s = time.perf_counter()
                    with es.lock:
                        done = [i for i in ids if i not in seen and i in sent
                                and es.docs[i]["_source"].get("status") == STATUS_COMPLETED_UNHEALTH]
                    for i in done:
                        seen[i] = now_s - sent[i]
                    time.sleep(0.01)
                pushing.join(timeout=60)
                check(not pushing.is_alive(), f"(g) {label}: the spike pushes did not finish")
            finally:
                stream = None
                if pusher is not None:
                    pusher.send_signal(signal.SIGTERM)
                    text, _ = pusher.communicate(timeout=60)
                    check(pusher.returncode == 0, f"(g) the stream's pusher exited {pusher.returncode}")
                    stream = json.loads(text.strip().splitlines()[-1])
            if worker.dirty is not None:
                # settle: a verdict the client has seen may still be short
                # of its observation, or of its requeued arrival's drop;
                # wait until no arrival is pending anywhere (three reads
                # 10 ms apart, as a take hands entries to a cycle)
                quiet_reads, deadline = 0, time.monotonic() + 4 * MICRO_POLL + 120
                while quiet_reads < 3:
                    check(time.monotonic() < deadline and loop.is_alive(), f"(g) {label}: arrivals never settled")
                    idle = not len(dirty) and not worker._sweep_active and not worker._ledger.pending
                    quiet_reads = quiet_reads + 1 if idle else 0
                    time.sleep(0.01)
            micro, sweep = metrics.verdict_latency.take("micro"), metrics.verdict_latency.take("sweep")
            counts = dirty.counts()
            sweeps = metrics.sweeps[n_sweeps0:]
            pre = {k: counts[k] - counts0[k] for k in ("promoted", "inflight_requeued", "unattributed", "foreign")}
            pre["preempt_microticks"] = sum(sw["preempt_microticks"] for sw in sweeps)
            if label.startswith("sweeps only"):
                check(not micro and not sweep and not pre["preempt_microticks"],
                      f"(g) {label}: {len(micro)} micro, {len(sweep)} sweep latency observations and "
                      f"{pre['preempt_microticks']} preemption micro-ticks without a dirty set")
            elif rate is None or foreign:
                # every spiked doc's arrival is observed, or dropped as
                # unattributed: an arrival marked after the sweep's
                # catch-all drain, whose window a slice then read, has its
                # verdict written by the sweep unseen, and the boundary's
                # micro-tick finds the doc terminal. Here no other key is
                # marked, so the two must add up
                check(len(micro) + len(sweep) + pre["unattributed"] == MICRO_SPIKED,
                      f"(g) {label}: {len(micro)} micro + {len(sweep)} sweep latency observations and "
                      f"{pre['unattributed']} unattributed arrivals, want {MICRO_SPIKED}")
            else:
                # the stream's apps are marked too, and are unattributed
                check(len(micro) + len(sweep) <= MICRO_SPIKED,
                      f"(g) {label}: {len(micro)} micro + {len(sweep)} sweep latency observations, want <= {MICRO_SPIKED}")
            results.append(dict(label=label, rate=rate, micro=micro, sweep=sweep, seen=[seen[i] for i in ids[:n_even]],
                                seen_burst=[seen[i] for i in ids[n_even:]],
                                stream=stream, preempt=pre, sweeps=[sw["seconds"] for sw in sweeps],
                                microticks=worker._last_micro["runs"] - runs0))
        stop.set()
        loop.join(timeout=120)
        check(not loop.is_alive(), "(g) the worker's loop did not stop")
        launched = dict(K.LAUNCHES)
        dirty_counts = dirty.counts()
    finally:
        stop.set()
        worker.close()
        stop_ingest_server(srv)
        es_srv.shutdown()
        es_srv.server_close()
    for key in ("promoted", "inflight_requeued", "preempt_microticks"):
        n = sum(r["preempt"][key] for r in results)
        check(n > 0, f"(g) the sliced sweeps' boundaries saw {n} {key} arrivals")
    check(ring.stats()["evictions"] == 0, f"(g) the ring evicted {ring.stats()['evictions']} series")

    # the reference: one full (monolithic) cold tick of a fresh worker
    # over the same ring
    ref_store = InMemoryStore()
    for d in rdocs:
        ref_store.create(Document.from_json(d))
    ref = BrainWorker(ref_store, RingSource(ring, fallback=None), config=BrainConfig(max_cache_size=4 * len(rdocs) + 64),
                      device=dev, claim_limit=len(rdocs), worker_id="smoke-micro-ref")
    ref.sweep_slice_docs = 0
    check(ref.tick() == len(rdocs), "(g) the reference tick lost docs")
    ref.close()
    want = {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
            for d in ref_store._docs.values()}
    got = es_written(es.sources())
    diff = sum(got[k] != v for k, v in want.items())
    check(got == want, f"(g) the micro-ticked fleet's writes differ from a full tick's on {diff} docs")
    flagged = sum(json.loads(v)[0] == STATUS_COMPLETED_UNHEALTH for v in got.values())
    check(flagged == len(conditions) * MICRO_SPIKED, f"(g) {flagged} docs flagged, want {len(conditions) * MICRO_SPIKED}")
    return dict(conditions=results, cold_s=cold_s, body_bytes=body_bytes, dirty=dirty_counts,
                launches=launched, load=(load_s, load_n))


def report_microtick_arm(micro: dict, smi: str) -> None:
    """Print (g)'s conditions: latency by path, the sweeps' wall clock,
    micro-ticks, and the preemption and dirty-set counters."""
    print(f"phase 9: (g) micro-ticks every {MICRO_SECONDS} s between sweeps every {MICRO_POLL} s ({MICRO_STREAM_POLL}"
          f" s under a stream), {MICRO_DOCS} docs with app-labelled series swept in {MICRO_SLICES} slices of "
          f"{MICRO_DOCS // MICRO_SLICES} (bulk load {micro['load'][1]} samples in {micro['load'][0]:.3f} s, cold "
          f"sweep {micro['cold_s']:.3f} s), {MICRO_SPIKED} docs spiked through the receiver per condition from the "
          f"end of a sweep ({MICRO_STREAM_WARM} s later under a stream), evenly over {MICRO_WINDOW} s (quiet with "
          f"micro-ticks: half of them, the rest {MICRO_BURST_SPACING} s apart as the next sweep starts), on {smi}; "
          f"push->verdict latency (foremast_verdict_latency_seconds by path: the "
          f"receiver's arrival stamp to the verdict's write; client-seen: the push sent to the status read "
          f"from the index):")
    for cond in micro["conditions"]:
        stream = cond["stream"]
        rate = ("no stream" if stream is None else
                f"stream {stream['samples'] / stream['seconds']:.0f} samples/s over {stream['seconds']:.1f} s "
                f"({stream['bodies']} bodies of {STEADY_SERIES} samples, {micro['body_bytes']} B each)")
        parts = []
        for path, what in (("micro", "micro"), ("sweep", "sweep"), ("seen", "client-seen"),
                           ("seen_burst", "client-seen, the burst at a sweep's start")):
            obs = cond[path]
            if obs:
                parts.append(f"{what} {len(obs)}: p50 {np.percentile(obs, 50):.4f} s, p99 "
                             f"{np.percentile(obs, 99):.4f} s, max {max(obs):.4f} s")
        pre, sw = cond["preempt"], [x for x in cond["sweeps"] if x is not None]
        sweeps = (f"{len(sw)} sweeps of {min(sw):.3f}-{max(sw):.3f} s" if sw else "no sweep")
        print(f"phase 9: (g) {cond['label']}: {rate}; {'; '.join(parts)}; {sweeps}, {cond['microticks']} "
              f"micro-ticks in all; at slice boundaries promoted {pre['promoted']}, in-flight requeued "
              f"{pre['inflight_requeued']}, nested micro-ticks {pre['preempt_microticks']}; dirty keys "
              f"unattributed {pre['unattributed']}, foreign {pre['foreign']}")
    print(f"phase 9: (g) dirty set {micro['dirty']}; every doc's writes equal one full cold tick's over the same "
          f"ring")


def phase_deployable_worker(dev, smi: str, fit_tasks, worker_fleet_args) -> dict:
    """Phase 9: the worker as deployed. (a) A BrainWorker over
    ElasticsearchStore and PrometheusSource against a fake ES and a fake
    Prometheus on loopback sockets (320 docs x 4 aliases, claim limit
    256): cold ticks until the fleet is judged, a warm pass and a spiked
    warm pass, each document's writes equal to phase 6's in-memory worker
    on the same fleet; (e) the push arm: every series pushed as FMW1
    frames to the port's receiver in this process (a bulk load), then the
    same three passes through RingSource(ring, fallback=PrometheusSource)
    with 0 Prometheus requests, 0 evictions and the same writes, the warm
    pass under steady remote-write of series no document reads (paced,
    then once more back to back), and an f32
    cold pass on a fresh worker (masked_stats) equal to phase 6's f32
    tick; (b) each tick's wall clock, spans and metric_fetch share, and
    PrometheusSource.fetch split into round trip, json.loads and the
    per-point loop; (c) phase 5's cold chunk packed before and after the
    native library, and phase 5's and phase 6's cold ticks before and
    after; (d) the CLI as a subprocess: judge, SIGTERM, restart warm on
    its fit journals, an f32 run that launches masked_stats, and with
    FOREMAST_INGEST=1 a run judged from samples pushed to its receiver
    and a restart on its restored ring, both with 0 Prometheus requests.
    Returns the launches of its main path: the in-process pull and push
    passes (counts zeroed just before the first, after both workers'
    warmups, and read just after the push arm's f32 pass) plus the CLI's
    f32 run, which reports its own when it stops (zeroed after its
    warmup). The reference run, the warmups, the fetch split, the packing
    comparison and the CLI's bf16 runs are not counted."""
    import signal
    import tempfile

    import torch

    from foremast_tpu_torch import native
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import _FIT_CHUNK, _pack_hist_bf16_host, bucket_length
    from foremast_tpu_torch.ingest import (
        BINARY_CONTENT_TYPE, RingSource, RingStore, resolve_query_range, start_ingest_server,
    )
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, BrainWorker
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.metrics.source import PrometheusSource
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.ops import kernels as K

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    check(native.ensure_built(), f"the native packing library did not load: {native.error()}")
    # histories that ended 10 minutes ago: settled (the worker caches and
    # journals only ranges older than HIST_SETTLED_SECONDS) for the CLI's
    # real clock too; endTime stays 50 minutes ahead
    t_now = int(time.time()) - 600
    t0 = time.perf_counter()
    docs, data, latency = worker_fleet(DEPLOY_DOCS, t_now)
    print(f"phase 9: fleet of {DEPLOY_DOCS} docs x {len(ALIASES)} aliases (Th={FULL_TH}, Tc={FULL_TC}, half "
          f"canaries) built in {time.perf_counter() - t0:.1f} s; served by a fake Elasticsearch and a fake "
          f"Prometheus on loopback sockets in this process")
    ref = run_worker_ticks(dev, docs, data, latency, t_now)

    servers = []
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    servers.append(prom_srv)
    rdocs, keyed = rebase(docs, data, "http://prom", prom_url)
    prom.data = dict(keyed)
    t0 = time.perf_counter()
    prom.prepare()  # set-up: every answer encoded before the first tick
    print(f"phase 9: cut from phase 6's 4,096 docs to {DEPLOY_DOCS}; {len(keyed)} query_range answers "
          f"({sum(map(len, prom._bodies.values())) / 1e6:.0f} MB of JSON) encoded in {time.perf_counter() - t0:.1f} s")
    workdir = tempfile.mkdtemp(prefix="foremast-phase9-")
    try:
        # (a) in process
        es_srv, es, es_url = serve_fake_es()
        servers.append(es_srv)
        es.load(rdocs)
        store = ElasticsearchStore(es_url)
        check(store.wait_ready(max_wait=30), f"the store did not connect: {store.connect_state}")
        tracer = Tracer()
        worker = BrainWorker(
            store, PrometheusSource(), config=BrainConfig(max_cache_size=4 * DEPLOY_DOCS + 64), device=dev,
            claim_limit=DEPLOY_CLAIM, worker_id="smoke-es", tracer=tracer,
        )
        if torch.device(dev).type == "cuda":
            worker.warmup()
        # the push arm's ring, receiver and first worker, built and warmed
        # here: its warmup is no part of the main path
        ring = RingStore(budget_bytes=PUSH_BUDGET_BYTES)
        ing_srv, _ = start_ingest_server(0, ring, host="127.0.0.1")
        servers.append(ing_srv)
        ing_url = f"http://127.0.0.1:{ing_srv.server_address[1]}/api/v1/write"
        es_srv_p, es_p, es_url_p = serve_fake_es(FakeElasticsearch())
        servers.append(es_srv_p)
        es_p.load(rdocs)
        tracer_p = Tracer()
        store_p = ElasticsearchStore(es_url_p)
        check(store_p.wait_ready(max_wait=30), f"the store did not connect: {store_p.connect_state}")
        worker_p = BrainWorker(
            store_p, RingSource(ring, fallback=PrometheusSource()), config=BrainConfig(max_cache_size=4 * DEPLOY_DOCS + 64),
            device=dev, claim_limit=DEPLOY_CLAIM, worker_id="smoke-push", tracer=tracer_p,
        )
        if torch.device(dev).type == "cuda":
            worker_p.warmup()
        passes = {}
        # the in-process main path: counted from the pull arm's first pass
        # to the push arm's f32 pass, and nothing else of this phase. What
        # lies between them launches nothing: the fetch split, the pushes,
        # the steady pusher's bodies (written on the host) and the f32
        # worker's construction; both workers were warmed up above
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        passes["a"] = es_pass(worker, es, t_now + 150, tracer, prom)
        got_a = es_written(es.sources())
        hist_fetches = prom.requests["/hist"]
        passes["b"] = es_pass(worker, es, t_now + 200, tracer, prom)
        got_b = es_written(es.sources())
        spiked = [f"job-{i}" for i in range(5, DEPLOY_DOCS, 16)]
        for i in range(5, DEPLOY_DOCS, 16):
            u = urllib.parse.urlsplit(latency[i])
            key = f"{u.path}?{u.query}"
            t, v = prom.data[key]
            v = v.copy()
            v[-3:] = 40.0
            prom.set_series(key, (t, v))
        passes["c"] = es_pass(worker, es, t_now + 250, tracer, prom)
        got_c = es_written(es.sources())
        worker.close()
        for i in range(5, DEPLOY_DOCS, 16):  # unspiked again for the CLI runs
            u = urllib.parse.urlsplit(latency[i])
            prom.set_series(f"{u.path}?{u.query}", keyed[f"{u.path}?{u.query}"])
        for name, got in (("a", got_a), ("b", got_b), ("c", got_c)):
            diff = sum(got[k] != v for k, v in ref[name]["written"].items())
            check(got == ref[name]["written"],
                  f"({name}) the HTTP worker's writes differ from phase 6's in-memory worker on {diff} docs")
        unhealthy = sorted(k for k, v in got_c.items() if json.loads(v)[0] == STATUS_COMPLETED_UNHEALTH)
        check(unhealthy == sorted(spiked), f"(c) flagged {len(unhealthy)} docs, want the {len(spiked)} spiked")
        check(hist_fetches == DEPLOY_DOCS * len(ALIASES), f"(a) fetched {hist_fetches} histories")
        print(f"phase 9: (a) every doc's (status, code, reason, anomaly_info) after the cold, warm and spiked "
              f"passes equals phase 6's in-memory worker on the same fleet; (c) flagged exactly the "
              f"{len(spiked)} spiked docs; {hist_fetches} history fetches over HTTP, all in the cold pass")


        # the fetch split, on a sample of the pull arm's URLs
        hist_urls = sorted(u for u in keyed if u.startswith("/hist"))[:FETCH_SPLIT_SAMPLE]
        cur_urls = sorted(u for u in keyed if u.startswith("/cur"))[:FETCH_SPLIT_SAMPLE]
        split = {what: fetch_split([prom_url + u for u in urls])
                 for what, urls in (("history", hist_urls), ("current", cur_urls))}

        # (e) the push arm: the same fleet's samples pushed to the port's
        # receiver, then the same passes served from the ring
        entries = push_entries(data)
        push_s, push_n, push_bytes = push_frames(ing_url, entries)
        n_samples = sum(len(t) for _, t, _, _ in entries)
        check(push_n == n_samples, f"(e) the receiver accepted {push_n} of {n_samples} samples")
        steady_dir = os.path.join(workdir, "steady")
        os.makedirs(steady_dir)
        steady_body = steady_bodies(steady_dir, t_now - 86_400)
        prom.requests.clear()
        pushed = {}
        pushed["a"] = es_pass(worker_p, es_p, t_now + 150, tracer_p, prom)
        got_pa = es_written(es_p.sources())
        def steady_pass(now: float, rate: float) -> tuple:
            """A warm pass under steady remote-write into the shards the
            ticks read, from the receiver's first answer to the pass's
            end: (ticks, the pusher's bodies, samples and seconds)."""
            pusher = subprocess.Popen(
                [sys.executable, "-c", STEADY_PUSHER, ing_url, steady_dir, BINARY_CONTENT_TYPE, str(rate)],
                stdout=subprocess.PIPE, text=True,
            )
            try:
                check(pusher.stdout.readline().strip() == "answered", "(e) the steady pusher's first body got no answer")
                ticks = es_pass(worker_p, es_p, now, tracer_p, prom)
                pusher.send_signal(signal.SIGTERM)
                out, _ = pusher.communicate(timeout=60)
            finally:
                if pusher.poll() is None:
                    pusher.kill()
                    pusher.wait()
            check(pusher.returncode == 0, f"(e) the steady pusher exited {pusher.returncode}")
            got = json.loads(out.strip().splitlines()[-1])
            check(got["samples"] == got["bodies"] * STEADY_SERIES,
                  f"(e) the receiver accepted {got['samples']} of the steady pusher's {got['bodies'] * STEADY_SERIES} samples")
            return ticks, got

        steady = {}
        pushed["b"], steady["paced"] = steady_pass(t_now + 200, STEADY_RATE)
        got_pb = es_written(es_p.sources())
        pushed["b_max"], steady["back to back"] = steady_pass(t_now + 225, 0.0)
        got_pb_max = es_written(es_p.sources())
        spikes, unspikes = [], []
        for i in range(5, DEPLOY_DOCS, 16):
            key = resolve_query_range(latency[i])[0]
            t, v = data[latency[i]]
            spikes.append((key, t[-3:], np.full(3, 40.0, np.float32), None))
            unspikes.append((key, t[-3:], v[-3:], None))
        push_frames(ing_url, spikes)  # revisions: the last write wins
        pushed["c"] = es_pass(worker_p, es_p, t_now + 250, tracer_p, prom)
        got_pc = es_written(es_p.sources())
        cold_p = dict(worker_p._cold_counts)
        worker_p.close()
        # one more cold pass on the f32 route, a fresh worker and index
        push_frames(ing_url, unspikes)
        es_srv_pf, es_pf, es_url_pf = serve_fake_es(FakeElasticsearch())
        servers.append(es_srv_pf)
        es_pf.load(rdocs)
        store_f = ElasticsearchStore(es_url_pf)
        check(store_f.wait_ready(max_wait=30), f"the store did not connect: {store_f.connect_state}")
        worker_f = BrainWorker(
            store_f, RingSource(ring, fallback=PrometheusSource()),
            config=BrainConfig(max_cache_size=4 * DEPLOY_DOCS + 64), device=dev, claim_limit=DEPLOY_CLAIM,
            worker_id="smoke-push-f32", tracer=tracer_p,
        )
        masked_before = K.LAUNCHES["masked_stats"]
        scoring.set_bf16_delta(False)
        try:
            pushed["f32"] = es_pass(worker_f, es_pf, t_now + 150, tracer_p, prom)
        finally:
            scoring.set_bf16_delta(None)
        launched_here = dict(K.LAUNCHES)
        got_pf = es_written(es_pf.sources())
        cold_f = dict(worker_f._cold_counts)
        worker_f.close()
        # the same windows as ring reads, one at a time on this thread
        # (the worker fans its fetches over its fetch pool), timed on the
        # second read, with each URL's resolution memoized as in a worker
        ring_src = RingSource(ring)
        ring_ms = {}
        for what, urls in (("history", hist_urls), ("current", cur_urls)):
            got = [ring_src.fetch(prom_url + u) for u in urls]
            want = [keyed[u] for u in urls]
            check(all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) for g, w in zip(got, want)),
                  f"(e) a ring read of a {what} window differs from the pull path's series")
            t0 = time.perf_counter()
            for u in urls:
                ring_src.fetch(prom_url + u)
            ring_ms[what] = 1e3 * (time.perf_counter() - t0) / len(urls)
        ring_stats = ring.stats()
        for name, got in (("a", got_pa), ("b", got_pb), ("b", got_pb_max), ("c", got_pc)):
            diff = sum(got[k] != v for k, v in ref[name]["written"].items())
            check(got == ref[name]["written"], f"(e) the push arm's writes differ from the pull arm's after ({name}) on {diff} docs")
        diff = sum(got_pf[k] != v for k, v in ref["d"]["written"].items())
        check(got_pf == ref["d"]["written"], f"(e) the push arm's f32 pass differs from phase 6's f32 tick on {diff} docs")
        asked = sum(t["prom"] for ticks in pushed.values() for t in ticks)
        check(asked == 0 and sum(prom.requests.values()) == 0,
              f"(e) the ring-served passes sent {asked} requests to Prometheus: {dict(prom.requests)}")
        n_hist = DEPLOY_DOCS * len(ALIASES)
        check(cold_p["ring_full"] == n_hist and cold_p["http"] == cold_p["cache"] == 0,
              f"(e) cold reads {cold_p}, want {n_hist} ring_full")
        check(cold_f["ring_full"] == n_hist and cold_f["http"] == 0, f"(e) the f32 pass's cold reads {cold_f}")
        check(ring_stats["evictions"] == 0, f"(e) the ring evicted {ring_stats['evictions']} series")
        masked_f32 = launched_here["masked_stats"] - masked_before
        check(masked_f32 > 0, "(e) the push arm's f32 pass launched no masked_stats")
        print(f"phase 9: (e) bulk load: pushed {len(entries)} series ({n_samples} samples, {push_bytes / 1e6:.1f} MB of "
              f"FMW1 in {-(-len(entries) // PUSH_BODY_SERIES)} bodies) to the port's receiver in {push_s:.3f} s = "
              f"{n_samples / push_s:.0f} samples/s before any tick")
        for how, got in steady.items():
            print(f"phase 9: (e) steady remote-write during a warm pass, {how} "
                  f"({'to %.0f samples/s' % STEADY_RATE if how == 'paced' else 'one client'}): {got['bodies']} "
                  f"bodies of {STEADY_SERIES} samples ({steady_body} B of FMW1 each) = {got['samples']} samples in "
                  f"{got['seconds']:.3f} s = {got['samples'] / got['seconds']:.0f} samples/s into the shards the ticks "
                  f"read; the pass's writes still equal the pull arm's warm pass")
        print(f"phase 9: (e) ring {ring_stats['series']} series ({STEADY_SERIES} of them the steady stream's), {ring_stats['bytes']} bytes "
              f"resident of a {PUSH_BUDGET_BYTES}-byte budget, {ring_stats['evictions']} evictions, "
              f"{ring_stats['hits']} hits / {ring_stats['misses']} misses / {ring_stats['stale']} stale / "
              f"{ring_stats['uncovered']} uncovered")
        print(f"phase 9: (e) every doc's (status, code, reason, anomaly_info) after the ring-served cold, warm and "
              f"spiked passes equals the pull arm's, and after the f32 cold pass phase 6's f32 tick; 0 Prometheus "
              f"requests in all four; cold reads {cold_p} (bf16) and {cold_f} (f32); the f32 pass launched "
              f"masked_stats {masked_f32} times")

        # (f) short-history admission and refinement, (g) micro-ticks
        admit = admission_arm(dev, t_now)
        for route in ("bf16-delta", "f32"):
            rec = admit[route]
            ticks = "; ".join(f"{what} {sec:.3f} s ({n} docs, book pending {st['pending']})"
                              for what, sec, n, st in rec["ticks"])
            print(f"phase 9: (f) {route}: {ADMIT_DOCS} newcomers pushed with 1-2 days of coverage into a pure-push "
                  f"ring (admission floor {ADMIT_FLOOR:.0f} s) in {rec['push_s'][0]:.3f} s; ticks on {smi}: {ticks}")
            print(f"phase 9: (f) {route}: refine book {rec['book']}, cold reads {rec['cold']}; the final fits equal a "
                  f"from-scratch fit on the same columns ({rec['scratch_s']:.3f} s) bit for bit ({rec['exact']} of "
                  f"{ADMIT_DOCS}, worst difference {rec['err']:.3g}), every doc's writes "
                  f"equal, exactly the spiked docs flagged; launches {rec['launches']}")
        micro = microtick_arm(dev, MICRO_DOCS, t_now, workdir)
        report_microtick_arm(micro, smi)

        # (b) timing
        print(f"phase 9 on {smi}:")
        for name, what in (("a", "cold"), ("b", "warm"), ("c", "spiked warm")):
            tick_lines(f"pull {what}", passes[name])
        for name, what in (("a", "cold"), ("b", "warm under paced remote-write"),
                           ("b_max", "warm under back-to-back remote-write"), ("c", "spiked warm, quiet"),
                           ("f32", "f32 cold")):
            tick_lines(f"push {what}", pushed[name])
        for what, (rt, parse, loop) in split.items():
            print(f"phase 9: (b) metric_fetch split, PrometheusSource.fetch of a {what} window "
                  f"({FULL_TH if what == 'history' else FULL_TC} points, mean of {FETCH_SPLIT_SAMPLE} fetches): "
                  f"HTTP round trip {rt:.3f} ms + json.loads {parse:.3f} ms + per-point loop {loop:.3f} ms = "
                  f"{rt + parse + loop:.3f} ms; RingSource.fetch of the same windows {ring_ms[what]:.4f} ms")

        # (c) packing before and after, on the card's host
        th = bucket_length(FULL_TH)
        ragged = [(t.hist_times, t.hist_values) for t in fit_tasks[:_FIT_CHUNK]]
        cuda = torch.device(dev).type == "cuda"
        before, after = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            a_b, d_b, l_b = pack_hist_before(ragged, th)
            t1 = time.perf_counter()
            pinned = d_b.pin_memory() if cuda else d_b
            t2 = time.perf_counter()
            before.append((t1 - t0, *pack_hist_before.split, t2 - t1))
            t0 = time.perf_counter()
            a_n, d_n, l_n = _pack_hist_bf16_host(ragged, th, pin=cuda)
            after.append((time.perf_counter() - t0,))
        check(d_n.is_pinned() or not cuda, "the native packing did not write into a pinned buffer")
        check(np.array_equal(a_b.view(np.uint32), a_n.view(np.uint32)) and np.array_equal(l_b, l_n)
              and torch.equal(pinned.view(torch.int16), d_n.view(torch.int16)),
              "the native bf16-delta packing differs from the numpy path (anchor, delta or lens)")
        med = lambda xs, i: statistics.median(x[i] for x in xs)  # noqa: E731
        print(f"phase 9: (c) one cold chunk of {len(ragged)} rows x L={th} ({sum(len(v) for _, v in ragged)} valid "
              f"points): before: host packing {med(before, 0):.4f} s = row copies into the f32 scratch "
              f"{med(before, 1):.4f} s + bf16 cast {med(before, 2):.4f} s, then pinned staging {med(before, 3):.4f} s; "
              f"after (native, into a pinned buffer): {med(after, 0):.4f} s, no staging copy (median of 3 each); "
              f"anchor, delta and lens bit-equal")
        ab = cold_tick_before_after(dev, fit_tasks, worker_fleet_args)
        for key, what in (("judge", f"phase 5 cold judge tick ({len(fit_tasks)} tasks)"),
                          ("worker", f"phase 6 cold worker tick ({len(worker_fleet_args[0])} docs)")):
            b_s, a_s = ab[key]["before"], ab[key]["after"]
            print(f"phase 9: (c) {what} on {smi}: before {', '.join(f'{x:.3f}' for x in b_s)} s, "
                  f"after {', '.join(f'{x:.3f}' for x in a_s)} s (order before, after, after, before)")

        # (d) the CLI, as the container runs it
        snap = os.path.join(workdir, "snap")
        es_d = FakeElasticsearch()
        es_srv_d, es_d, es_url_d = serve_fake_es(es_d)
        servers.append(es_srv_d)
        es_d.load(rdocs)
        prom.requests.clear()
        run1 = cli_run(es_url_d, snap, es_d, workdir, "first", dev)
        check(run1["written"] == ref["a"]["written"], "(d) the CLI worker's writes differ from (a)'s cold pass")
        hist1 = prom.requests["/hist"]
        es_d.set_status("preprocess_completed")
        prom.requests.clear()
        run2 = cli_run(es_url_d, snap, es_d, workdir, "restart", dev)
        ticks = [r for r in run2["records"] if r.get("msg") == "tick complete"]
        restored = [ln for ln in run2["lines"] if ln.startswith("restored fit state")]
        check(prom.requests["/hist"] == 0, f"(d) the restarted worker fetched {prom.requests['/hist']} histories")
        check(ticks and ticks[0]["fast_path"] == ticks[0]["docs"] == min(DEPLOY_CLAIM, len(rdocs)),
              f"(d) the restarted worker's first tick was not all warm: {ticks[:1]}")
        check(restored and f"'fits': {len(rdocs) * len(ALIASES)}," in restored[0],
              f"(d) the journals restored {restored}")
        check(run2["written"] == ref["a"]["written"], "(d) the restarted worker's writes differ from (a)'s")
        es_f = FakeElasticsearch()
        es_srv_f, es_f, es_url_f = serve_fake_es(es_f)
        servers.append(es_srv_f)
        es_f.load(rdocs[:DEPLOY_F32_DOCS])
        run3 = cli_run(es_url_f, os.path.join(workdir, "snap-f32"), es_f, workdir, "f32", dev,
                       {"FOREMAST_BF16_DELTA": "0"})
        stopped = [r for r in run3["records"] if r.get("msg") == "worker stopped"]
        launches = stopped[-1]["kernel_launches"] if stopped else {}
        check(launches.get("masked_stats", 0) > 0, f"(d) the f32 CLI run launched no masked_stats: {launches}")
        same_f32 = sum(run3["written"][k] == ref["a"]["written"][k] for k in run3["written"])
        # the CLI with the ingest plane: its index fills only once the
        # fleet's samples are resident in its ring
        ing_port = free_port()
        es_srv_i, es_i, es_url_i = serve_fake_es(FakeElasticsearch())
        servers.append(es_srv_i)
        env_i = {"FOREMAST_INGEST": "1", "FOREMAST_INGEST_PORT": str(ing_port),
                 "FOREMAST_INGEST_BUDGET_BYTES": str(PUSH_BUDGET_BYTES)}
        cli_push = {}

        def push_then_load():
            cli_push["push"] = push_frames(f"http://127.0.0.1:{ing_port}/api/v1/write", entries, wait=CLI_TIMEOUT)
            es_i.load(rdocs)

        snap_i = os.path.join(workdir, "snap-ingest")
        prom.requests.clear()
        # the index is empty until the push lands: the fit cache is sized
        # from the fleet (sized from the empty index, 64 entries, the cache
        # thrashed, every tick refitted, and a journal compaction kept only
        # the resident fits: the restart's cold docs of PR 14 run 4, PR 15
        # run 2 and PR 20 run 4)
        run4 = cli_run(es_url_i, snap_i, es_i, workdir, "ingest", dev, env_i, started=push_then_load,
                       fleet_docs=len(rdocs))
        asked4 = dict(prom.requests)
        check(run4["written"] == ref["a"]["written"], "(d) the ingest CLI's writes differ from (a)'s cold pass")
        check(not asked4, f"(d) the ingest CLI sent requests to Prometheus: {asked4}")
        es_i.set_status("preprocess_completed")
        prom.requests.clear()
        # the fit journal as the restart finds it: a cold doc of its first
        # tick writes its new fits through to the journal
        journal_copy = os.path.join(workdir, "journal-before-restart")
        os.makedirs(journal_copy)
        for name in os.listdir(snap_i):
            if name.startswith("fit-fits"):
                shutil.copy(os.path.join(snap_i, name), journal_copy)
        run5 = cli_run(es_url_i, snap_i, es_i, workdir, "ingest-restart", dev, env_i)
        asked5 = dict(prom.requests)
        ticks5 = [r for r in run5["records"] if r.get("msg") == "tick complete"]
        ring_restored = [ln for ln in run5["lines"] if ln.startswith("restored ring state")]
        check(not asked5, f"(d) the restarted ingest CLI sent requests to Prometheus: {asked5}")
        check(ring_restored and ring_restored[0].startswith(f"restored ring state {len(entries)} series"),
              f"(d) the ring restored {ring_restored}")
        if not (ticks5 and ticks5[0]["fast_path"] == ticks5[0]["docs"] == min(DEPLOY_CLAIM, len(rdocs))):
            report_journal_keys(journal_copy, rdocs, ticks5[:1])
        check(ticks5 and ticks5[0]["fast_path"] == ticks5[0]["docs"] == min(DEPLOY_CLAIM, len(rdocs)),
              f"(d) the restarted ingest CLI's first tick was not all warm: {ticks5[:1]}")
        check(run5["written"] == ref["a"]["written"], "(d) the restarted ingest CLI's writes differ from (a)'s")
        print(f"phase 9: (d) python3 -m foremast_tpu_torch worker (claim limit {DEPLOY_CLAIM}, poll 0.2 s, "
              f"FOREMAST_SNAPSHOT_DIR set): judged the {DEPLOY_DOCS} docs in {run1['seconds']:.1f} s from "
              f"start ({hist1} history fetches), writes equal (a)'s, SIGTERM exit 0; restarted on the same "
              f"directory ({restored[0]}): judged the reset fleet in {run2['seconds']:.1f} s with 0 history "
              f"fetches, first tick {ticks[0]['docs']} docs all on the fast path (0 cold fits), writes equal "
              f"(a)'s, exit 0; f32 run (FOREMAST_BF16_DELTA=0, fresh directory, {DEPLOY_F32_DOCS} docs) "
              f"judged in {run3['seconds']:.1f} s, launches {launches}, {same_f32} of {len(run3['written'])} "
              f"writes equal (a)'s, exit 0")
        p4_s, p4_n, _ = cli_push["push"]
        check(p4_n == n_samples, f"(d) the ingest CLI's receiver accepted {p4_n} of {n_samples} samples")
        print(f"phase 9: (d) with FOREMAST_INGEST=1: pushed {p4_n} samples to the CLI's receiver in {p4_s:.1f} s "
              f"({p4_n / p4_s:.0f} samples/s), judged the fleet in {run4['seconds']:.1f} s from start with 0 "
              f"Prometheus requests, writes equal (a)'s, SIGTERM exit 0; restarted on the same directory "
              f"({ring_restored[0]}): judged the reset fleet in {run5['seconds']:.1f} s, first tick "
              f"{ticks5[0]['docs']} docs all on the fast path, 0 Prometheus requests, writes equal (a)'s, exit 0")
        print(f"phase 9: launches of the in-process pull and push passes {launched_here}; of (f) "
              f"{admit['launches']}; of (g) {micro['launches']}; of the CLI's f32 run {launches}")
        return {k: launched_here[k] + admit["launches"][k] + micro["launches"][k] + int(launches.get(k, 0))
                for k in KERNEL_FILES}
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        # a later run in the same machine must not find this run's
        # snapshots and stream bodies (PERF.md §7)
        shutil.rmtree(workdir, ignore_errors=True)


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
    orig = worker._uni.judge_columnar
    worker._uni.judge_columnar = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
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
            counters=worker._uni.device_state_counters(),
            written={d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                     for d in store._docs.values()},
        )
    out["m"] = max(a.m for a in worker._uni._arenas.values())
    return out


def phase_seasonal_worker(dev) -> dict:
    """7(d): the worker's fleet tick over seasonal histories:
    ML_ALGORITHM=auto_univariate at the daily season over SEASONAL_DOCS
    docs, then holt_winters at m = HW_SEASON over HW_DOCS docs, cold and
    spiked-warm ticks; every doc's (status, code, reason, anomaly_info)
    and the arena counters equal a CPU worker's."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import STATUS_COMPLETED_UNHEALTH, STATUS_PREPROCESS_COMPLETED

    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"  # the monolithic tick
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



# ---------------------------------------------------------------------------
# phase 8: the joint detectors (bivariate, LSTM-AE + residual-MVN hybrid)
# ---------------------------------------------------------------------------

AE_TOL = 1e-5  # forward err: |kernel - plain| <= AE_TOL * |plain| + 1e-7
AE_GRAD_TOL = 1e-4  # gradients: |kernel - f64 plain| <= AE_GRAD_TOL * max |f64 plain| of the leaf
AE_ACT_TOL = 1e-5  # saved activations, absolute: gates and h lie in [-1, 1], c within a few units
AE_LEAF_NAMES = ("enc_w_x", "enc_w_h", "enc_b", "dec_w_x", "dec_w_h", "dec_b", "w_out", "b_out")


def ae_edge_inputs(rng, s: int, w: int, t_len: int, f: int, dev, cap: int | None = None):
    """Random stacked AE params (glorot-scaled, biases and output layer
    perturbed) for `cap` models (default s), windows x [s, w, T, F] and a
    mask mixing full, all-masked, single-step, ragged-tail and random
    windows."""
    import torch

    cap = s if cap is None else cap
    g = 128

    def u(*shape, scale):
        return torch.from_numpy(rng.uniform(-scale, scale, shape).astype(np.float32)).to(dev)

    leaves = [
        u(cap, f, g, scale=(6 / (f + g)) ** 0.5), u(cap, 32, g, scale=(6 / (32 + g)) ** 0.5), u(cap, g, scale=0.5),
        u(cap, f, g, scale=(6 / (f + g)) ** 0.5), u(cap, 32, g, scale=(6 / (32 + g)) ** 0.5), u(cap, g, scale=0.5),
        u(cap, 32, f, scale=(6 / (32 + f)) ** 0.5), u(cap, f, scale=0.5),
    ]
    x = torch.from_numpy(rng.normal(0.5, 0.5, (s, w, t_len, f)).astype(np.float32)).to(dev)
    mask = np.zeros((s, w, t_len), bool)
    for i in range(s):
        for j in range(w):
            kind = (i * w + j) % 5
            if kind == 0:
                mask[i, j] = True
            elif kind == 2:
                mask[i, j, rng.integers(t_len)] = True
            elif kind == 3:
                mask[i, j, : rng.integers(1, t_len + 1)] = True
            elif kind == 4:
                mask[i, j] = rng.random(t_len) < 0.7
    return leaves, x, torch.from_numpy(mask).to(dev)


def ae_close(got, want, what: str) -> float:
    import torch

    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    diff = (got.double() - want.double()).abs()
    ok = diff <= AE_TOL * want.double().abs() + 1e-7
    check(bool(ok.all()), f"{what}: max error {diff.max().item():.3e} over {AE_TOL} relative")
    return float(diff.max().item()) if diff.numel() else 0.0


def ae_grads_close(got, want, what: str) -> float:
    """Each leaf within AE_GRAD_TOL of the leaf's largest f64 gradient."""
    import torch

    worst = 0.0
    for name, g, w64 in zip(AE_LEAF_NAMES, got, want):
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name} gradient")
        scale = float(w64.abs().max()) if w64.numel() else 0.0
        err = float((g.double() - w64).abs().max()) if g.numel() else 0.0
        check(err <= AE_GRAD_TOL * scale + 1e-12, f"{what}: {name} gradient off by {err:.3e} (leaf max {scale:.3e})")
        worst = max(worst, err)
    return worst


def ae_shapes() -> list:
    """8(a)'s (S, W, T, F): PR 6's 54 (S in {1, 3, 37}, W in {1, 8}, T in
    {8, 32, 64}, F in {2, 3, 4}) and, for every other (W, T) of W in {1,
    3, 8, 32} and T in {1, 8, 32, 33, 64}, one F a shape, cycling through
    {1, 4, 8}. S in {1, 3, 37} leaves the last block of a W=1 launch (4
    pairs a block) part empty."""
    shapes, n = [], 0
    for s in (1, 3, 37):
        for w in (1, 3, 8, 32):
            for t_len in (1, 8, 32, 33, 64):
                if w in (1, 8) and t_len in (8, 32, 64):
                    shapes += [(s, w, t_len, f) for f in (2, 3, 4)]
                else:
                    shapes.append((s, w, t_len, (1, 4, 8)[n % 3]))
                    n += 1
    return shapes


def phase_lstm_kernels_vs_plain(dev) -> dict:
    """8(a): lstm_ae_forward and lstm_ae_backward against their plain
    versions on the same CUDA tensors at `ae_shapes()` (96 shapes; full,
    all-masked, single-step, ragged-tail and random windows). The forward:
    err within 1e-5 relative of the f32 plain loop, also through a `rows`
    gather with repeated rows from a larger stack (at W=1 once more with
    every model on one row); its saved activations within AE_ACT_TOL of
    `_lstm_ae_act_plain`; two calls give the same bits of err and act.
    The backward, where it takes the shape (W <= 8), on that act:
    gradients (upstream 1/n_s, the loss's) within 1e-4 of each leaf's
    largest gradient from float64 autograd of the plain loop; two calls
    give the same bits."""
    import torch

    from foremast_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(81)
    worst_f = worst_a = worst_b = 0.0
    cases = bwd_cases = 0
    for s, w, t_len, f in ae_shapes():
        what = f"lstm_ae S={s} W={w} T={t_len} F={f}"
        leaves, x, mask = ae_edge_inputs(rng, s, w, t_len, f, dev)
        err, act = K.lstm_ae_forward(leaves, x, mask, save_act=True)
        err2, act2 = K.lstm_ae_forward(leaves, x, mask, save_act=True)
        check(torch.equal(err.view(torch.int32), err2.view(torch.int32))
              and torch.equal(act.view(torch.int32), act2.view(torch.int32)),
              f"{what}: two forward calls gave different bits")
        worst_f = max(worst_f, ae_close(err, K._lstm_ae_forward_plain(leaves, x, mask), what))
        a_diff = float((act.double() - K._lstm_ae_act_plain(leaves, x, mask).double()).abs().max())
        check(bool(torch.isfinite(act).all()) and a_diff <= AE_ACT_TOL,
              f"{what}: saved activations off the plain ones by {a_diff:.3e}")
        worst_a = max(worst_a, a_diff)
        # the arena gather: a larger stack, repeated rows
        cap = s + 5
        stack, _, _ = ae_edge_inputs(rng, s, w, t_len, f, dev, cap=cap)
        row_sets = [torch.from_numpy(rng.integers(0, cap, s)).to(dev)]
        if s > 1:
            row_sets[0][1] = row_sets[0][0]
        if w == 1:
            row_sets.append(torch.full((s,), cap - 1, dtype=torch.int64, device=dev))
        for rows in row_sets:
            got_r, _ = K.lstm_ae_forward(stack, x, mask, rows=rows)
            worst_f = max(worst_f, ae_close(got_r, K._lstm_ae_forward_plain(stack, x, mask, rows), what + " rows"))
        cases += 1
        if w > K._AE_MAX_W_BWD:
            continue
        n = mask.sum(dim=(1, 2)).float().clamp_min(1.0)
        grad_err = (1.0 / n)[:, None, None].expand(s, w, t_len).contiguous()
        got_g = K.lstm_ae_backward(leaves, x, mask, act, grad_err)
        again = K.lstm_ae_backward(leaves, x, mask, act, grad_err)
        for name, a, b in zip(AE_LEAF_NAMES, got_g, again):
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"{what}: two backward calls gave different {name} bits")
        want_g = K._lstm_ae_backward_plain(
            [leaf.double() for leaf in leaves], x.double(), mask, grad_err.double()
        )
        worst_b = max(worst_b, ae_grads_close(got_g, want_g, what))
        bwd_cases += 1
    torch.cuda.synchronize()
    print(f"phase 8: (a) lstm_ae_forward equals its plain version at {cases} shapes (with rows gathers, repeated "
          f"rows): err max diff {worst_f:.3e}, saved activations max diff {worst_a:.3e} (tolerance "
          f"{AE_ACT_TOL:g}), two calls the same bits; lstm_ae_backward on that act at the {bwd_cases} shapes "
          f"with W <= {K._AE_MAX_W_BWD}: gradients max diff {worst_b:.3e}, two calls the same bits")
    return {"lstm_ae_forward": worst_f, "lstm_ae_backward": worst_b}


JOINT_PERIOD = 24  # the quality scenarios' synthetic cycle (benchmarks/quality.py PERIOD)
JOINT_TH = 1008  # quality.main's full-size history: 42 cycles
JOINT_GROUP = 512  # 8(b): one cold LSTM group, the joint fleet's LSTM half
JOINT_QUALITY_B = 256  # 8(c): jobs per scenario
JOINT_DOCS = 1024  # 8(d): alternating 2-alias bivariate and 4-alias LSTM docs
JOINT_CPU_DOCS = 64  # 8(d): docs held to a CPU worker
LSTM_STEPS = 60  # FOREMAST_LSTM_STEPS' default


def draw_comoving(rng, b: int, f: int, n: int, t_start: int, period: int = JOINT_PERIOD):
    """[B, F, n] co-moving seasonal metrics: a shared latent (sine + noise)
    plus per-metric offset and idiosyncratic noise (a copy of
    benchmarks/quality.py's generator)."""
    t = (t_start + np.arange(n))[None, :]
    latent = 0.3 * np.sin(2 * np.pi * t / period) + rng.normal(0, 0.05, (b, n))
    return np.stack(
        [1.0 + 0.5 * j + latent + rng.normal(0, 0.05, (b, n)) for j in range(f)], axis=1
    ).astype(np.float32)


def gen_correlated_pair(b: int, th: int, tc: int, seed: int = 0):
    """2 tightly-correlated metrics; anomalies are off-ridge points whose
    marginals stay in range (a copy of benchmarks/quality.py's)."""
    rng = np.random.default_rng(seed)
    rho = 0.95

    def draw(n):
        x = rng.normal(0, 1, (b, n))
        y = rho * x + np.sqrt(1 - rho * rho) * rng.normal(0, 1, (b, n))
        return 1.0 + 0.2 * x, 2.0 + 0.3 * y

    hx, hy = draw(th)
    cx, cy = draw(tc)
    truth = np.zeros((b, tc), bool)
    for i in range(b):
        idx = rng.choice(tc, size=2, replace=False)
        cx[i, idx] += 2.5 * 0.2
        cy[i, idx] -= 2.5 * 0.3
        truth[i, idx] = True
    return np.stack([hx, hy], axis=1).astype(np.float32), np.stack([cx, cy], axis=1).astype(np.float32), truth


def gen_joint_lstm(b: int, f: int, th: int, tc: int, seed: int = 0, kind="all"):
    """f co-moving seasonal metrics; "all": simultaneous all-metric spikes
    (+0.6) at random points, troughs included; "break": one metric off
    the pack by +/-0.6 (a copy of benchmarks/quality.py's)."""
    rng = np.random.default_rng(seed)
    hist = draw_comoving(rng, b, f, th, 0)
    cur = draw_comoving(rng, b, f, tc, th)
    truth = np.zeros((b, tc), bool)
    for i in range(b):
        idx = rng.choice(tc, size=2, replace=False)
        if kind == "all":
            cur[i, :, idx] += 0.6
        else:
            for pos in idx:
                j = rng.integers(0, f)
                cur[i, j, pos] += rng.choice([-1.0, 1.0]) * 0.6
        truth[i, idx] = True
    return hist.astype(np.float32), cur.astype(np.float32), truth


def joint_tasks(hist, cur, prefix: str, t0: int = 1_700_000_000):
    """[B, F, Th] histories + [B, F, Tc] windows -> the port's MetricTasks
    (aliases m0..m{F-1}, one app per job, 60 s steps)."""
    from foremast_tpu_torch.engine.judge import MetricTask

    b, f, th = hist.shape
    tc = cur.shape[-1]
    ht = t0 + 60 * np.arange(th, dtype=np.int64)
    ct = t0 + 60 * (th + np.arange(tc, dtype=np.int64))
    return [
        MetricTask(job_id=f"{prefix}{i}", alias=f"m{j}", metric_type=None, hist_times=ht, hist_values=hist[i, j],
                   cur_times=ct, cur_values=cur[i, j], app=f"{prefix}{i}")
        for i in range(b) for j in range(f)
    ], ct


def joint_cfg(algorithm: str, season: int = JOINT_PERIOD, **kw):
    """The joint detectors at the quality scenarios' calibration: base
    threshold 4.0, no per-type rules."""
    import dataclasses

    from foremast_tpu_torch.config import BrainConfig

    cfg = BrainConfig(algorithm=algorithm, season_steps=season, **kw)
    return dataclasses.replace(cfg, anomaly=dataclasses.replace(cfg.anomaly, threshold=4.0, rules=()))


def lstm_windows(hist, tc: int, n_win: int = 8):
    """The judge's training windows: each job's newest n_win tc-length
    history windows, newest first -> x [S, n_win, tc, F]."""
    b, f, th = hist.shape
    usable = (th // tc) * tc
    chunks = hist[:, :, th - usable:].reshape(b, f, -1, tc)
    return np.ascontiguousarray(chunks[:, :, ::-1][:, :, :n_win].transpose(0, 2, 3, 1))


def near_cutoff(judge, tasks, tc: int) -> np.ndarray:
    """[jobs, tc] points of one LSTM group whose AE error or robust d^2
    lies within EDGE (relative) of a cutoff, from `judge`'s own evidence
    (`_lstm_scores`) over its cached entries."""
    from foremast_tpu_torch.engine.judge import infer_step

    by_job: dict = {}
    for t in tasks:
        by_job.setdefault(t.job_id, []).append(t)
    joints = [judge._joint(v) for v in by_job.values()]
    ordered = [judge.cache.peek(judge._key(j, tc)) for j in joints]
    steps = [infer_step(j.hist_t) for j in joints]
    thr = np.full(len(joints), judge.config.anomaly.rule_for(None).threshold, np.float32)
    f = joints[0].hist_v.shape[0]
    sc = judge._lstm_scores(joints, ordered, steps, f, tc, thr)

    def near(a, c):
        return np.abs(a - c) <= EDGE * np.abs(c)

    return sc["valid"] & (near(sc["err"], sc["cut"][:, None]) | near(sc["d2"], sc["cutoff"][:, None])
                          | near(sc["d2"], sc["hi_cutoff"][:, None]))


def verdict_map(verdicts) -> dict:
    return {(v.job_id, v.alias): (v.verdict, tuple(v.anomaly_pairs)) for v in verdicts}


def phase_lstm_group(dev) -> dict:
    """8(b), the main path: one cold LSTM group at the joint fleet's full
    width through MultivariateJudge.judge on the card — 512 jobs of 4
    co-moving metrics (all-metric spikes in their windows), 1,008-point
    histories, Tc=30 (bucket 32): 512 models of H=32 trained 60 steps on
    8 windows each (lstm_ae_forward / lstm_ae_backward), the residual
    MVN fitted (holt_winters_scan per series), every job scored. The
    trained entries carried to a CPU MultivariateJudge give the same
    verdicts and anomaly pairs; a job may differ only where a point lies
    within EDGE of a cutoff (counted)."""
    import torch

    from foremast_tpu_torch.engine.multivariate import MultivariateJudge

    hist, cur, _ = gen_joint_lstm(JOINT_GROUP, 4, JOINT_TH, FULL_TC, seed=21)
    tasks, _ = joint_tasks(hist, cur, "g")
    cfg = joint_cfg("lstm_autoencoder", max_cache_size=2 * JOINT_GROUP)
    judge = MultivariateJudge(cfg, device=dev)
    check(judge.lstm_steps == LSTM_STEPS, f"FOREMAST_LSTM_STEPS is set ({judge.lstm_steps} steps)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = judge.judge(tasks)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cpu = MultivariateJudge(cfg, device="cpu")

    def no_training(*_):
        check(False, "8(b) the CPU judge missed a carried entry and would train")

    cpu._train = no_training
    for key, entry in judge.cache.snapshot().items():
        cpu.cache.put(key, entry)
    t0 = time.perf_counter()
    want = cpu.judge(tasks)
    cpu_s = time.perf_counter() - t0
    g, w = verdict_map(got), verdict_map(want)
    check(g.keys() == w.keys(), "8(b) the card and the CPU judged different windows")
    near = near_cutoff(cpu, tasks, bucket_of(FULL_TC))
    near_jobs = {f"g{i}" for i in np.nonzero(near.any(axis=1))[0]}
    differ = {k[0] for k in g if g[k] != w[k]}
    check(differ <= near_jobs, f"8(b) {len(differ - near_jobs)} jobs differ from the CPU judge away from any cutoff")
    unhealthy = sum(v[0] == 1 for v in g.values()) // 4
    print(f"phase 8: (b) one cold LSTM group, {JOINT_GROUP} jobs x 4 metrics (Th={JOINT_TH}, Tc={FULL_TC}): "
          f"{cold_s:.3f} s on the card (train {LSTM_STEPS} steps, MVN fit, score); the carried entries on a CPU "
          f"judge ({cpu_s:.3f} s) give the same verdicts and pairs on {JOINT_GROUP - len(differ)} of {JOINT_GROUP} "
          f"jobs; {int(near.sum())} points lie within {EDGE} of a cutoff, {len(differ)} jobs differ there; "
          f"{unhealthy} jobs unhealthy (every window carries spikes)")
    return {"hist": hist, "cold_s": cold_s}


def bucket_of(n: int) -> int:
    from foremast_tpu_torch.engine.judge import bucket_length

    return bucket_length(n)


def time_lstm_kernels(dev, hist, peak_bytes: float, sm_clock_hz: float) -> dict:
    """8(b), timed: fit_many at the group's shape (S=512, W=8, T=32, F=4,
    H=32, 60 steps) with its loss curve, which must fall at each of its
    first 10 steps (the mean over models); then the two kernels on the
    trained parameters — the training forward (activations saved), its
    backward, and the warm path's scoring forward (W=1, a rows gather) —
    each held to its plain version at full size and timed (device time,
    the calls queued behind a busy kernel) beside its bound (bytes over
    the memory rate, f32 operations over the f32 peak)
    and the floor of its dependent chain (2T steps of FMA latency);
    cuDNN's unmasked nn.LSTM encoder + decoder forward of the same shapes
    is timed as another function (one weight set for every window, no
    masked steps)."""
    import torch

    from foremast_tpu_torch.models import lstm_ae as ae
    from foremast_tpu_torch.ops import kernels as K

    s_n, w_n, t_len, f, h = JOINT_GROUP, 8, bucket_of(FULL_TC), 4, 32
    x = torch.from_numpy(lstm_windows(hist, t_len, w_n)).to(dev)
    mask = torch.ones((s_n, w_n, t_len), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, _, losses = ae.fit_many(torch.Generator().manual_seed(0), x, mask, ae.LSTMAEConfig(features=f),
                                       steps=LSTM_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    curve = losses.mean(dim=1).cpu().numpy()
    print("phase 8: (b) fit_many loss, mean over the 512 models, steps 0-10: "
          + " ".join(f"{v:.5f}" for v in curve[:11]) + "; steps 20, 40, 59: "
          + " ".join(f"{curve[k]:.5f}" for k in (20, 40, LSTM_STEPS - 1)))
    check(bool((np.diff(curve[:11]) < 0).all()), "8(b) the loss did not fall at each of its first 10 steps")
    leaves = ae.leaves(params)
    n = mask.sum(dim=(1, 2)).float().clamp_min(1.0)
    grad_err = (1.0 / n)[:, None, None].expand(s_n, w_n, t_len).contiguous()
    err, act = K.lstm_ae_forward(leaves, x, mask, save_act=True)
    rows = torch.arange(s_n, device=dev).flip(0)
    xs, ms = x[:, :1].contiguous(), mask[:, :1].contiguous()

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    want_f, plain_f = events(lambda: K._lstm_ae_forward_plain(leaves, x, mask))
    err_f = ae_close(err, want_f, "8(b) training forward at full size")
    want_b, plain_b = events(lambda: K._lstm_ae_backward_plain(leaves, x, mask, grad_err))
    err_b = ae_grads_close(K.lstm_ae_backward(leaves, x, mask, act, grad_err), want_b, "8(b) backward at full size")
    want_s, plain_s = events(lambda: K._lstm_ae_forward_plain(leaves, xs, ms, rows))
    err_s = ae_close(K.lstm_ae_forward(leaves, xs, ms, rows=rows)[0], want_s, "8(b) scoring forward at full size")
    del want_f, want_b, want_s
    fwd_ms = queued_ms(lambda: K.lstm_ae_forward(leaves, x, mask, save_act=True), iters=10)
    bwd_ms = queued_ms(lambda: K.lstm_ae_backward(leaves, x, mask, act, grad_err), iters=10)
    score_ms = queued_ms(lambda: K.lstm_ae_forward(leaves, xs, ms, rows=rows), iters=20)
    score_host_ms = cuda_ms(lambda: K.lstm_ae_forward(leaves, xs, ms, rows=rows), iters=10, repeats=5)
    split = time_backward_parts(leaves, x, mask, act, grad_err, bwd_ms, peak_bytes)
    step_ms = cuda_ms(lambda: ae.train_step_many(params, ae.adam_init(params), x, mask,
                                                 ae.LSTMAEConfig(features=f)), iters=3, repeats=3)
    torch.backends.cudnn.allow_tf32 = False  # the reference in f32, as the kernels compute
    enc = torch.nn.LSTM(f, h, batch_first=True).to(dev)
    dec = torch.nn.LSTM(f, h, batch_first=True).to(dev)
    out_layer = torch.nn.Linear(h, f).to(dev)
    xf = x.reshape(s_n * w_n, t_len, f)
    zeros = torch.zeros_like(xf)

    def cudnn():
        with torch.no_grad():
            _, state = enc(xf)
            y, _ = dec(zeros, state)
            return out_layer(y)

    cudnn_ms = cuda_ms(cudnn, iters=5, repeats=5)
    g = 4 * h
    param_bytes = s_n * 4 * (f * g + h * g + g + h * g + g + h * f + f)
    win_steps = s_n * w_n * t_len
    fwd_flops = win_steps * (2 * g * (f + h) + 2 * g * h + 2 * h * f)
    act_bytes = s_n * w_n * 2 * t_len * 6 * h * 4
    rows_out = {
        "lstm_ae_forward": (fwd_ms, plain_f, param_bytes + win_steps * (4 * f + 1 + 4) + act_bytes, fwd_flops,
                            2 * t_len * 4 * (h + f), err_f),
        "lstm_ae_backward": (bwd_ms, plain_b, param_bytes // 2 + win_steps * (4 * f + 1 + 4) + act_bytes
                             + param_bytes, 2 * fwd_flops, 2 * t_len * 4 * g, err_b),
        "lstm_ae_forward scoring (W=1, rows)": (score_ms, plain_s, param_bytes + s_n * t_len * (4 * f + 1 + 4),
                                                fwd_flops // w_n, 2 * t_len * 4 * (h + f), err_s),
    }
    timings = {}
    for name, (ms, plain_ms, nbytes, flops, chain_cycles, full_err) in rows_out.items():
        bytes_ms = nbytes / peak_bytes * 1e3
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        chain_ms = chain_cycles / sm_clock_hz * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms), library_ms=None,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations", chain_ms=chain_ms,
                             full_err=full_err)
        print(f"phase 8: {name} S={s_n} W={w_n if 'scoring' not in name else 1} T={t_len} F={f} H={h}: "
              f"kernel_ms={ms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f} (share {max(bytes_ms, ops_ms) / ms:.1%}; "
              f"{nbytes / 1e6:.1f} MB at "
              f"{peak_bytes / 1e12:.2f} TB/s = {bytes_ms:.4f} ms; {flops / 1e9:.3f} GFLOP at "
              f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = {ops_ms:.4f} ms); chain floor {chain_ms:.4f} ms "
              f"({chain_cycles} cycles at {sm_clock_hz / 1e9:.2f} GHz); plain_ms={plain_ms:.2f} (one call, "
              f"within tolerance); library_ms=none")
    print(f"phase 8: (b) fit_many ({LSTM_STEPS} steps, S={s_n}): {fit_s:.3f} s = {fit_s / LSTM_STEPS * 1e3:.2f} ms "
          f"a step; one train_step_many (forward + backward kernels, Adam on 8 leaves) {step_ms:.3f} ms; "
          f"another function: cuDNN nn.LSTM encoder + decoder forward, unmasked, one weight set, same shapes "
          f"{cudnn_ms:.4f} ms (torch.backends.cudnn.allow_tf32 = False)")
    print(f"phase 8: (b) kernel_ms above is device time, the calls queued behind a busy kernel; the scoring "
          f"forward at the host's pace (one wrapper call after another): {score_host_ms:.4f} ms a call")
    for line in ptxas_report("lstm_ae_forward"):
        print(f"phase 8: (b) lstm_ae_forward ptxas {line}")
    timings["lstm_ae_forward"]["score"] = timings["lstm_ae_forward scoring (W=1, rows)"]
    timings["lstm_ae_backward"].update(split)
    return timings


def ptxas_report(kname: str) -> list[str]:
    """Each entry function of kernel library `kname` with its ptxas
    registers, shared memory and spill, from the build's log."""
    from foremast_tpu_torch.ops import _build

    out, fn = [], None
    for line in _build.build_log(kname).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            # the name inside the mangled one, with its bool template arguments
            short = re.search(r"([A-Za-z_]+_kernel)(I((?:Lb[01]E)+)E)?", fn)
            if short:
                flags = re.findall(r"Lb([01])E", short.group(3) or "")
                fn = short.group(1) + (f"<{','.join(flags)}>" if flags else "")
        elif fn and ("spill" in line or "registers" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def time_backward_parts(leaves, x, mask, act, grad_err, total_ms: float, peak_bytes: float) -> dict:
    """8(b): lstm_ae_backward's two launches timed apart at the group's
    shape (the chain, then the products on the chain's scratch), each
    beside the bytes and f32 operations it needs; cuBLAS's torch.bmm of
    the same dW_h products h_prev^T dA ([2S, H, W*T] x [2S, W*T, 4H],
    TF32 off) timed as the product half's yardstick and held to the
    kernel's dW_h; all three as `queued_ms` device time, as the whole
    backward; both kernels' ptxas registers and spill."""
    import torch

    from foremast_tpu_torch.ops import kernels as K

    check(not torch.backends.cuda.matmul.allow_tf32, "8(b) the bmm yardstick must run in full f32")
    grads, scratch = K._lstm_ae_backward_cuda(leaves, x, mask, act, grad_err)
    chain_ms = queued_ms(lambda: K._lstm_ae_backward_cuda(leaves, x, mask, act, grad_err, scratch, parts=1),
                         iters=10)
    prod_ms = queued_ms(lambda: K._lstm_ae_backward_cuda(leaves, x, mask, act, grad_err, scratch, parts=2),
                        iters=10)
    s_n, w_n, t_len, f = x.shape
    h = 32
    hs = act[..., 5 * h:]  # [S, W, 2T, H]
    h_prev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)  # row u's state before it
    a = h_prev.reshape(s_n, w_n, 2, t_len, h).permute(0, 2, 4, 1, 3).reshape(2 * s_n, h, w_n * t_len).contiguous()
    d_gates = scratch[0].reshape(s_n, w_n, 2, t_len, h, 4).transpose(-1, -2)  # unit-major rows -> [4, H]
    b = d_gates.permute(0, 2, 1, 3, 4, 5).reshape(2 * s_n, w_n * t_len, 4 * h).contiguous()
    dwh = torch.bmm(a, b).reshape(s_n, 2, h, 4 * h)
    for cell, got in ((0, grads[1]), (1, grads[4])):
        scale = float(got.abs().max())
        err = float((dwh[:, cell] - got).abs().max())
        check(err <= AE_GRAD_TOL * scale, f"8(b) bmm dW_h of cell {cell} off the kernel's by {err:.3e}")
    bmm_ms = queued_ms(lambda: torch.bmm(a, b), iters=10)
    pairs = s_n * w_n * t_len
    g = 4 * h
    chain_bytes = pairs * 2 * (6 * h * 4 + g * 4) + pairs * (f * 4 * 2 + 1 + 4) + s_n * 4 * (2 * h * g + h * f + f)
    prod_bytes = pairs * 2 * (g * 4 + h * 4) + pairs * f * 4 * 2 + s_n * 4 * (2 * h * g + f * g + 2 * g + h * f + f)
    chain_flops = pairs * 2 * (2 * g * h + 12 * h) + pairs * 4 * h * f
    prod_flops = pairs * 2 * g * (2 * h + f + 2) + pairs * 2 * (h + 1) * f
    bmm_flops = pairs * 2 * 2 * g * h
    rows = []
    for name, ms, nbytes, flops in (("chain", chain_ms, chain_bytes, chain_flops),
                                    ("products", prod_ms, prod_bytes, prod_flops)):
        bound = max(nbytes / peak_bytes, flops / PEAK_F32_FLOPS) * 1e3
        rows.append(f"{name} {ms:.4f} ms (bound {bound:.4f}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    print(f"phase 8: (b) lstm_ae_backward S={s_n} W={w_n} T={t_len} F={f} H={h} launched apart: "
          + "; ".join(rows) + f"; sum {chain_ms + prod_ms:.4f} ms, both in one call {total_ms:.4f} ms; "
          f"yardstick of the product half: torch.bmm of the dW_h products [{2 * s_n}, {h}, {w_n * t_len}] x "
          f"[{2 * s_n}, {w_n * t_len}, {g}] (allow_tf32 False) {bmm_ms:.4f} ms ({bmm_flops / 1e9:.3f} GFLOP)")
    for line in ptxas_report("lstm_ae_backward"):
        print(f"phase 8: (b) lstm_ae_backward ptxas {line}")
    return {"chain_ms": chain_ms, "products_ms": prod_ms, "bmm_ms": bmm_ms}


def quality_prf(judge, hist, cur, truth, prefix: str):
    """Point-level (precision, recall, F1) of one scenario through the
    judge, as benchmarks/quality.py's score_joint counts them."""
    tasks, ct = joint_tasks(hist, cur, prefix)
    flagged: dict = {}
    for v in judge.judge(tasks):
        flagged.setdefault(v.job_id, set()).update(v.anomaly_pairs[0::2])
    tp = fp = fn = 0
    for i in range(hist.shape[0]):
        got = flagged.get(f"{prefix}{i}", set())
        want = {float(t) for t, a in zip(ct, truth[i]) if a}
        tp += len(got & want)
        fp += len(got - want)
        fn += len(want - got)
    p = tp / (tp + fp) if tp + fp else 1.0
    r = tp / (tp + fn) if tp + fn else 1.0
    return p, r, (2 * p * r / (p + r) if p + r else 0.0)


def phase_joint_quality(dev) -> None:
    """8(c): tests/test_benchmarks.py's joint gates on the card, the port's
    own training, 256 jobs a scenario (th=1,008, Tc=30, period 24,
    threshold 4.0): bivariate F1 >= 0.9; the LSTM hybrid's precision >=
    0.95 and recall >= 0.98 on all-metric spikes and correlation breaks;
    no clean job flagged."""
    from foremast_tpu_torch.engine.multivariate import MultivariateJudge

    b = JOINT_QUALITY_B
    t0 = time.perf_counter()
    hist, cur, truth = gen_correlated_pair(b, JOINT_TH, FULL_TC)
    p, r, f1 = quality_prf(MultivariateJudge(joint_cfg("bivariate_normal"), device=dev), hist, cur, truth, "bi")
    check(f1 >= 0.9, f"8(c) joint-bivariate F1 {f1:.3f} < 0.9")
    line = [f"bivariate P/R/F1 {p:.3f}/{r:.3f}/{f1:.3f}"]
    for kind in ("all", "break"):
        hist, cur, truth = gen_joint_lstm(b, 4, JOINT_TH, FULL_TC, kind=kind)
        p, r, f1 = quality_prf(MultivariateJudge(joint_cfg("lstm_autoencoder"), device=dev), hist, cur, truth, kind)
        check(p >= 0.95 and r >= 0.98, f"8(c) joint-lstm-{kind}: precision {p:.3f}, recall {r:.3f}")
        line.append(f"lstm-{kind} {p:.3f}/{r:.3f}/{f1:.3f}")
    rng = np.random.default_rng(7)
    hist, cur = draw_comoving(rng, b, 4, JOINT_TH, 0), draw_comoving(rng, b, 4, FULL_TC, JOINT_TH)
    tasks, _ = joint_tasks(hist, cur, "clean")
    bad = {v.job_id for v in MultivariateJudge(joint_cfg("lstm_autoencoder"), device=dev).judge(tasks) if v.verdict == 1}
    check(not bad, f"8(c) {len(bad)} clean joint jobs flagged")
    print(f"phase 8: (c) quality gates on the card, {b} jobs a scenario: " + "; ".join(line)
          + f"; clean windows: 0 of {b} jobs flagged ({time.perf_counter() - t0:.1f} s)")


def joint_worker_fleet(n_docs: int, t_now: int, seed: int = 17):
    """benchmarks/worker_bench.py's joint fleet (`_add_joint_service`):
    alternating 2-alias bivariate and 4-alias LSTM docs of co-moving
    metrics (period 24), 7-day settled histories (Th=10,080), 30-point
    clean windows continuing the latent, endTime an hour out. Returns
    (documents as JSON, URL -> series)."""
    from foremast_tpu_torch.jobs import Document

    rng = np.random.default_rng(seed)
    ht = t_now - 86_400 * 7 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(FULL_TC, dtype=np.int64)
    end_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_now + 3600))
    data, docs = {}, []
    for i in range(n_docs):
        f = 2 if i % 2 == 0 else 4
        r = np.random.default_rng(int(rng.integers(0, 2**31)))
        hist = draw_comoving(r, 1, f, FULL_TH, 0)[0]
        cur = draw_comoving(r, 1, f, FULL_TC, FULL_TH)[0]
        cur_parts, hist_parts = [], []
        for m in range(f):
            cur_url = f"http://prom/cur?q=m{m}:app{i}&step=60"
            hist_url = f"http://prom/hist?q=m{m}:app{i}&end={int(ht[-1]) + 60}&step=60"
            data[cur_url] = (ct, cur[m])
            data[hist_url] = (ht, hist[m])
            cur_parts.append(f"m{m}== {cur_url}")
            hist_parts.append(f"m{m}== {hist_url}")
        docs.append(Document(id=f"job-{i}", app_name=f"app{i}", end_time=end_time,
                             current_config=" ||".join(cur_parts), historical_config=" ||".join(hist_parts),
                             strategy="continuous").to_json())
    return docs, data


def phase_joint_worker(dev, smi: str) -> dict:
    """8(d): the worker's joint fleet tick on the card — 1,024 docs under
    `auto` (512 bivariate, 512 LSTM-hybrid of 4 metrics), Th=10,080,
    Tc=30, the default daily season m=1440 (the residual MVN fits at
    m=1440), threshold 4.0: (a) cold tick (512 models trained, MVN and
    bivariate fits), (b) warm tick (every doc on the joint columnar path,
    0 trainings, 0 MVN fits), (c) warm tick with the last 3 points of
    every 16th doc of each kind spiked (LSTM docs: every metric +0.6;
    bivariate docs off-ridge, +/-0.6), which must flag exactly those docs
    (a clean doc the cold tick flagged — a false alarm of the detectors
    at threshold 4 — has completed and is counted), (e) the joint
    columnar dispatch of (b) again, under
    torch.cuda.set_sync_debug_mode("error") behind a busy kernel. A CPU
    worker over the first 64 docs and every doc flagged cold, with the
    card's trained LSTM entries carried into its cache, writes the same
    (status, code, reason, anomaly_info) after each tick, and both
    arenas count the same per doc."""
    import torch

    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.ops import kernels as K

    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
    t_now = int(time.time())
    t0 = time.perf_counter()
    docs, data = joint_worker_fleet(JOINT_DOCS, t_now)
    n_win = (JOINT_DOCS // 2) * (2 + 4)
    print(f"phase 8: (d) joint fleet of {JOINT_DOCS} docs ({JOINT_DOCS // 2} bivariate, {JOINT_DOCS // 2} LSTM x 4 "
          f"metrics = {n_win} windows, Th={FULL_TH}, Tc={FULL_TC}, m={SEASON}) built in {time.perf_counter() - t0:.1f} s")

    def new_worker(doc_json, device, tracer=None):
        return joint_worker(doc_json, data, device, tracer)

    def written(store):
        return {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                for d in store._docs.values()}

    tracer = Tracer()
    gw, gstore = new_worker(docs, dev, tracer)
    gw.warmup()
    cpu = {}  # the CPU worker, built after the card's cold tick
    calls = []
    orig = gw._mvj.joint_columnar
    gw._mvj.joint_columnar = lambda *a: calls.append(a) or orig(*a)
    out = {}

    def tick(name, now):
        calls.clear()
        launches = dict(K.LAUNCHES)
        versions = (gw._mvj.cache.version, gw._mvj.joint_meta.version)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = gw.tick(now=now)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        if name == "a":
            # the CPU worker: the first 64 docs and every doc the card
            # flagged cold, scoring the card's trained models
            flagged = [i for i in range(JOINT_DOCS) if i >= JOINT_CPU_DOCS
                       and json.loads(written(gstore)[f"job-{i}"])[0] == "completed_unhealth"]
            cpu["ids"] = list(range(JOINT_CPU_DOCS)) + flagged
            cpu["worker"], cpu["store"] = new_worker([docs[i] for i in cpu["ids"]], "cpu")
            apps = {f"app{i}" for i in cpu["ids"]}
            for key, entry in gw._mvj.cache.snapshot().items():
                if key[0] == "lstm" and key[1] in apps:
                    cpu["worker"]._mvj.cache.put(key, entry)
        cw, cstore = cpu["worker"], cpu["store"]
        t1 = time.perf_counter()
        cn = cw.tick(now=now)
        out[name] = dict(
            seconds=seconds, cpu_seconds=time.perf_counter() - t1, docs=n, cpu_docs=cn, written=written(gstore),
            cpu_written=written(cstore), counters=gw._mvj.joint_state_counters(),
            cpu_counters=cw._mvj.joint_state_counters(), fast=dict(gw._fast_kinds),
            launched={k: K.LAUNCHES[k] - v for k, v in launches.items()},
            refit=(gw._mvj.cache.version, gw._mvj.joint_meta.version) != versions,
            stages=dict(tracer.last_stage_seconds), calls=list(calls),
        )

    tick("a", t_now + 150)
    tick("b", t_now + 200)
    spiked = sorted([i for i in range(JOINT_DOCS) if i % 16 in (5, 12)])
    for w in (gw, cpu["worker"]):
        for i in spiked:
            f = 4 if i % 2 else 2
            for m in range(f):
                url = f"http://prom/cur?q=m{m}:app{i}&step=60"
                ct, cv = w.source.data[url]
                v = cv.copy()
                v[-3:] += 0.6 if (f == 4 or m == 0) else -0.6
                w.source.data[url] = (ct, v)
    tick("c", t_now + 250)

    a, b, c = out["a"], out["b"], out["c"]
    def unhealthy(t):
        return {int(k[4:]) for k, v in t["written"].items() if json.loads(v)[0] == "completed_unhealth"}

    # clean windows at threshold 4 can still cross it: the cold tick's
    # flags are false alarms of the detectors (the bivariate Gaussian's
    # tail is e^-8 a point); those docs complete and leave the re-check
    # loop, and the CPU worker judges each of them too
    alarms = unhealthy(a)
    open_docs = JOINT_DOCS - len(alarms)
    n_cpu = len(cpu["ids"])
    check(a["docs"] == JOINT_DOCS and b["docs"] == c["docs"] == open_docs, "8(d) a tick lost docs")
    check(a["cpu_docs"] == n_cpu and b["cpu_docs"] == c["cpu_docs"] == n_cpu - len(alarms),
          "8(d) a CPU tick lost docs")
    check(not any(a["fast"].values()), "8(d) (a) the cold tick took a fast path")
    check(a["launched"]["lstm_ae_backward"] > 0 and a["launched"]["holt_winters_scan"] > 0,
          f"8(d) (a) the cold tick launched {a['launched']}")
    half = JOINT_DOCS // 2
    open_bi = half - sum(i % 2 == 0 for i in alarms)
    kinds = {"univariate": 0, "bivariate": open_bi, "lstm": open_docs - open_bi, "baseline": 0}
    check(b["fast"] == kinds, f"8(d) (b) kinds {b['fast']}, want {kinds}")
    for name, t in (("b", b), ("c", c)):
        check(not t["refit"] and t["launched"]["lstm_ae_backward"] == 0 and t["launched"]["holt_winters_scan"] == 0,
              f"8(d) ({name}) the warm tick trained or fitted")
        check(t["launched"]["lstm_ae_forward"] > 0, f"8(d) ({name}) the warm tick never launched lstm_ae_forward")
        check(sorted(len(call[1]) for call in t["calls"]) == sorted([open_bi, open_docs - open_bi]),
              f"8(d) ({name}) columnar calls")
    check(b["counters"]["misses"] == open_docs and b["cpu_counters"]["misses"] == n_cpu - len(alarms),
          f"8(d) (b) arena misses {b['counters']} / CPU {b['cpu_counters']}")
    check(c["counters"]["hits"] == open_docs and c["cpu_counters"]["hits"] == n_cpu - len(alarms),
          f"8(d) (c) arena counters {c['counters']} / CPU {c['cpu_counters']}")
    check(unhealthy(b) == alarms, f"8(d) (b) the warm tick flagged {sorted(unhealthy(b) - alarms)} anew")
    want = alarms | set(spiked)
    check(unhealthy(c) == want, f"8(d) (c) flagged {sorted(unhealthy(c) - alarms)}, want the spiked "
          f"{sorted(set(spiked) - alarms)}")
    for name in "abc":
        t = out[name]
        diff = [k for k, v in t["cpu_written"].items() if t["written"][k] != v]
        check(not diff, f"8(d) ({name}) {len(diff)} of the CPU worker's {n_cpu} docs differ: {diff[:4]}")

    # (e) the warm joint dispatch again, on a busy stream, with any
    # synchronizing call raising
    judge = gw._mvj
    dispatch = []
    for call in b["calls"]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        judge.joint_columnar_async(*call)
        idle_s = time.perf_counter() - t1  # the dispatch's host time on an idle stream
        torch.cuda.synchronize()
        busy = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        busy[0].record()
        torch.cuda._sleep(BUSY_CYCLES)
        busy[1].record()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = judge.joint_columnar_async(*call)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dispatch_s = time.perf_counter() - t1
        done = pending.dev.done()
        flags = pending.wait()
        busy_ms = busy[0].elapsed_time(busy[1])
        check(not done and dispatch_s * 1e3 < busy_ms,
              f"8(e) the {call[0]} dispatch waited for the device: returned after {dispatch_s * 1e3:.3f} ms "
              f"behind a {busy_ms:.1f} ms busy kernel (on an idle stream {idle_s * 1e3:.3f} ms), results done {done}")
        check(np.array_equal(flags, orig(*call)), f"8(e) the {call[0]} async dispatch changed the flags")
        dispatch.append(f"{call[0]} ({len(call[1])} docs) returned after {dispatch_s * 1e3:.3f} ms behind a "
                        f"{busy_ms:.1f} ms busy kernel (on an idle stream {idle_s * 1e3:.3f} ms)")
    print(f"phase 8: (d) the cold tick flagged {len(alarms)} clean docs (false alarms of the detectors at "
          f"threshold 4: {sorted(alarms)}); every tick's (status, code, reason, anomaly_info) of the first "
          f"{JOINT_CPU_DOCS} docs and of those equals the CPU worker's (the card's trained entries carried); (b) "
          f"and (c) ran one joint columnar call per kind with 0 trainings and 0 MVN fits; (c) flagged exactly "
          f"the {len(set(spiked) - alarms)} spiked open docs; arena misses/hits per doc equal on both; (e) "
          + "; ".join(dispatch)
          + " (set_sync_debug_mode('error'): no synchronizing call)")
    print(f"phase 8 on {smi}:")
    for name, what in (("a", f"cold tick (train {half} models, MVN at m={SEASON}, bivariate fits, score)"),
                       ("b", "warm tick (joint columnar)"), ("c", "spiked warm tick (joint columnar)")):
        t = out[name]
        stages = ", ".join(f"{k} {v:.4f}" for k, v in sorted(t["stages"].items(), key=lambda kv: -kv[1]))
        print(f"phase 8: (d) ({name}) {what}: {t['seconds']:.3f} s = {t['docs'] / t['seconds']:.0f} docs/s, "
              f"{n_win / t['seconds']:.0f} windows/s (CPU worker, {JOINT_CPU_DOCS} docs: {t['cpu_seconds']:.3f} s); "
              f"stage seconds: {stages}; outside the stage spans {t['seconds'] - sum(t['stages'].values()):.4f}; "
              f"launches {t['launched']}")
    return {"seconds": {k: out[k]["seconds"] for k in "abc"}, "fleet": (docs, data, t_now)}


def joint_worker(doc_json, data, device, tracer=None, device_mesh=None):
    """A BrainWorker under `auto` (threshold 4.0) over a fresh in-memory
    store of `doc_json`, fetching from the in-memory series `data`, its
    judge over `device_mesh`."""
    import dataclasses

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.metrics.source import MetricSource

    class ArraySource(MetricSource):
        concurrent_fetch = False

        def __init__(self, series):
            self.data = dict(series)

        def fetch(self, url: str):
            return self.data[url]

    store = InMemoryStore()
    for d in doc_json:
        store.create(Document.from_json(d))
    cfg = BrainConfig(algorithm="auto", max_cache_size=4 * len(doc_json) + 64)
    cfg = dataclasses.replace(cfg, anomaly=dataclasses.replace(cfg.anomaly, threshold=4.0))
    return BrainWorker(store, ArraySource(data), config=cfg, device=device, claim_limit=len(doc_json),
                       worker_id=f"joint-{device}", tracer=tracer, device_mesh=device_mesh), store


def profile_joint_cold_tick(dev, fleet, top: int = 10) -> None:
    """8(d), split: the joint cold tick again under cProfile, on a fresh
    worker over the first quarter of 8(d)'s fleet (the timed ticks stay
    unprofiled). Prints the tick's seconds and the `top` functions by
    cumulative and by own time."""
    import cProfile
    import pstats

    import torch

    docs, data, t_now = fleet
    n = len(docs) // 4
    worker, _ = joint_worker(docs[:n], data, dev)
    worker.warmup()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    done = worker.tick(now=t_now + 150)
    torch.cuda.synchronize()
    prof.disable()
    seconds = time.perf_counter() - t0
    check(done == n, f"8(d) the profiled cold tick judged {done} of {n} docs")
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, fn), (_cc, calls, own, cum, _callers) in stats.stats.items():
        rows.append((cum, own, calls, f"{os.path.relpath(path, ROOT) if path.startswith(ROOT) else path}:{line}({fn})"))
    rows.sort(key=lambda r: -r[0])
    own_rows = sorted(rows, key=lambda r: -r[1])[:top]
    print(f"phase 8: (d) the cold tick again under cProfile, a fresh worker over {n} docs: {seconds:.3f} s; "
          f"top {top} by cumulative s: " + "; ".join(f"{c:.3f} {name} ({k} calls)" for c, _o, k, name in rows[:top]))
    print(f"phase 8: (d) the same profile, top {top} by own s: "
          + "; ".join(f"{o:.3f} {name} ({k} calls)" for _c, o, k, name in own_rows))

# ---------------------------------------------------------------------------
# phase 10: fault injection and the tenant plane
# ---------------------------------------------------------------------------

TENANT_SLICE = 1024  # FOREMAST_SWEEP_SLICE_DOCS of (a)-(c): four slices of phase 6's 4,096 docs
TENANT_QUIET_FROM = 3072  # the quiet tenants' docs interleave the last quarter of the claim order
WHALE_ARENA_ROWS = 3072  # below the whale's 14,336 windows
TENANT_CPU_DOCS = 512  # (a): the last 512 docs (half quiet) held to a CPU worker
CHAOS_DOCS = 512  # (d): the fleet's last 512 docs, half of the quiet tenants' among them
CHAOS_SLICE = 256  # (d): two slices, so the writer thread writes
CHAOS_SEED = 20
FLOOD_SECONDS = 4.0  # (e): each flood, tenanted and untenanted
WHALE_INGEST_BYTES_PER_S = 1 << 20
WHALE_RING_BYTES = 1 << 20
FLOOD_SERIES = 256  # (e): series per whale body, FLOOD_POINTS samples each (196,608 decoded bytes)
FLOOD_POINTS = 64
QUIET_SERIES = 667  # (e): quiet-a's body every 0.1 s: 6,670 samples/s, STEADY_RATE's stream
CLI_TENANT_DOCS = 256  # (f): one claim of the CLI's default limit
CLI_CHAOS_SECONDS = 15.0  # (f): the store rule's window from the CLI's start: startup, push and first claims


def tenant_of(i: int) -> str:
    """Phase 10's tenants: `quiet-a` and `quiet-b` hold 256 docs each,
    interleaved with the whale's in the last quarter of the claim order
    (doc i % 4 == 1 and == 2: a continuous doc and a canary); `whale`
    holds the other 3,584."""
    if i >= TENANT_QUIET_FROM and i % 4 in (1, 2):
        return "quiet-a" if i % 4 == 1 else "quiet-b"
    return "whale"


def tenant_spec(arena: bool = True, **whale) -> dict:
    """FOREMAST_TENANTS of phase 10: all three tenants at weight 1, the
    whale with its envelopes (`arena`: WHALE_ARENA_ROWS)."""
    w = {"weight": 1, **whale}
    if arena:
        w["arena_rows"] = WHALE_ARENA_ROWS
    return {"tenants": {"whale": w, "quiet-a": {"weight": 1}, "quiet-b": {"weight": 1}}}


def doc_urls(docs) -> list:
    """Every query_range URL the documents' configs name."""
    out = []
    for d in docs:
        for field in ("currentConfig", "historicalConfig", "baselineConfig"):
            for item in filter(None, (d.get(field) or "").split(" ||")):
                out.append(item.split("== ", 1)[1].strip())
    return out


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) else float("nan")


def sweep_recorder(rec: list):
    """run_worker_ticks hook: `rec` gets the worker, then one record a
    sweep (its claim's instant, its slices in order, each doc's write
    instant)."""

    def hook(worker, store):
        claim, prepare, update, update_many = store.claim, worker._prepare_slice, store.update, store.update_many

        def claimed(*a, **kw):
            docs = claim(*a, **kw)
            rec.append({"t0": time.perf_counter(), "slices": [], "writes": {}})
            return docs

        def prepared(*a, **kw):
            prep = prepare(*a, **kw)
            rec[-1]["slices"].append([d.id for d in prep.docs])
            return prep

        def written_many(docs):
            update_many(docs)
            t = time.perf_counter()
            for d in docs:
                rec[-1]["writes"][d.id] = t

        def written(doc):
            out = update(doc)
            rec[-1]["writes"][doc.id] = time.perf_counter()
            return out

        store.claim, worker._prepare_slice = claimed, prepared
        store.update, store.update_many = written, written_many
        rec.append({"worker": worker})  # the first entry: the worker itself

    return hook


def sweep_report(label: str, sweep: dict, docs_tenant: dict) -> dict:
    """Per tenant: the slice index of its last doc, and time-to-verdict
    (claim to the doc's write) p50 / p99 in seconds."""
    slice_of = {d: k for k, ids in enumerate(sweep["slices"]) for d in ids}
    out = {}
    for tenant in sorted(set(docs_tenant.values())):
        ids = [d for d, t in docs_tenant.items() if t == tenant]
        waits = [sweep["writes"][d] - sweep["t0"] for d in ids if d in sweep["writes"]]
        out[tenant] = dict(last_slice=max(slice_of[d] for d in ids), p50=pct(waits, 50), p99=pct(waits, 99),
                           written=len(waits), docs=len(ids))
    print(f"phase 10: (a) {label}: " + "; ".join(
        f"{t} ({v['docs']} docs) last doc in slice {v['last_slice'] + 1} of {len(sweep['slices'])}, "
        f"time-to-verdict p50 {v['p50']:.3f} s p99 {v['p99']:.3f} s" for t, v in out.items()))
    return out


class arena_timer:
    """Host seconds of the state arenas' `assign` and `scatter`, and rows
    scattered, per sweep (`rec`, as `sweep_recorder` fills it: entry 0 is
    the worker, sweep k's record entry k + 1; calls before the first claim
    are not counted)."""

    def __init__(self, rec: list):
        from foremast_tpu_torch.engine import arena

        self.rec, self.arena = rec, arena
        self.sweeps: list = []

    def _slot(self):
        k = len(self.rec) - 2
        if k < 0:
            return None
        while len(self.sweeps) <= k:
            self.sweeps.append({"assign": 0.0, "scatter": 0.0, "rows": 0})
        return self.sweeps[k]

    def __enter__(self):
        row, state = self.arena.RowArena, self.arena.StateArena
        self.saved = (row.assign, state.scatter)
        assign, scatter = self.saved
        timer = self

        def timed_assign(arena, *a, **kw):
            t0 = time.perf_counter()
            try:
                return assign(arena, *a, **kw)
            finally:
                slot = timer._slot()
                if slot is not None:
                    slot["assign"] += time.perf_counter() - t0

        def timed_scatter(arena, rows, positions, entries):
            t0 = time.perf_counter()
            try:
                return scatter(arena, rows, positions, entries)
            finally:
                slot = timer._slot()
                if slot is not None:
                    slot["scatter"] += time.perf_counter() - t0
                    slot["rows"] += len(positions)

        row.assign, state.scatter = timed_assign, timed_scatter
        return self

    def __exit__(self, *exc):
        self.arena.RowArena.assign, self.arena.StateArena.scatter = self.saved


def tenant_sliced_sweeps(dev, docs, data, latency, t_now: int, costs: bool = False) -> dict:
    """(a)-(c): the tenanted sliced sweeps against the untenanted ones, the
    arena envelope, and the f32 route. With `costs`, also against the same
    tenants without the arena envelope (the envelope's cost apart from the
    slice order), each arm with its arenas' host seconds (`arena_timer`)."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.tenant import TenantRegistry, TenantSpec, accounting_for, set_tenancy

    spec = tenant_spec()["tenants"]
    docs_tenant = {d["id"]: tenant_of(i) for i, d in enumerate(docs)}
    quiet = {d for d, t in docs_tenant.items() if t != "whale"}

    def registry():
        return TenantRegistry({n: TenantSpec.from_json(n, s) for n, s in spec.items()})

    arms = [("tenanted", registry()), ("untenanted", None)]
    if costs:
        arms.append(("weights only", TenantRegistry({n: TenantSpec(name=n) for n in spec})))
    runs = {}
    for label, reg in arms:
        set_tenancy(reg)
        try:
            rec: list = []
            t0 = time.perf_counter()
            with arena_timer(rec) if costs else contextlib.nullcontext() as timer:
                out = run_worker_ticks(dev, docs, data, latency, t_now, f32=False, slice_docs=TENANT_SLICE,
                                       hook=sweep_recorder(rec))
            worker = rec.pop(0)["worker"]
            # resident arena rows by tenant, resolved from each row's fit key
            arenas = list(worker._uni._arenas.values())
            resolve = registry().tenant_of_key
            owners = [resolve(k) for a in arenas for k in a.rows]
            runs[label] = dict(out=out, sweeps=rec, seconds=time.perf_counter() - t0,
                               acct=accounting_for(reg).snapshot() if reg is not None else None,
                               rows={t: owners.count(t) for t in spec},
                               evictions=sum(a.evictions for a in arenas))
            if costs:
                idle = [{"assign": 0.0, "scatter": 0.0, "rows": 0}] * (len(rec) - len(timer.sweeps))
                runs[label]["arena"] = timer.sweeps + idle
        finally:
            set_tenancy(None)
    ten, plain = runs["tenanted"], runs["untenanted"]
    tenanted = [label for label in runs if label != "untenanted"]
    for name, what in (("a", "cold"), ("b", "warm"), ("c", "spiked warm")):
        u = plain["out"][name]
        for label in tenanted:
            t = runs[label]["out"][name]
            check(t["docs"] == u["docs"] == len(docs), f"(a) {label} {what}: {t['docs']} / {u['docs']} docs")
            check(t["sweep"]["slices"] == len(docs) // TENANT_SLICE, f"(a) {what}: {t['sweep']['slices']} slices")
            diff = sum(t["written"][k] != v for k, v in u["written"].items())
            check(t["written"] == u["written"], f"(a) {label} {what}: writes differ from untenanted on {diff} docs")
    for label in tenanted:
        for k, sweep in enumerate(runs[label]["sweeps"]):
            first = set(sweep["slices"][0])
            check(quiet <= first, f"(a) {label} sweep {k + 1}: {len(quiet - first)} quiet docs missed the first slice")
    reports = {label: [sweep_report(f"{label} sweep {k + 1} ({n})", sw, docs_tenant)
                       for k, (sw, n) in enumerate(zip(r["sweeps"], ("cold", "warm", "spiked warm")))]
               for label, r in runs.items()}
    for k, (name, what) in enumerate((("a", "cold"), ("b", "warm"), ("c", "spiked warm"))):
        print(f"phase 10: (a) {what} sweep in {TENANT_SLICE}-doc slices: " + "; ".join(
            f"{label} {r['out'][name]['seconds']:.3f} s" + (
                f" (arena assign {r['arena'][k]['assign']:.4f} s, scatter {r['arena'][k]['scatter']:.4f} s of "
                f"{r['arena'][k]['rows']} rows)" if costs else "") for label, r in runs.items())
            + f"; writes of all {len(docs)} docs equal")

    # the fleet's statuses against a CPU worker (tenanted) on its last 512 docs
    sub = docs[-TENANT_CPU_DOCS:]
    set_tenancy(registry())
    try:
        cpu = run_worker_ticks("cpu", sub, data, latency[-TENANT_CPU_DOCS:], t_now, f32=False,
                               slice_docs=TENANT_CPU_DOCS // 4)
    finally:
        set_tenancy(None)
    for name in "abc":
        for d in sub:
            check(cpu[name]["written"][d["id"]] == ten["out"][name]["written"][d["id"]],
                  f"(a) ({name}) {d['id']}: the card's write differs from a CPU worker's")
    print(f"phase 10: (a) the last {TENANT_CPU_DOCS} docs' writes (cold, warm, spiked) equal a tenanted CPU worker's "
          f"(slices of {TENANT_CPU_DOCS // 4})")

    # (b) the arena envelope
    acct = ten["acct"]
    check(acct["whale"]["evictions"] > 0, f"(b) no eviction was charged to the whale: {acct}")
    for q in ("quiet-a", "quiet-b"):
        check(acct.get(q, {}).get("evictions", 0) == 0, f"(b) an eviction was charged to {q}: {acct}")
        check(ten["rows"][q] == plain["rows"][q] > 0,
              f"(b) {q} holds {ten['rows'][q]} arena rows, {plain['rows'][q]} without the envelope: a quiet row "
              f"was evicted")
    check(acct["whale"]["claims"] == 3 * sum(t == "whale" for t in docs_tenant.values()),
          f"(b) whale claims {acct['whale']['claims']}")
    print(f"phase 10: (b) arena envelope {WHALE_ARENA_ROWS} rows for the whale: evictions charged "
          f"{ {t: v['evictions'] for t, v in acct.items()} }, resident rows by tenant {ten['rows']}, arena evictions "
          f"{ten['evictions']} (untenanted: {plain['evictions']}); claims {({t: v['claims'] for t, v in acct.items()})}; "
          f"verdicts equal the unenveloped arena's")

    # (c) the f32 route: one tenanted cold sweep, FOREMAST_BF16_DELTA=0
    store = InMemoryStore()
    for d in docs:
        store.create(Document.from_json(d))
    set_tenancy(registry())
    scoring.set_bf16_delta(False)
    try:
        with slice_env(TENANT_SLICE):
            worker = BrainWorker(store, array_source(data),
                                 config=BrainConfig(max_cache_size=len(docs) * len(ALIASES) + 64),
                                 device=dev, claim_limit=len(docs), worker_id="smoke-f32-tenanted")
        before = K.LAUNCHES["masked_stats"]
        sync_card()
        t0 = time.perf_counter()
        n = worker.tick(now=t_now + 150)
        sync_card()
        f32_s = time.perf_counter() - t0
        f32_launches = K.LAUNCHES["masked_stats"] - before
        worker.close()
    finally:
        scoring.set_bf16_delta(None)
        set_tenancy(None)
    f32_written = {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                   for d in store._docs.values()}
    check(n == len(docs), f"(c) the f32 sweep judged {n} docs")
    statuses = {k: json.loads(v)[0] for k, v in f32_written.items()}
    check(statuses == {k: json.loads(v)[0] for k, v in ten["out"]["a"]["written"].items()},
          "(c) the f32 cold sweep's statuses differ from (a)'s")
    check(f32_launches > 0, "(c) the tenanted f32 cold sweep launched no masked_stats")
    print(f"phase 10: (c) tenanted f32 cold sweep (FOREMAST_BF16_DELTA=0) of {len(docs)} docs in {f32_s:.3f} s: "
          f"statuses equal (a)'s; masked_stats launched {f32_launches} times")
    return dict(runs=runs, reports=reports, f32_seconds=f32_s, f32_launches=f32_launches)


def chaos_arm(dev, docs, data, ref: dict, smi: str, t_now: int) -> dict:
    """(d): a worker over ElasticsearchStore (the fake index of
    tests/torch_fake_services.py on a loopback socket; claim CHAOS_DOCS,
    slices of CHAOS_SLICE, so the writer thread writes) under one seeded plan: a `store`
    rule over one warm sweep's write window (the plan's clock enters it
    right after that sweep's claim), then a `prometheus` rule of error
    rate 0.2 over one sweep on the pulled path (PrometheusSource against
    the fake Prometheus, fetch retries 0), then nothing; and a receiver
    whose `receiver` rule answers 503. `ref` holds the writes of (a)'s
    tenanted run for these docs."""
    import urllib.error
    import urllib.request

    from foremast_tpu_torch.chaos import Degradation, FaultPlan
    from foremast_tpu_torch.chaos.degrade import REASON_BUFFERED, REASON_FETCH, REASON_REPLAYED
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, RingStore, encode_frame, start_ingest_server
    from foremast_tpu_torch.ingest import stop_ingest_server
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.metrics.source import PrometheusSource
    from foremast_tpu_torch.observe.spans import Tracer

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    clock = [0.0]
    plan = FaultPlan.from_json({"seed": CHAOS_SEED, "rules": [
        {"edge": "store", "after": 100.0, "duration": 100.0, "error_rate": 1.0},
        {"edge": "prometheus", "after": 300.0, "duration": 100.0, "error_rate": 0.2},
    ]}, clock=lambda: clock[0]).activate()
    degrade = Degradation(chaos_plan=plan)
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    servers = [prom_srv, es_srv]
    data = {u: data[u] for u in doc_urls(docs)}
    try:
        rdocs, keyed = rebase(docs, data, "http://prom", prom_url)
        # the warm passes fetch current windows and baselines only
        prom.data = {k: v for k, v in keyed.items() if not k.startswith("/hist")}
        prom.prepare()
        es.load(rdocs)
        store = ElasticsearchStore(es_url, chaos=plan.edge("store"), breaker=degrade.breakers.get("store"))
        check(store.wait_ready(max_wait=30), "(d) the fake Elasticsearch never answered")
        with slice_env(CHAOS_SLICE):
            worker = BrainWorker(store, array_source({u.replace("http://prom", prom_url): v for u, v in data.items()}),
                                 config=BrainConfig(max_cache_size=len(docs) * len(ALIASES) + 64),
                                 device=dev, claim_limit=len(docs), worker_id="smoke-chaos", tracer=Tracer(),
                                 degrade=degrade)
        writes: dict = {}
        update_many = store.update_many

        def recorded(ds):
            update_many(ds)
            for d in ds:
                writes[d.id] = writes.get(d.id, 0) + 1

        store.update_many = recorded
        claimed, released = [], []
        claim, release = store.claim, worker._release_docs

        def on_claim(*a, **kw):
            got = claim(*a, **kw)
            claimed.extend(d.id for d in got)
            if on_claim.enter is not None:
                clock[0] = on_claim.enter  # the plan enters its window right after this claim
            return got

        def on_release(ds, reason, *a, **kw):
            released.extend(d.id for d in ds)
            return release(ds, reason, *a, **kw)

        on_claim.enter = None
        store.claim, worker._release_docs = on_claim, on_release
        timings = {}

        def sweep(name, now):
            es.set_status(None)  # stamps aged: one claim takes the fleet
            claimed.clear()
            released.clear()
            writes.clear()
            sync_card()
            t0 = time.perf_counter()
            n = worker.tick(now=now)
            sync_card()
            timings[name] = time.perf_counter() - t0
            return n

        check(sweep("cold", t_now + 150) == len(docs), "(d) the cold sweep lost docs")
        got = es_written(es.sources())
        check(got == {d["id"]: ref["a"][d["id"]] for d in docs}, "(d) the cold sweep's writes differ from (a)'s")
        # the store outage over one warm sweep's writes
        on_claim.enter = 150.0
        check(sweep("outage", t_now + 200) == len(docs), "(d) the outage sweep lost docs")
        on_claim.enter = None
        stats = degrade.stats.docs_snapshot()
        check(not writes, f"(d) {len(writes)} writes reached the store during its outage")
        check(stats.get(REASON_BUFFERED, 0) == len(docs) and len(degrade.write_behind) == len(docs),
              f"(d) write-behind holds {len(degrade.write_behind)} of {len(docs)} verdicts ({stats})")
        store_breaker = degrade.breakers.get("store").debug_state()
        check(store_breaker["consecutive_failures"] > 0 or store_breaker["transitions"],
              f"(d) the store breaker saw none of the writer's failures: {store_breaker}")
        clock[0] = 250.0  # the store heals
        check(sweep("replay", t_now + 200) == len(docs), "(d) the replay sweep lost docs")
        check(degrade.stats.docs_snapshot().get(REASON_REPLAYED, 0) == len(docs) and not len(degrade.write_behind),
              f"(d) replayed {degrade.stats.docs_snapshot().get(REASON_REPLAYED, 0)} of {len(docs)}")
        check(writes == {d["id"]: 2 for d in docs},
              f"(d) not one replay and one verdict per doc: {sorted(set(writes.values()))} writes")
        check(es_written(es.sources()) == {d["id"]: ref["b"][d["id"]] for d in docs},
              "(d) after the replay the writes differ from (a)'s warm sweep")
        # the pulled path under a seeded 0.2 error rate
        worker.source = PrometheusSource(retries=0, chaos=plan.edge("prometheus"),
                                         breaker=degrade.breakers.get("prometheus"))
        clock[0] = 350.0
        fetch_before = degrade.stats.docs_snapshot().get(REASON_FETCH, 0)
        check(sweep("prometheus", t_now + 200) == len(docs), "(d) the Prometheus-fault sweep lost docs")
        faulted = sorted(set(released))
        judged = set(claimed) - set(released)
        check(degrade.stats.docs_snapshot().get(REASON_FETCH, 0) - fetch_before == len(faulted) > 0,
              f"(d) the 0.2 error rate released {len(faulted)} docs")
        sources = es.sources()
        check(all(sources[d]["status"] == "preprocess_completed" for d in faulted),
              "(d) a released doc was left terminal or in progress")
        clock[0] = 450.0
        later = 0
        every = {d["id"] for d in docs}
        while not judged >= every and later < 4:
            later += 1
            sweep(f"after {later}", t_now + 200)
            judged |= set(claimed) - set(released)
        check(judged >= every, f"(d) {len(every - judged)} docs never judged after the faults")
        check(es_written(es.sources()) == {d["id"]: ref["b"][d["id"]] for d in docs},
              "(d) the final writes differ from (a)'s chaos-free warm sweep")
        worker.close()

        # the receiver edge: a rule that answers 503
        rplan = FaultPlan.from_json({"seed": CHAOS_SEED, "rules": [
            {"edge": "receiver", "error_rate": 1.0, "kind": "status", "status": 503}]}).activate()
        srv, _ = start_ingest_server(0, RingStore(budget_bytes=1 << 24, shards=2), host="127.0.0.1",
                                     chaos=rplan.edge("receiver"))
        body = encode_frame([("foremast_smoke_chaos{app=\"a\"}", np.array([t_now], np.int64),
                              np.ones(1, np.float32), None)])
        codes = []
        try:
            for _ in range(3):
                req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write", data=body,
                                             method="POST", headers={"Content-Type": BINARY_CONTENT_TYPE})
                try:
                    urllib.request.urlopen(req, timeout=30).read()
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
        finally:
            stop_ingest_server(srv)
        check(codes == [503] * 3, f"(d) the receiver answered {codes} under its 503 rule")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    inj = {**plan.injections_snapshot(), **rplan.injections_snapshot()}
    transitions = {e: b["transitions"] for e, b in degrade.breakers.debug_state().items()}
    print(f"phase 10: (d) chaos on {smi}, {len(docs)} docs, claim {len(docs)}, slices of {CHAOS_SLICE}: sweeps "
          + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
          + f"; store outage over one warm sweep's writes: {len(docs)} verdicts to write-behind, each replayed once "
          f"by the next sweep; Prometheus error rate 0.2 (seed {CHAOS_SEED}, retries 0): {len(faulted)} docs "
          f"released un-judged, every doc judged {later} sweep(s) after; receiver rule answered {codes}; "
          f"injections by (edge, kind) {dict(sorted(inj.items()))}; breaker transitions {transitions}; "
          f"final writes equal a chaos-free sweep's")
    return dict(injections=inj, transitions=transitions, seconds=timings, released=len(faulted))


def ingest_flood(tenanted: bool, t_now: int) -> dict:
    """(e) one flood: the whale pushes back to back from two clients while
    quiet-a pushes QUIET_SERIES one-sample series every 0.1 s, for
    FLOOD_SECONDS, against a receiver in this process (tenanted: the
    whale's ingest byte-rate and ring-bytes envelopes)."""
    import threading
    import urllib.error
    import urllib.request

    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, RingStore, encode_frame, start_ingest_server
    from foremast_tpu_torch.ingest import stop_ingest_server
    from foremast_tpu_torch.tenant import TenantRegistry, TenantSpec, accounting_for

    reg = None
    if tenanted:
        spec = tenant_spec(False, ingest_bytes_per_s=WHALE_INGEST_BYTES_PER_S, ring_bytes=WHALE_RING_BYTES)["tenants"]
        reg = TenantRegistry({n: TenantSpec.from_json(n, s) for n, s in spec.items()})
    ring = RingStore(budget_bytes=1 << 30, shards=8, tenancy=reg)
    srv, _ = start_ingest_server(0, ring, host="127.0.0.1", tenancy=reg) if reg is not None else \
        start_ingest_server(0, ring, host="127.0.0.1")
    url = f"http://127.0.0.1:{srv.server_address[1]}/api/v1/write"
    rng = np.random.default_rng(5)
    whale_bodies = []
    for b in range(32):
        t = (t_now - 86_400 + 60 * np.arange(FLOOD_POINTS, dtype=np.int64) + 60 * FLOOD_POINTS * b)
        whale_bodies.append(encode_frame([
            (f'foremast_smoke_flood{{app="w{b}-{j}",tenant="whale"}}', t,
             rng.normal(1, 0.1, FLOOD_POINTS).astype(np.float32), None) for j in range(FLOOD_SERIES)]))
    quiet_keys = [f'foremast_smoke_quiet{{app="q{j}",tenant="quiet-a"}}' for j in range(QUIET_SERIES)]
    stop = threading.Event()
    tallies = {"whale": [0, 0, 0, 0], "quiet-a": [0, 0, 0, 0]}  # bodies sent, accepted samples, 200s, 429s
    shed_tenants: set = set()
    errors: list = []  # any other answer, and any exception, of a client thread: the main thread fails on them
    lock = threading.Lock()

    def post(tenant, body):
        req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": BINARY_CONTENT_TYPE})
        with lock:
            tallies[tenant][0] += 1
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                n = json.loads(resp.read())["accepted_samples"]
            with lock:
                tallies[tenant][1] += n
                tallies[tenant][2] += 1
        except urllib.error.HTTPError as e:
            answer = json.loads(e.read() or b"{}")
            with lock:
                if e.code != 429:
                    errors.append(f"{tenant}'s push answered {e.code}: {answer}")
                    return
                tallies[tenant][3] += 1
                shed_tenants.add(answer.get("tenant"))

    def whale():
        k = 0
        while not stop.is_set():
            post("whale", whale_bodies[k % len(whale_bodies)])
            k += 1

    def quiet():
        k = 0
        t0 = time.perf_counter()
        while not stop.is_set():
            t = np.array([t_now + 15 * k], np.int64)
            post("quiet-a", encode_frame([(key, t, np.ones(1, np.float32), None) for key in quiet_keys]))
            k += 1
            time.sleep(max(0.0, t0 + 0.1 * k - time.perf_counter()))

    def client(loop):
        def run():
            try:
                loop()  # returns only once `stop` is set
            except Exception as e:  # noqa: BLE001 - reported to the main thread, which fails on it
                with lock:
                    errors.append(f"a {loop.__name__} client ended before the flood did: {e!r}")

        return threading.Thread(target=run)

    threads = [client(whale), client(whale), client(quiet)]
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(FLOOD_SECONDS)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        seconds = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "(e) a pushing client never finished")
        check(not errors, f"(e) {'tenanted' if tenanted else 'untenanted'} flood: {len(errors)} pushes failed "
                          f"otherwise than with a 429, e.g. {errors[:3]}")
    finally:
        stop.set()
        stop_ingest_server(srv)
    resident_quiet = sum(1 for s in ring._shards for k in s._series if 'tenant="quiet-a"' in k)
    return dict(seconds=seconds, tallies=tallies, shed_tenants=shed_tenants, resident_quiet=resident_quiet,
                acct=accounting_for(reg).snapshot() if reg is not None else None, stats=ring.stats())


def ingest_envelopes(smi: str, t_now: int) -> dict:
    """(e): only the whale is shed (429 naming it) and evicted; quiet-a
    pushes at 6,670 samples/s with 0 sheds and 0 evictions; accepted
    samples/s per tenant, tenanted and untenanted."""
    runs = {label: ingest_flood(label == "tenanted", t_now) for label in ("tenanted", "untenanted")}
    ten = runs["tenanted"]
    acct = ten["acct"]
    check(ten["tallies"]["whale"][3] > 0 and ten["shed_tenants"] == {"whale"},
          f"(e) sheds {ten['tallies']}, tenants named {ten['shed_tenants']}")
    sent, _, taken, shed = ten["tallies"]["quiet-a"]
    check(sent > 0 and taken == sent and shed == 0 and acct.get("quiet-a", {}).get("shed", 0) == 0,
          f"(e) quiet-a sent {sent} bodies, {taken} taken, {shed} shed; ledger {acct.get('quiet-a')}")
    sent, _, taken, shed = ten["tallies"]["whale"]
    check(taken + shed == sent, f"(e) the whale sent {sent} bodies, {taken} taken and {shed} shed")
    check(acct["whale"]["shed"] == shed, f"(e) whale sheds charged {acct['whale']['shed']}")
    check(acct["whale"]["evictions"] > 0 and acct.get("quiet-a", {}).get("evictions", 0) == 0,
          f"(e) evictions {acct}")
    check(ten["resident_quiet"] == QUIET_SERIES, f"(e) {ten['resident_quiet']} of quiet-a's series resident")
    check(acct["whale"]["ring_bytes"] <= WHALE_RING_BYTES, f"(e) whale ring bytes {acct['whale']['ring_bytes']}")
    for label, r in runs.items():
        rates = {t: v[1] / r["seconds"] for t, v in r["tallies"].items()}
        print(f"phase 10: (e) {label} receiver on {smi}, {r['seconds']:.1f} s: accepted samples/s whale "
              f"{rates['whale']:.0f} ({r['tallies']['whale'][2]} bodies taken, {r['tallies']['whale'][3]} shed), "
              f"quiet-a {rates['quiet-a']:.0f} ({r['tallies']['quiet-a'][2]} of {r['tallies']['quiet-a'][0]} taken, "
              f"{r['tallies']['quiet-a'][3]} shed); "
              f"ring evictions {r['stats']['evictions']}"
              + (f"; ledger {r['acct']}" if r["acct"] else ""))
    return runs


def tenant_cli_run(dev, docs, data, ref: dict, workdir: str) -> dict:
    """(f): `python -m foremast_tpu_torch worker` with FOREMAST_TENANTS,
    FOREMAST_CHAOS_PLAN (a seeded store rule over its first seconds) and
    FOREMAST_INGEST=1: the fleet's samples pushed to its receiver, its
    writes equal (a)'s cold ones; its receiver's /debug/state has the
    `tenants` section, and its stop record the plan's injections and the
    tenant ledger (the card's host has no prometheus_client, so the gauge
    port's /debug/state is not served there; tests/test_torch_cli_worker.py
    reads that one on the CPU)."""
    import urllib.request

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    try:
        data = {u: data[u] for u in doc_urls(docs)}
        rdocs, keyed = rebase(docs, data, "http://prom", prom_url)
        prom.data = keyed  # the fallback, never asked
        entries = push_entries(data)  # the ring's keys come from the queries, not the host
        port = free_port()
        plan = {"seed": CHAOS_SEED, "rules": [{"edge": "store", "duration": CLI_CHAOS_SECONDS, "error_rate": 0.3}]}
        env = {"FOREMAST_INGEST": "1", "FOREMAST_INGEST_PORT": str(port),
               "FOREMAST_INGEST_BUDGET_BYTES": str(PUSH_BUDGET_BYTES),
               "FOREMAST_TENANTS": json.dumps(tenant_spec()), "FOREMAST_CHAOS_PLAN": json.dumps(plan)}
        seen = {}

        def push_then_load():
            t0 = time.perf_counter()  # before the CLI activates its plan
            seen["push"] = push_frames(f"http://127.0.0.1:{port}/api/v1/write", entries, wait=CLI_TIMEOUT)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/state", timeout=30) as resp:
                seen["state"] = json.loads(resp.read())
            es.load(rdocs)
            # the fleet is judged, re-check after re-check, through the
            # outage; read it once the rule's window is over and the
            # worker has swept since (a SIGTERM inside the window leaves a
            # failed write in write-behind, as in the JAX worker: the doc
            # waits for the stuck-claim takeover)
            time.sleep(max(0.0, t0 + CLI_CHAOS_SECONDS + 3.0 - time.perf_counter()))

        run = cli_run(es_url, os.path.join(workdir, "snap-tenant"), es, workdir, "tenants-chaos", dev, env,
                      started=push_then_load, fleet_docs=len(rdocs))
    finally:
        for s in (prom_srv, es_srv):
            s.shutdown()
            s.server_close()
    diff = sorted(d["id"] for d in docs if run["written"][d["id"]] != ref["a"][d["id"]])
    if diff:
        print(f"phase 10: (f) CLI stderr:\n{run['stderr'][-20000:]}", file=sys.stderr)
    check(not diff, f"(f) the CLI's writes differ from (a)'s on {len(diff)} docs, e.g. {diff[:1]}: "
                    f"{[run['written'][d] for d in diff[:1]]} against {[ref['a'][d] for d in diff[:1]]}")
    check(sum(prom.requests.values()) == 0, f"(f) the CLI asked Prometheus {dict(prom.requests)}")
    tenants = seen["state"].get("tenants") or {}
    check(set(tenants.get("registry", {}).get("configured", {})) == {"whale", "quiet-a", "quiet-b"},
          f"(f) the receiver's /debug/state tenants section: {tenants.get('registry')}")
    started = [r for r in run["records"] if r.get("msg") == "worker started"]
    stopped = [r for r in run["records"] if r.get("msg") == "worker stopped"]
    check(started and started[0].get("chaos_rules") == 1 and started[0].get("tenants") == ["quiet-a", "quiet-b", "whale"],
          f"(f) the start record: {started[:1]}")
    check(stopped and (stopped[-1].get("chaos_injections") or {}).get("store/connection", 0) > 0,
          f"(f) the stop record's injections: {stopped[-1:]}")
    ledger = stopped[-1].get("tenants") or {}
    check(all(ledger.get(t, {}).get("claims", 0) > 0 for t in ("whale", "quiet-a", "quiet-b")),
          f"(f) the stop record's tenant ledger: {ledger}")
    check(any("CHAOS PLAN ACTIVE" in ln for ln in run["lines"] + [json.dumps(r) for r in run["records"]]),
          "(f) the CLI never announced its chaos plan")
    print(f"phase 10: (f) python3 -m foremast_tpu_torch worker with FOREMAST_TENANTS, FOREMAST_CHAOS_PLAN (store "
          f"error rate 0.3 over its first {CLI_CHAOS_SECONDS:.0f} s, seed {CHAOS_SEED}) and FOREMAST_INGEST=1: "
          f"{seen['push'][1]} samples pushed, "
          f"{len(docs)} docs judged in {run['seconds']:.1f} s from start, writes equal (a)'s, 0 Prometheus requests, "
          f"SIGTERM exit 0; receiver /debug/state tenants: {sorted(tenants)}; injections "
          f"{stopped[-1]['chaos_injections']}; ledger claims {({t: v['claims'] for t, v in ledger.items()})}")
    return run


def phase_tenants_and_chaos(dev, smi: str, costs: bool = False) -> dict:
    """Phase 10: fault injection and the tenant plane at phase 6's width
    (`costs`: tenant_sliced_sweeps' cost arms too)."""
    import tempfile

    t_now = int(time.time()) - 600  # settled histories, for the CLI's real clock too
    t0 = time.perf_counter()
    docs, data, latency = worker_fleet(WORKER_DOCS, t_now, tenant_of=tenant_of)
    counts = {t: sum(tenant_of(i) == t for i in range(WORKER_DOCS)) for t in ("whale", "quiet-a", "quiet-b")}
    print(f"phase 10: fleet of {WORKER_DOCS} docs x {len(ALIASES)} aliases (Th={FULL_TH}, Tc={FULL_TC}, half "
          f"canaries), every selector labelled with its doc's tenant {counts}, built in "
          f"{time.perf_counter() - t0:.1f} s; FOREMAST_TENANTS {json.dumps(tenant_spec())}")
    sweeps = tenant_sliced_sweeps(dev, docs, data, latency, t_now, costs)
    ref = {name: sweeps["runs"]["tenanted"]["out"][name]["written"] for name in "ab"}
    t1 = time.perf_counter()
    chaos = chaos_arm(dev, docs[-CHAOS_DOCS:], data, ref, smi, t_now)
    t2 = time.perf_counter()
    flood = ingest_envelopes(smi, t_now)
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="foremast-phase10-", ignore_cleanup_errors=True) as workdir:
        cli = tenant_cli_run(dev, docs[-CLI_TENANT_DOCS:], data, ref, workdir)
    print(f"phase 10: seconds: (a)-(c) {t1 - t0:.1f}, (d) {t2 - t1:.1f}, (e) {t3 - t2:.1f}, "
          f"(f) {time.perf_counter() - t3:.1f}")
    return dict(sweeps=sweeps, chaos=chaos, flood=flood, cli_seconds=cli["seconds"])


# ---------------------------------------------------------------------------
# phase 11: the worker mesh
# ---------------------------------------------------------------------------

MESH_DOCS = 4096  # phase 6's fleet, every series labelled with its doc's `app` (the route label)
MESH_SLICE = 1024  # FOREMAST_SWEEP_SLICE_DOCS of the members: their claims sweep in slices
MESH_LEASE = 600.0  # in-process leases: (d)'s death comes from the clock edge, not from a slow tick
MESH_STUCK = 4.0  # the members' max_stuck_seconds: the window (d)'s orphaned claims wait out
MESH_BUDGET_BYTES = 6 << 30  # per member ring: no eviction may turn a ring read into a fallback read
MESH_DEADLINE = 120.0  # (b)-(c): the join deadline, never reached by a transfer that lands
BLACKHOLE_DEADLINE = 5.0  # (f): the joiner's deadline under a blackholed transfer edge
MESH_INGEST_DOCS = 512  # (e)
MESH_PUSH_SERIES = 64  # (e): series per push_cycle call (one FMW1 body each, under the receiver's cap)
MESH_CLI_DOCS = 256  # (g)


class CountingSource:
    """The fallback behind each member's ring: phase 6's in-memory series,
    every read counted (a fallback history read is what the transferred
    ring state must make unnecessary)."""

    concurrent_fetch = False

    def __init__(self, series: dict):
        import threading

        self.data = series
        self.reads = 0
        self._lock = threading.Lock()

    def fetch(self, url: str):
        with self._lock:
            self.reads += 1
        return self.data[url]


def fleet_written(store) -> dict:
    """Each fleet doc's (status, code, reason, anomaly_info), as phase 6
    records it; the mesh's member records left out."""
    from foremast_tpu_torch.mesh import MESH_APP

    return {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
            for d in store._docs.values() if d.app_name != MESH_APP}


def mesh_seat(dev, store, data, wid: str, fenced: bool, n_docs: int, deadline: float = MESH_DEADLINE,
              fallback=None):
    """One member on the card: its own ring, RingSource over it with a
    counting fallback, receiver (router and handoff wired), handoff plane,
    MeshNode and BrainWorker (claims sliced at MESH_SLICE, each slice's
    columnar dispatch under set_sync_debug_mode("error"), counted). Its
    membership clock is a chaos plan's ``clock`` edge, skewed back by three
    leases once `skew()` is called."""
    import types

    import torch

    from foremast_tpu_torch.chaos import FaultPlan
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.ingest import RingSource, RingStore, start_ingest_server
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.mesh import HandoffManager, Membership, MeshNode, MeshRouter

    ring = RingStore(budget_bytes=MESH_BUDGET_BYTES)
    handoff = HandoffManager(ring_store=ring, deadline_seconds=deadline)
    plan_now = [0.0]
    plan = FaultPlan(rules=({"edge": "clock", "after": 1e9, "skew_seconds": -3 * MESH_LEASE},),
                     clock=lambda: plan_now[0]).activate()
    mem = Membership(store, wid, lease_seconds=MESH_LEASE, clock=plan.edge("clock").clock())
    router = MeshRouter(mem, refresh_seconds=0.0)
    srv, _ = start_ingest_server(0, ring, host="127.0.0.1", router=router, handoff=handoff)
    mem.ingest_address = f"127.0.0.1:{srv.server_address[1]}"
    node = MeshNode(mem, router, ring_store=ring, handoff=handoff, join_fenced=fenced)
    fallback = fallback if fallback is not None else CountingSource(data)
    with slice_env(MESH_SLICE):
        worker = BrainWorker(store, RingSource(ring, fallback=fallback),
                             config=BrainConfig(max_cache_size=4 * n_docs + 64, max_stuck_seconds=MESH_STUCK),
                             device=dev, claim_limit=n_docs + 16, worker_id=wid, mesh=node)
    seat = types.SimpleNamespace(wid=wid, ring=ring, handoff=handoff, node=node, srv=srv, worker=worker,
                                 fallback=fallback, dispatches=0, cold_rows=0, sent_bytes=0,
                                 skew=lambda: plan_now.__setitem__(0, 2e9))
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        worker.warmup()
    dispatch = worker._dispatch_uni

    def strict_dispatch(packed):
        seat.dispatches += 1
        if not cuda:
            return dispatch(packed)
        torch.cuda.set_sync_debug_mode("error")  # the columnar dispatch must not synchronize
        try:
            return dispatch(packed)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    worker._dispatch_uni = strict_dispatch
    fit_rows = worker._uni._fit_miss_rows

    def counted_fit(miss, *a, **kw):
        seat.cold_rows += len(miss)
        return fit_rows(miss, *a, **kw)

    worker._uni._fit_miss_rows = counted_fit
    post = handoff._post

    def counted_post(address, body):
        seat.sent_bytes += len(body)
        return post(address, body)

    handoff._post = counted_post
    return seat


def mesh_store(docs):
    """An in-memory store over `docs` whose claims are recorded: returns
    (store, claims, fleet ids); `claims` collects (worker id, claimed ids)
    per claim call and is cleared by its reader."""
    from foremast_tpu_torch.jobs import Document, InMemoryStore

    store = InMemoryStore()
    for d in docs:
        store.create(Document.from_json(d))
    claims: list = []
    orig_claim = store.claim

    def recorded_claim(worker_id, max_stuck_seconds, limit=64, claim_filter=None):
        got = orig_claim(worker_id, max_stuck_seconds, limit=limit, claim_filter=claim_filter)
        claims.append((worker_id, [d.id for d in got]))
        return got

    store.claim = recorded_claim
    return store, claims, {d["id"] for d in docs}


def start_seats(seats) -> None:
    """Register every seat, then refresh each router, so all see all."""
    for s in seats:
        s.node.start()
    for s in seats:
        s.node.router.refresh(force=True)


def stop_seats(seats) -> None:
    for s in seats:
        s.worker.close()
        s.srv.shutdown()
        s.srv.server_close()


def mesh_tick(seat) -> dict:
    """One tick of a member, with what it cost: wall clock (after a device
    sync), docs, cold-fit rows, fallback reads, columnar dispatches."""
    rows, reads, disp = seat.cold_rows, seat.fallback.reads, seat.dispatches
    sync_card()
    t0 = time.perf_counter()
    n = seat.worker.tick()
    sync_card()
    return dict(seconds=time.perf_counter() - t0, docs=n, cold_rows=seat.cold_rows - rows,
                fallback_reads=seat.fallback.reads - reads, dispatches=seat.dispatches - disp)


def mesh_round(label: str, seats: list, store, claims: list, want: dict, fleet_ids: set) -> dict:
    """Every seat ticks once, in order: the claims must be disjoint and
    cover the fleet, and every doc's writes must equal `want`."""
    claims.clear()
    ticks = {s.wid: mesh_tick(s) for s in seats}
    ids = [i for _, got in claims for i in got]
    check(len(ids) == len(set(ids)), f"11{label}: a doc was claimed twice in one round")
    check(set(ids) == fleet_ids, f"11{label}: the round claimed {len(set(ids))} of {len(fleet_ids)} docs")
    got = fleet_written(store)
    diff = sorted(d for d in fleet_ids if got[d] != want[d])
    check(not diff, f"11{label}: writes differ from the single worker's on {len(diff)} docs, e.g. "
                    f"{diff[:1]}: {[got[d] for d in diff[:1]]} against {[want[d] for d in diff[:1]]}")
    return ticks


def tick_summary(ticks: dict) -> str:
    return "; ".join(f"{w} {t['docs']} docs {t['seconds']:.3f} s (cold-fit rows {t['cold_rows']}, fallback reads "
                     f"{t['fallback_reads']}, dispatches {t['dispatches']})" for w, t in ticks.items())


def single_mesh_reference(dev, docs, data) -> dict:
    """What one card worker writes on the fleet (pull, monolithic): cold,
    then warm; with the seconds of each tick. A comparison: its launches
    are taken back out of the counts."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.ops import kernels as K

    counted = dict(K.LAUNCHES)  # a comparison: its launches do not count
    store, _, _ = mesh_store(docs)
    with slice_env(0):
        worker = BrainWorker(store, array_source(data), config=BrainConfig(max_cache_size=4 * len(docs) + 64),
                             device=dev, claim_limit=len(docs), worker_id="smoke-single")
    try:
        if torch.device(dev).type == "cuda":
            worker.warmup()
        out = {}
        for name in ("cold", "warm"):
            sync_card()
            t0 = time.perf_counter()
            check(worker.tick() == len(docs), f"the single worker's {name} tick lost docs")
            sync_card()
            out[name] = fleet_written(store)
            out[f"{name}_s"] = time.perf_counter() - t0
    finally:
        worker.close()
        K.LAUNCHES.update(counted)
    return out


def mesh_partition_arms(dev, docs, data, ref: dict) -> dict:
    """(a)-(d) and (f) on one shared store: three members partition the
    fleet, a fourth joins through the handoff, one drains, one dies, and a
    fifth joins under a blackholed transfer edge."""
    import threading

    import torch

    from foremast_tpu_torch.chaos import FaultPlan
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import Document
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.ops import kernels as K

    store, claims, fleet_ids = mesh_store(docs)
    out: dict = {}
    seats = {}
    try:
        # (a) three members bootstrap together (no one to hand off from),
        # each ring loaded in process with the series it owns
        t0 = time.perf_counter()
        for k in range(3):
            seats[f"m{k}"] = mesh_seat(dev, store, data, f"m{k}", False, len(docs))
        start_seats(seats.values())
        entries = push_entries(data)
        t1 = time.perf_counter()
        loaded = {w: 0 for w in seats}
        router = seats["m0"].node.router
        for key, t, v, start in entries:
            owner = router.owner_of_series(key)
            seats[owner].ring.push(key, t, v, start=start, record_lag=False)
            loaded[owner] += len(t)
        load_s = time.perf_counter() - t1
        print(f"phase 11: (a) 3 members up in {t1 - t0:.1f} s (warmups included); {len(entries)} series, "
              f"{sum(loaded.values())} samples loaded in process through RingStore.push in {load_s:.1f} s "
              f"(HTTP bulk loads run at 0.6-1.5 M samples/s: PERF.md), by member {loaded}")
        live = [seats[w] for w in ("m0", "m1", "m2")]
        cold = mesh_round("(a) cold", live, store, claims, ref["cold"], fleet_ids)
        warm = mesh_round("(a) warm", live, store, claims, ref["warm"], fleet_ids)
        check(all(t["fallback_reads"] == 0 for t in (*cold.values(), *warm.values())),
              "11(a): a member read history past its ring")
        check(all(t["cold_rows"] == 0 and t["dispatches"] > 0 for t in warm.values()),
              f"11(a): the warm round refit or never dispatched: {warm}")
        print(f"phase 11: (a) cold round: {tick_summary(cold)}; single worker {ref['cold_s']:.3f} s")
        print(f"phase 11: (a) warm round: {tick_summary(warm)}; single worker {ref['warm_s']:.3f} s; no doc claimed "
              f"twice; claim filter {({w: dict(seats[w].node.claim_counts) for w in ('m0', 'm1', 'm2')})}")
        out["a"] = dict(cold=cold, warm=warm)

        # (b) a fourth member joins through the handoff
        seats["m3"] = m3 = mesh_seat(dev, store, data, "m3", True, len(docs))
        t_join = time.perf_counter()
        m3.node.start()
        check(m3.node.joining, "11(b): the joiner was not fenced")
        for s in live:
            s.node.on_tick()
        for s in live:
            check(s.node.wait_handoff_streams(MESH_DEADLINE), "11(b): a sender's stream did not finish")
        streamed_s = time.perf_counter() - t_join
        m3.node.on_tick()
        check(m3.node.state == "active", f"11(b): the joiner did not activate: {m3.node.debug_state()['handoff']}")
        active_s = time.perf_counter() - t_join
        sent = [s.handoff.counters_snapshot() for s in live]
        got = m3.handoff.counters_snapshot()
        check(all(c["send"]["ok"] == 1 and c["send"]["failed"] == 0 for c in sent), f"11(b): sends {sent}")
        series_sent = sum(c["series_sent"] for c in sent)
        fits_sent = sum(c["fits_sent"] for c in sent)
        check((got["series_received"], got["fits_received"]) == (series_sent, fits_sent) and fits_sent > 0,
              f"11(b): received {got} against sent {series_sent} series / {fits_sent} fits")
        m3.worker.tracer = Tracer(service="mesh-joiner")
        join = mesh_round("(b) join", [m3, *live], store, claims, ref["warm"], fleet_ids)
        tracer_stages = dict(m3.worker.tracer.last_stage_seconds)
        j = join["m3"]
        check(j["docs"] > 0 and j["cold_rows"] == 0 and j["fallback_reads"] == 0,
              f"11(b): the joiner's first claims: {j}")
        check(sum(m3.worker._cold_counts.values()) == 0, f"11(b): the joiner read histories {m3.worker._cold_counts}")
        four = [seats[w] for w in ("m0", "m1", "m2", "m3")]
        for s in four:
            resident = {k for i in range(s.ring.shard_count) for k, *_ in s.ring.shard_state(i)}
            check(all(s.node.router.owns_series(k) for k in resident), f"11(b): {s.wid} kept a foreign series")
        print(f"phase 11: (b) planned join: {series_sent} series and {fits_sent} fits sent "
              f"({sum(s.sent_bytes for s in live)} bytes in {sum(c['send']['ok'] for c in sent)} streams), all "
              f"streams landed {streamed_s:.2f} s after the join, active {active_s:.2f} s after it; the joiner's "
              f"first tick: {j['docs']} docs in {j['seconds']:.3f} s, 0 cold-fit rows, 0 fallback history reads, "
              f"0 history reads; its spans {({k: round(v, 4) for k, v in tracer_stages.items()})}; the round: "
              f"{tick_summary(join)}; rings hold only their own partitions after the senders' eviction")
        out["b"] = dict(series=series_sent, fits=fits_sent, bytes=sum(s.sent_bytes for s in live),
                        active_s=active_s, join=join, stages=tracer_stages)

        # (c) m1 drains: it streams its state while the survivors tick
        m1 = seats["m1"]
        quiet = mesh_tick(seats["m0"])  # a survivor's tick with no stream, for comparison
        before = {w: seats[w].handoff.counters_snapshot()["series_received"] for w in ("m0", "m2", "m3")}
        drain_out: dict = {}
        t_drain = time.perf_counter()
        drain = threading.Thread(target=lambda: drain_out.update(m1.node.stream_drain()), name="smoke-drain")
        drain.start()
        claims.clear()
        while not m1.node.draining:
            time.sleep(0.001)
        during = mesh_tick(seats["m0"])
        streaming = drain.is_alive()
        during_rest = {w: mesh_tick(seats[w]) for w in ("m1", "m2", "m3")}
        drain.join(MESH_DEADLINE)
        check(not drain.is_alive() and all(v == "ok" for v in drain_out["targets"].values()),
              f"11(c): the drain stream: {drain_out}")
        stream_s = time.perf_counter() - t_drain
        ids = [i for _, got in claims for i in got]
        check(len(ids) == len(set(ids)) == len(fleet_ids), "11(c): the round under the drain lost or doubled docs")
        got = fleet_written(store)
        check(all(got[i] == ref["warm"][i] for i in fleet_ids), "11(c): writes under the drain differ")
        m1.node.drain()
        survivors = [seats[w] for w in ("m0", "m2", "m3")]
        after = mesh_round("(c) after the drain", survivors, store, claims, ref["warm"], fleet_ids)
        check(all(t["cold_rows"] == 0 and t["fallback_reads"] == 0 for t in after.values()),
              f"11(c): the survivors refit or read history: {after}")
        moved = {w: seats[w].handoff.counters_snapshot()["series_received"] - before[w] for w in before}
        print(f"phase 11: (c) planned drain of m1: {drain_out['targets']}, {m1.handoff.counters_snapshot()['series_sent']} "
              f"series and {m1.handoff.counters_snapshot()['fits_sent']} fits in {stream_s:.2f} s "
              f"({m1.sent_bytes} bytes), received by {moved}; a survivor's tick while the stream was applied "
              f"{during['seconds']:.3f} s ({during['docs']} docs; stream {'still running' if streaming else 'done'} at "
              f"its end) against {quiet['seconds']:.3f} s quiet; the draining member ticked on: "
              f"{during_rest['m1']['docs']} docs; after it left: {tick_summary(after)}")
        out["c"] = dict(during=during, quiet=quiet, after=after, stream_s=stream_s, streaming=streaming)

        # (d) m2 dies: its claims stay in flight and its clock edge skews its
        # lease past expiry; the survivors take the orphans over through the
        # stuck-claim CAS and refit them cold on the f32 route
        m2 = seats["m2"]
        m2.node.on_tick()
        orphans = {d.id for d in store.claim("m2", MESH_STUCK, limit=len(docs) + 16, claim_filter=m2.node.claim_filter)}
        t_claim = time.perf_counter()
        check(orphans, "11(d): the dying member claimed nothing")
        m2.skew()
        m2.node.membership.renew(force=True)  # its last record, stamped three leases back
        survivors = [seats[w] for w in ("m0", "m3")]
        f32 = f32_reference(dev, [d for d in docs if d["id"] in orphans], data)
        time.sleep(max(0.0, t_claim + MESH_STUCK + 1.5 - time.perf_counter()))
        want = {i: (f32["cold"][i] if i in orphans else ref["warm"][i]) for i in fleet_ids}
        launched = K.LAUNCHES["masked_stats"]
        scoring.set_bf16_delta(False)
        try:
            claims.clear()
            death = {s.wid: mesh_tick(s) for s in survivors}
        finally:
            scoring.set_bf16_delta(None)
        launched = K.LAUNCHES["masked_stats"] - launched
        check(launched > 0 or torch.device(dev).type != "cuda", "11(d): the survivors' f32 refits never launched "
                                                                 "masked_stats")
        taken = {i for _, got in claims for i in got}
        check(orphans <= taken, f"11(d): {len(orphans - taken)} orphans were not taken over")
        got = fleet_written(store)
        diff = sorted(i for i in fleet_ids if got[i] != want[i])
        check(not diff, f"11(d): {len(diff)} docs differ from the single workers (f32 for the orphans), e.g. "
                        f"{diff[:1]}: {[got[d] for d in diff[:1]]} against {[want[d] for d in diff[:1]]}")
        check(sum(t["cold_rows"] for t in death.values()) >= len(orphans), f"11(d): the orphans' refits: {death}")
        print(f"phase 11: (d) unplanned death of m2 with {len(orphans)} docs in flight: its lease read expired once "
              f"its clock edge skewed it back {3 * MESH_LEASE:.0f} s; after the {MESH_STUCK:.0f} s stuck window the "
              f"survivors took every orphan over and refit it on the f32 route ({launched} masked_stats launches): "
              f"{tick_summary(death)}; writes equal "
              f"an f32 single worker's for the orphans and the bf16 single worker's for the rest")
        out["d"] = dict(orphans=len(orphans), death=death)

        # (f) a joiner behind a blackholed transfer edge
        plan = FaultPlan(rules=({"edge": "transfer", "error_rate": 1.0},), seed=CHAOS_SEED).activate()
        for s in survivors:
            s.handoff.chaos = plan.edge("transfer")
            s.handoff.backoff_seconds = 0.05
        seats["m4"] = m4 = mesh_seat(dev, store, data, "m4", True, len(docs), deadline=BLACKHOLE_DEADLINE)
        f0 = {s.wid: s.handoff.counters_snapshot()["send"]["failed"] for s in survivors}
        t_join = time.perf_counter()
        m4.node.start()
        check(m4.node.joining, "11(f): the joiner was not fenced")
        while not m4.node.state == "active":
            for s in survivors:
                s.node.on_tick()
            m4.node.on_tick()
            check(time.perf_counter() - t_join < BLACKHOLE_DEADLINE + 30, "11(f): the joiner never activated")
            time.sleep(0.05)
        active_s = time.perf_counter() - t_join
        for s in survivors:
            check(s.node.wait_handoff_streams(60), "11(f): a blackholed stream never ended")
        failed = {s.wid: s.handoff.counters_snapshot()["send"]["failed"] - f0[s.wid] for s in survivors}
        check(all(v == 1 for v in failed.values()), f"11(f): failed sends {failed}")
        moved_ids = {d["id"] for d in docs if m4.node.router.owns_doc(Document.from_json(d))}
        want = {i: (ref["cold"][i] if i in moved_ids else f32["warm"][i] if i in orphans else ref["warm"][i])
                for i in fleet_ids}
        blackholed = mesh_round("(f) blackholed join", [m4, *survivors], store, claims, want, fleet_ids)
        check(blackholed["m4"]["cold_rows"] > 0 and blackholed["m4"]["docs"] == len(moved_ids),
              f"11(f): the joiner's first tick: {blackholed['m4']}")
        for s in survivors:
            s.handoff.chaos = None
        print(f"phase 11: (f) blackholed transfer edge (error_rate 1.0): injections {plan.injections_snapshot()}, "
              f"sends failed {failed}; the joiner went active {active_s:.2f} s after joining (deadline "
              f"{BLACKHOLE_DEADLINE:.0f} s) and cold-refit the {len(moved_ids)} docs that moved to it: "
              f"{tick_summary(blackholed)}; writes unchanged")
        out["f"] = dict(active_s=active_s, blackholed=blackholed, moved=len(moved_ids))
        return out
    finally:
        stop_seats(seats.values())


def f32_reference(dev, docs, data) -> dict:
    """A single card worker over `docs` on the f32 route
    (FOREMAST_BF16_DELTA=0): cold, then warm."""
    from foremast_tpu_torch.engine import scoring

    scoring.set_bf16_delta(False)
    try:
        return single_mesh_reference(dev, docs, data)
    finally:
        scoring.set_bf16_delta(None)


def frame_post(address, entries):
    """A RoutingPusher transport that carries FMW1 frames, so 64
    histories of 10,080 points fit the receiver's body cap (JSON would
    not)."""
    import urllib.request

    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, encode_frame

    body = encode_frame([(e["alias"], np.asarray(e["times"], np.int64), np.asarray(e["values"], np.float32),
                          e.get("start")) for e in entries])
    req = urllib.request.Request(f"http://{address}/api/v1/write", data=body, method="POST",
                                 headers={"Content-Type": BINARY_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def mesh_ingest_arm(dev, docs, data, ref: dict) -> dict:
    """(e): three fresh members with empty rings; a RoutingPusher pushes
    the docs' series to one seed member over HTTP. Cycle 1 sends the
    current windows through the pusher as it is (its JSON POST) and learns
    every owner from the hints; cycle 2 sends the full histories straight
    to the owners, the same pusher with its transport swapped for FMW1
    frames (`frame_post`: JSON histories would pass the body cap). After
    evict_unowned each ring holds only its own partition, and the members'
    cold ticks write what the pull path writes, with 0 fallback
    requests."""
    from foremast_tpu_torch.mesh import RoutingPusher

    store, claims, fleet_ids = mesh_store(docs)
    data = {u: data[u] for u in doc_urls(docs)}
    seats = [mesh_seat(dev, store, data, f"e{k}", False, len(docs)) for k in range(3)]
    try:
        start_seats(seats)
        entries = push_entries(data)
        pusher = RoutingPusher([seats[0].node.membership.ingest_address], timeout=120, retries=0)
        t0 = time.perf_counter()
        first = pusher.push_cycle([(k, t[-FULL_TC:].tolist(), v[-FULL_TC:].tolist(), None) for k, t, v, _ in entries])
        t1 = time.perf_counter()
        pusher._post = frame_post  # cycle 2: the routes learned above, histories as frames
        foreign = sum(1 for k, *_ in entries if not seats[0].node.router.owns_series(k))
        check(first["errors"] == 0 and first["redirects"] == foreign > 0,
              f"11(e): the first cycle learned {first['redirects']} routes for {foreign} foreign series")
        redirects = samples = 0
        for i in range(0, len(entries), MESH_PUSH_SERIES):
            r = pusher.push_cycle(entries[i: i + MESH_PUSH_SERIES])
            check(r["errors"] == 0, f"11(e): a push failed: {r}")
            redirects += r["redirects"]
            samples += r["accepted"]
        push_s = time.perf_counter() - t1
        check(redirects == 0, f"11(e): {redirects} hints after the first cycle: it did not converge")
        evicted = {s.wid: s.ring.evict_unowned(s.node._retains) for s in seats}
        for s in seats:
            resident = {k for i in range(s.ring.shard_count) for k, *_ in s.ring.shard_state(i)}
            owned = {k for k, *_ in entries if s.node.router.owns_series(k)}
            check(resident == owned, f"11(e): {s.wid}'s ring holds {len(resident)} series, it owns {len(owned)}")
        ticks = mesh_round("(e) pushed", seats, store, claims, ref, fleet_ids)
        check(all(s.fallback.reads == 0 for s in seats), "11(e): a member asked the fallback")
        print(f"phase 11: (e) routed ingest of {len(docs)} docs: cycle 1 ({len(entries)} current windows to one seed, "
              f"RoutingPusher's JSON POST) in {t1 - t0:.2f} s learned {first['redirects']} routes from hints; cycle 2 ({samples} samples of full "
              f"histories as FMW1 frames, {MESH_PUSH_SERIES} series a call) in {push_s:.1f} s landed with 0 hints; evict_unowned "
              f"dropped {evicted} (cycle 1's foreign windows at the seed), each ring now holds exactly its partition; "
              f"cold round {tick_summary(ticks)}; writes equal the pull path's, 0 fallback requests")
        return dict(first=first, push_s=push_s, evicted=evicted, ticks=ticks)
    finally:
        stop_seats(seats)


def mesh_cli_arm(dev, docs, data, ref: dict, workdir: str) -> dict:
    """(g): two `python3 -m foremast_tpu_torch worker` processes with
    FOREMAST_MESH=1 and FOREMAST_INGEST=1 on the one card, against the fake
    Elasticsearch and Prometheus (tests/torch_fake_services.py). The
    second joins through the first; the fleet's series are pushed to the
    first, which hints the second's share, and go again to the second;
    together they judge the fleet to the single worker's writes, and both
    show on the first receiver's /debug/state. After SIGTERM the second
    drains its state to the first and leaves, and the first judges the
    whole fleet again with every tick on the warm path."""
    import signal
    import urllib.request

    from foremast_tpu_torch.ingest import BINARY_CONTENT_TYPE, encode_frame
    from foremast_tpu_torch.mesh import MESH_APP

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    procs, logs = {}, {}
    fleet_ids = {d["id"] for d in docs}

    def fleet_es():
        return {k: v for k, v in es_written(es.sources()).items() if k in fleet_ids}

    def judged(base) -> bool:
        with es.lock:
            return all(es.writes[k] >= base.get(k, 0) + 2
                       and es.docs[k]["_source"].get("status") not in ("initial", "preprocess_inprogress")
                       for k in fleet_ids)

    def state(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/state", timeout=30) as resp:
            return json.loads(resp.read())

    def wait(cond, what, timeout=CLI_TIMEOUT):
        t0 = time.perf_counter()
        while not cond():
            for tag, p in procs.items():
                if p.poll() is not None:
                    print(open(logs[tag]).read()[-20000:], file=sys.stderr)
                    check(False, f"11(g): CLI {tag} exited {p.returncode} while waiting for {what}")
            check(time.perf_counter() - t0 < timeout, f"11(g): timed out waiting for {what}")
            time.sleep(0.2)
        return time.perf_counter() - t0

    def records(tag, offset=0):
        out = []
        with open(logs[tag]) as fh:
            fh.seek(offset)
            for line in fh:
                if line.startswith("{"):
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        pass
        return out

    try:
        data = {u: data[u] for u in doc_urls(docs)}
        rdocs, keyed = rebase(docs, data, "http://prom", prom_url)
        prom.data = keyed  # the fallback, never asked
        entries = push_entries(data)
        ports = {"A": free_port(), "B": free_port()}
        t0 = time.perf_counter()
        for tag in ("A", "B"):
            env = dict(os.environ, PYTHONPATH=ROOT, FOREMAST_MESH="1", FOREMAST_INGEST="1",
                       FOREMAST_INGEST_PORT=str(ports[tag]), FOREMAST_MESH_ADVERTISE="127.0.0.1",
                       FOREMAST_INGEST_BUDGET_BYTES=str(PUSH_BUDGET_BYTES), MAX_CACHE_SIZE=str(4 * len(docs) + 64))
            logs[tag] = os.path.join(workdir, f"cli-mesh-{tag}.err")
            with open(logs[tag], "w") as err:
                procs[tag] = subprocess.Popen(
                    [sys.executable, "-m", "foremast_tpu_torch", "worker", "--device", str(dev), "--elastic-url",
                     es_url, "--claim-limit", str(DEPLOY_CLAIM), "--gauge-port", "0", "--poll", "0.2"],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
            wait(lambda tag=tag: any(r.get("msg") == "worker started" for r in records(tag)), f"{tag} to start")
        started = {tag: next(r for r in records(tag) if r.get("msg") == "worker started") for tag in procs}
        check(started["A"]["mesh_state"] == "active" and started["B"]["mesh_state"] == "joining",
              f"11(g): start states {({t: r.get('mesh_state') for t, r in started.items()})}")
        wait(lambda: sorted(state(ports["A"]).get("mesh", {}).get("members", {}).values()) == ["active", "active"],
             "both members active on A's /debug/state")
        members = state(ports["A"])["mesh"]
        # push every series to A; A accepts all and hints B's share, which
        # then goes to B
        hints: dict = {}
        t1 = time.perf_counter()
        for i in range(0, len(entries), PUSH_BODY_SERIES):
            req = urllib.request.Request(f"http://127.0.0.1:{ports['A']}/api/v1/write",
                                         data=encode_frame(entries[i: i + PUSH_BODY_SERIES]), method="POST",
                                         headers={"Content-Type": BINARY_CONTENT_TYPE})
            with urllib.request.urlopen(req, timeout=120) as resp:
                hints.update(json.loads(resp.read()).get("redirects") or {})
        check(hints and set(hints.values()) == {f"127.0.0.1:{ports['B']}"}, f"11(g): hints {set(hints.values())}")
        to_b = [e for e in entries if e[0] in hints]
        push_s, pushed_b, _ = push_frames(f"http://127.0.0.1:{ports['B']}/api/v1/write", to_b)
        push_s = time.perf_counter() - t1
        base = dict(es.writes)
        es.load(rdocs)
        judge_s = wait(lambda: judged(base), "the two members to judge the fleet")
        got = fleet_es()
        # the re-check loop re-judges as it goes: a doc's last write is its
        # cold or a warm one (which this fleet's single worker writes alike)
        diff = sorted(i for i in fleet_ids if got[i] not in (ref["cold"][i], ref["warm"][i]))
        check(not diff, f"11(g): the two CLIs' writes differ from the single worker's on {len(diff)} docs")
        seats = {k: v for k, v in es.sources().items() if v.get("appName") == MESH_APP}
        check(len(seats) == 2 and all(v["status"] == "mesh_member" for v in seats.values()), "11(g): member records")
        # SIGTERM B: it drains its partition to A and leaves
        offset = os.path.getsize(logs["A"])
        t2 = time.perf_counter()
        procs["B"].send_signal(signal.SIGTERM)
        rc_b = procs["B"].wait(timeout=120)
        drain_s = time.perf_counter() - t2
        check(rc_b == 0, f"11(g): B exited {rc_b} on SIGTERM")
        del procs["B"]
        stop_b = [r for r in records("B") if r.get("msg") == "worker stopped"][-1]
        wait(lambda: list(state(ports["A"])["mesh"]["members"]) == [members["worker_id"]], "B to leave A's view")
        es.set_status(None)
        base = dict(es.writes)
        rejudge_s = wait(lambda: judged(base), "A to judge the whole fleet")
        got = fleet_es()
        diff = sorted(i for i in fleet_ids if got[i] != ref["warm"][i])
        check(not diff, f"11(g): A's writes after the drain differ on {len(diff)} docs")
        ticks = [r for r in records("A", offset) if r.get("msg") == "tick complete" and r.get("docs")]
        check(ticks and all(r["fast_path"] == r["docs"] for r in ticks),
              f"11(g): A refit after the drain: {[(r['docs'], r['fast_path']) for r in ticks if r['fast_path'] != r['docs']][:5]}")
        a_state = state(ports["A"])
        procs["A"].send_signal(signal.SIGTERM)
        rc_a = procs["A"].wait(timeout=120)
        check(rc_a == 0, f"11(g): A exited {rc_a} on SIGTERM")
        del procs["A"]
        stop_a = [r for r in records("A") if r.get("msg") == "worker stopped"][-1]
        recv = a_state["handoff"]
        check(recv["fits_received"] > 0 and recv["series_received"] > 0, f"11(g): A received {recv}")
        check(sum(prom.requests.values()) == 0, f"11(g): the CLIs asked Prometheus {dict(prom.requests)}")
        print(f"phase 11: (g) two CLI mesh workers (FOREMAST_MESH=1, FOREMAST_INGEST=1) on the card: B joined "
              f"fenced behind A; A's receiver /debug/state showed members {members['members']}; {len(entries)} "
              f"series pushed to A ({len(hints)} hinted to B, {pushed_b} samples re-pushed there) in {push_s:.1f} s; "
              f"the fleet of {len(docs)} docs judged in {judge_s:.1f} s, writes equal the single worker's; B's "
              f"SIGTERM drain {drain_s:.1f} s to exit 0 (sent {stop_b['mesh']['handoff']['series_sent']} series, "
              f"{stop_b['mesh']['handoff']['fits_sent']} fits); A then judged the whole fleet in {rejudge_s:.1f} s, "
              f"{sum(r['docs'] for r in ticks)} docs over {len(ticks)} ticks, every one on the warm path (0 cold "
              f"refits); A received {recv['series_received']} series, {recv['fits_received']} fits; 0 Prometheus "
              f"requests; A's claim filter {stop_a['mesh']['claim_docs']}; both exit 0; "
              f"{time.perf_counter() - t0:.1f} s in all")
        return dict(judge_s=judge_s, drain_s=drain_s, rejudge_s=rejudge_s)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for s in (prom_srv, es_srv):
            s.shutdown()
            s.server_close()


def phase_mesh(dev, smi: str) -> dict:
    """Phase 11: the worker mesh on the card, every member a BrainWorker on
    `dev` over phase 6's fleet (labelled), each arm's writes held to a
    single card worker's on the same fleet."""
    import tempfile

    t_now = int(time.time()) - 600  # settled histories, for the CLI's real clock too
    t0 = time.perf_counter()
    docs, data, _ = worker_fleet(MESH_DOCS, t_now, labelled=True)
    ref = single_mesh_reference(dev, docs, data)
    t1 = time.perf_counter()
    same = sum(ref["cold"][i] == ref["warm"][i] for i in ref["cold"])
    print(f"phase 11: fleet of {MESH_DOCS} docs x {len(ALIASES)} aliases (Th={FULL_TH}, Tc={FULL_TC}, half canaries, "
          f"`app` the route label) and the single card worker's cold and warm ticks "
          f"({ref['cold_s']:.3f} s, {ref['warm_s']:.3f} s; {same} of {len(docs)} docs written alike by both) in "
          f"{t1 - t0:.1f} s; {smi}")
    arms = mesh_partition_arms(dev, docs, data, ref)
    t2 = time.perf_counter()
    ids = [d["id"] for d in docs[:MESH_INGEST_DOCS]]
    ingest = mesh_ingest_arm(dev, docs[:MESH_INGEST_DOCS], data, {i: ref["cold"][i] for i in ids})
    t3 = time.perf_counter()
    ids = [d["id"] for d in docs[:MESH_CLI_DOCS]]
    with tempfile.TemporaryDirectory(prefix="foremast-phase11-", ignore_cleanup_errors=True) as workdir:
        cli = mesh_cli_arm(dev, docs[:MESH_CLI_DOCS], data, {k: {i: ref[k][i] for i in ids} for k in ("cold", "warm")},
                           workdir)
    print(f"phase 11: seconds: fleet and single worker {t1 - t0:.1f}, (a)-(d) and (f) {t2 - t1:.1f}, (e) "
          f"{t3 - t2:.1f}, (g) {time.perf_counter() - t3:.1f}")
    return dict(arms=arms, ingest=ingest, cli=cli)


# -- phase 12: the device mesh of one process -----------------------------------

MESH_BLOCKS = 4  # data-axis blocks of phase 12's meshes (the one card listed 4 times)
MESH_WORKER_DOCS = WORKER_DOCS  # (a): phase 6's fleet, 4,096 docs x 4 aliases
MESH_OBJ_TASKS = FLEET  # (b): 4,096 tasks on the object path
MESH_JOINT_DOCS = 256  # (d): 128 bivariate + 128 LSTM docs at m=1440
CP_B, CP_TH = 4096, 40320  # (e): 28 days at 1-minute steps, over a 1 x 4 mesh
CP_EWMA_B = 512  # (e): rows of sharded_ewma against ewma_levels
CP_TOL = {"upper": 1e-4, "season": 2e-4, "level": 2e-4, "scale": 2e-3, "ewma": 2e-4}


@contextlib.contextmanager
def uncounted():
    """The launches inside are a single-device reference's, not the mesh
    path's: the counts are restored after (a check inside still reads
    its own deltas)."""
    from foremast_tpu_torch.ops import kernels as K

    saved = dict(K.LAUNCHES)
    try:
        yield
    finally:
        K.LAUNCHES.update(saved)


def card_ops(fn):
    """(fn(), device operations it issued): aten calls that are not views
    (each one kernel or copy at most), plus the hand-written kernels'
    launches. An upper bound of the launches of a dispatch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from foremast_tpu_torch.ops import kernels as K

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                n[0] += 1
            return func(*args, **(kwargs or {}))

    before = dict(K.LAUNCHES)
    with Count():
        out = fn()
    return out, n[0] + sum(K.LAUNCHES[k] - v for k, v in before.items())


def mesh_recorder(rec: dict):
    """`run_worker_ticks` hook: keep the worker, record every verdict's
    bands as bytes (on_verdict), and every columnar dispatch's call."""

    def hook(worker, store):
        rec["worker"] = worker
        bands = rec["bands"] = []
        calls = rec["calls"] = []

        def on_verdict(doc, verdicts):
            bands.extend(
                (doc.id, v.alias, int(v.verdict), tuple(v.anomaly_pairs),
                 np.asarray(v.upper, np.float32).tobytes(), np.asarray(v.lower, np.float32).tobytes())
                for v in verdicts
            )

        worker.on_verdict = on_verdict
        orig = worker._uni.judge_columnar_async
        worker._uni.judge_columnar_async = lambda *a, **kw: calls.append((a, kw)) or orig(*a, **kw)

    return hook


def mesh_worker_arm(dev, mesh, docs, data, latency, t_now: int, single=None) -> dict:
    """12(a): the sharded-arena worker and the replicated one over `mesh`,
    and (unless given) the single-device worker, through phase 6's ticks;
    writes, hook bands and fit-key sets equal in bytes, arena blocks of
    capacity / n_data rows, f32 cold masked_stats launches n_data times
    the single worker's."""
    import torch

    from foremast_tpu_torch.models.cache import is_pad_fit_key
    from foremast_tpu_torch.parallel import mesh as meshlib
    from foremast_tpu_torch.parallel.mesh import Blocks, tree_leaves

    n = mesh.shape["data"]
    runs = {}
    arms = [("sharded", mesh, "1"), ("replicated", mesh, "0")]
    if single is None:
        arms.append(("single", None, "1"))
    else:
        runs["single"] = single
    for name, m, sharded in arms:
        os.environ["FOREMAST_ARENA_SHARDED"] = sharded
        rec = {}
        try:
            with uncounted() if m is None else contextlib.nullcontext():
                ticks = run_worker_ticks(dev, docs, data, latency, t_now, hook=mesh_recorder(rec), device_mesh=m)
        finally:
            os.environ.pop("FOREMAST_ARENA_SHARDED", None)
        w = rec.pop("worker")
        rec["fit_keys"] = sorted(repr(k) for k in w._fit_cache._d if not is_pad_fit_key(k))
        rec["mesh"] = w._device_mesh_state()
        rec["arenas"] = [(a.shards, a.cap, a.cap_s, [[p.shape[0] for p in leaf.parts] if isinstance(leaf, Blocks)
                          else [leaf.shape[0]] for leaf in tree_leaves(a.state)]) for a in w._uni._arenas.values()]
        rec["judge"] = w._uni
        rec["ticks"] = ticks
        runs[name] = rec
    ref = runs["single"]
    for name in ("sharded", "replicated"):
        got = runs[name]
        for t in "abcd":
            diff = [k for k, v in ref["ticks"][t]["written"].items() if got["ticks"][t]["written"].get(k) != v]
            check(not diff, f"12(a) {name} tick ({t}): {len(diff)} docs differ from the single worker, e.g. {diff[:2]}")
        check(sorted(got["bands"]) == sorted(ref["bands"]), f"12(a) {name}: the hook verdicts or bands differ")
        check(got["fit_keys"] == ref["fit_keys"], f"12(a) {name}: the fit-cache keys differ")
        ms = got["ticks"]["d"]["launched"]["masked_stats"]
        want = n * ref["ticks"]["d"]["launched"]["masked_stats"]
        check((ms == want and ms > 0) or torch.device(dev).type == "cpu",
              f"12(a) {name}: the f32 cold tick launched masked_stats {ms} times, want {want}")
        check(got["mesh"] is not None and got["mesh"]["pad_rows_total"] >= 0 and got["mesh"]["place_calls"] > 0,
              f"12(a) {name}: no device-mesh state {got['mesh']}")
    # block i's part is its device's buffer: the device's blocks of
    # capacity/n rows each, end to end (all n on a one-card mesh)
    _, part, _ = meshlib.device_slots(mesh.data_devices)
    held = [part.count(p) for p in part]
    for shards, cap, cap_s, leaves in runs["sharded"]["arenas"]:
        check(shards == n and cap == n * cap_s and all(parts == [k * cap_s for k in held] for parts in leaves),
              f"12(a) a sharded arena is not {n} blocks of capacity/{n} rows: {cap}, {cap_s}, {leaves[:2]}")
    for shards, cap, _, leaves in runs["replicated"]["arenas"]:
        check(shards == 1 and all(parts == [cap] * n for parts in leaves),
              f"12(a) a replicated arena is not a whole replica per device: {cap}, {leaves[:2]}")
    spiked = ref["ticks"]["spiked"]
    unhealthy = [k for k, v in ref["ticks"]["c"]["written"].items() if json.loads(v)[0] == "completed_unhealth"]
    check(sorted(unhealthy) == sorted(spiked), f"12(a) the spiked tick flagged {len(unhealthy)} docs, want "
                                                f"{len(spiked)}")
    return runs


def report_worker_arm(label: str, runs: dict, smi: str) -> None:
    ref = runs["single"]["ticks"]
    for name in ("sharded", "replicated"):
        r = runs[name]
        dm = r["mesh"]
        print(f"phase 12: (a) {label}, {name} arena: ticks (cold, warm, spiked warm, f32 cold of {F32_DOCS} docs) "
              + ", ".join(f"{r['ticks'][t]['seconds']:.3f} s (single {ref[t]['seconds']:.3f})" for t in "abcd")
              + f"; padded-row fraction {dm['padded_row_fraction']}, place {dm['place_seconds']} s / "
              f"{dm['place_bytes']} B in {dm['place_calls']} calls, fetch {dm['fetch_seconds']} s / "
              f"{dm['fetch_bytes']} B; arena {dm['arena_layout']}, {dm['arena_capacity_rows']} rows "
              f"(blocks x rows a block: {[(a[0], a[2]) for a in r['arenas']]}), {dm['arena_replica_bytes']} B a "
              f"block; f32 cold masked_stats launches "
              f"{r['ticks']['d']['launched']['masked_stats']} (single {ref['d']['launched']['masked_stats']}) "
              f"on {'; '.join(smi.splitlines())}")


def mesh_dispatch_arm(dev, label: str, runs: dict) -> dict:
    """12(c): the sharded worker's warm columnar dispatches (each bucket
    of its last tick: the plain one and the canary one with the rank
    tests) again, behind a busy kernel under
    set_sync_debug_mode("error"), the results equal to the synchronous
    call's; their device operations beside the single worker's same
    calls."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    out = {}
    for name in ("sharded", "single"):
        rec = runs[name]
        for bucket, (a, kw) in (("plain", _bucket_call(rec, False)), ("canary", _bucket_call(rec, True))):
            with uncounted() if name == "single" else contextlib.nullcontext():
                out[(name, bucket)] = _dispatch_checked(rec["judge"], a, kw, cuda, f"12(c) {name} {bucket}")
    # the launch queue is a device's: its share of the operations must
    # stay well under ~1,000 (one call a device: the total over its cards)
    cards = len({str(d) for d in runs["sharded"]["judge"].mesh.data_devices})
    lines = []
    for bucket in ("plain", "canary"):
        s, p = out[("sharded", bucket)], out[("single", bucket)]
        check(s["ops"] / cards < 1000,
              f"12(c): the sharded {bucket} dispatch issued {s['ops']} device operations over {cards} device(s)")
        lines.append(
            f"{bucket} bucket ({s['rows']} rows): {s['ops']} device operations over {cards} device(s) (single "
            f"device {p['ops']})"
            + (f", behind a {s['busy_ms']:.1f} ms busy kernel returned after {s['dispatch_s'] * 1e3:.3f} ms (single "
               f"{p['dispatch_s'] * 1e3:.3f} ms; on an idle stream {s['idle_s'] * 1e3:.3f} / {p['idle_s'] * 1e3:.3f} "
               f"ms)" if cuda else "")
        )
    print(f"phase 12: (c) {label}, the warm columnar dispatches: " + "; ".join(lines)
          + ("; under set_sync_debug_mode(\"error\"), results equal the synchronous calls'" if cuda else ""))
    return out


def _bucket_call(rec: dict, canary: bool):
    """The last columnar call of a worker's run for one bucket."""
    calls = [c for c in rec["calls"] if (c[1].get("base_values") is not None) == canary]
    check(calls, f"12(c): no {'canary' if canary else 'plain'} columnar call was recorded")
    return calls[-1]


def _dispatch_checked(judge, a, kw, cuda: bool, what: str) -> dict:
    """One columnar dispatch counted (device operations), then again
    behind a busy kernel under set_sync_debug_mode("error")."""
    import torch

    want = judge.judge_columnar(*a, **kw)
    pending, ops = card_ops(lambda: judge.judge_columnar_async(*a, **kw))
    pending.wait()
    row = dict(rows=a[0].shape[0], ops=ops)
    if cuda:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        judge.judge_columnar_async(*a, **kw).wait()
        row["idle_s"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        busy = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        busy[0].record()
        torch.cuda._sleep(BUSY_CYCLES)
        busy[1].record()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = judge.judge_columnar_async(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row["dispatch_s"] = time.perf_counter() - t1
        row["done"] = pending.dev.done()
        got = pending.wait()
        row["busy_ms"] = busy[0].elapsed_time(busy[1])
        check(not row["done"] and row["dispatch_s"] * 1e3 < row["busy_ms"],
              f"{what}: the dispatch waited for the device ({row})")
        for g, w in zip(got, want):
            check((g is None and w is None) or np.array_equal(g, w), f"{what}: the async results differ")
    return row


def mesh_object_arm(dev, mesh) -> dict:
    """12(b): ShardedJudge.judge with no fit cache on MESH_OBJ_TASKS tasks
    (f32 histories: ma_judgment), and the bf16-delta judgment of a
    throughput batch placed by the same judge (ma_judgment_bf16_delta),
    each against the single judge: equal verdicts, bands equal in bytes,
    one launch per block."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import HealthJudge
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.parallel import ShardedJudge, per_block, throughput_batch

    n = mesh.shape["data"]
    cuda = torch.device(dev).type == "cuda"
    tasks, spiked = fleet_tasks(MESH_OBJ_TASKS)
    out = {}
    for name, judge in (("sharded", ShardedJudge(BrainConfig(), mesh=mesh)), ("single", HealthJudge(BrainConfig(),
                                                                                                      device=dev))):
        with uncounted() if name == "single" else contextlib.nullcontext():
            before = K.LAUNCHES["ma_judgment"]
            t1 = time.perf_counter()
            vs = judge.judge(tasks)
            out[name] = dict(verdicts=vs, seconds=time.perf_counter() - t1,
                             launches=K.LAUNCHES["ma_judgment"] - before)
    same_verdicts(out["sharded"]["verdicts"], out["single"]["verdicts"], "12(b) f32")
    for g, w in zip(out["sharded"]["verdicts"], out["single"]["verdicts"]):
        check(g.upper.tobytes() == w.upper.tobytes(), f"12(b): the band of {g.job_id} differs in bytes")
    flagged = [i for i, v in enumerate(out["sharded"]["verdicts"]) if v.verdict == 1]
    check(out["sharded"]["launches"] == n * out["single"]["launches"] or not cuda,
          f"12(b): ma_judgment launched {out['sharded']['launches']} times, single {out['single']['launches']}")
    judge = ShardedJudge(BrainConfig(), mesh=mesh)
    batch = throughput_batch(MESH_OBJ_TASKS, FULL_TH, FULL_TC, device=dev)
    slim, anchor, delta = scoring.make_bf16_delta_batch(batch)
    before = K.LAUNCHES["ma_judgment_bf16_delta"]
    res = per_block(scoring.score_bf16_delta, *judge._place((slim, anchor, delta)))
    l16 = K.LAUNCHES["ma_judgment_bf16_delta"] - before
    with uncounted():
        ref = scoring.score_bf16_delta(slim, anchor, delta)
        l16_single = K.LAUNCHES["ma_judgment_bf16_delta"] - before - l16
    for field in ("verdict", "anomalies", "upper", "lower", "p_value"):
        check(torch.equal(getattr(res, field).gather(dev), getattr(ref, field)), f"12(b) bf16-delta: {field} differs")
    check(l16 == n * l16_single or not cuda, f"12(b): ma_judgment_bf16_delta launched {l16}, single {l16_single}")
    print(f"phase 12: (b) ShardedJudge.judge (no fit cache, f32) of {MESH_OBJ_TASKS} tasks: verdicts, pairs and bands "
          f"equal the single judge's ({len(flagged)} flagged, {int(spiked.sum())} spiked), "
          f"{out['sharded']['seconds']:.3f} s (single "
          f"{out['single']['seconds']:.3f} s), ma_judgment launches {out['sharded']['launches']} (single "
          f"{out['single']['launches']}); the bf16-delta judgment placed by the same judge equals the single one bit "
          f"for bit, ma_judgment_bf16_delta launches {l16} (single {l16_single})")
    return dict(f32=out["sharded"]["launches"], bf16=l16)


def mesh_joint_arm(dev, mesh, t_now: int) -> dict:
    """12(d): the joint fleet (bivariate and LSTM docs at m=1440) through
    the sharded joint arenas: a mesh worker and the single-device worker
    given its trained LSTM entries, cold, warm and spiked warm ticks;
    every doc's writes equal, the warm ticks on the joint columnar path
    with 0 trainings, exactly the spiked docs flagged (as 8(d) checks)."""
    import torch

    from foremast_tpu_torch.ops import kernels as K

    n_docs = MESH_JOINT_DOCS
    docs, data = joint_worker_fleet(n_docs, t_now)
    gw, gstore = joint_worker(docs, data, dev, device_mesh=mesh)
    sw, sstore = joint_worker(docs, data, dev, device_mesh=None)
    gw.judge.lstm_steps = sw.judge.lstm_steps = 20

    def written(store):
        return {d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
                for d in store._docs.values()}

    out = {}

    def tick(name, now):
        launches = dict(K.LAUNCHES)
        versions = gw._mvj.cache.version
        t1 = time.perf_counter()
        n = gw.tick(now=now)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launched = {k: K.LAUNCHES[k] - v for k, v in launches.items()}
        if name == "a":
            for key, entry in gw._mvj.cache.snapshot().items():
                if key[0] == "lstm":
                    sw._mvj.cache.put(key, entry)
        t1 = time.perf_counter()
        with uncounted():
            sn = sw.tick(now=now)
        out[name] = dict(docs=n, single_docs=sn, seconds=seconds, single_seconds=time.perf_counter() - t1,
                         written=written(gstore), single_written=written(sstore), launched=launched,
                         fast=dict(gw._fast_kinds), refit=gw._mvj.cache.version != versions)

    tick("a", t_now + 150)
    tick("b", t_now + 200)
    spiked = [i for i in range(n_docs) if i % 16 in (5, 12)]
    for w in (gw, sw):
        for i in spiked:
            f = 4 if i % 2 else 2
            for m in range(f):
                url = f"http://prom/cur?q=m{m}:app{i}&step=60"
                ct, cv = w.source.data[url]
                v = cv.copy()
                v[-3:] += 0.6 if (f == 4 or m == 0) else -0.6
                w.source.data[url] = (ct, v)
    tick("c", t_now + 250)
    for name in "abc":
        t = out[name]
        diff = [k for k, v in t["single_written"].items() if t["written"][k] != v]
        check(not diff and t["docs"] == t["single_docs"], f"12(d) ({name}): {len(diff)} docs differ, e.g. {diff[:2]}")

    def unhealthy(t):
        return {int(k[4:]) for k, v in t["written"].items() if json.loads(v)[0] == "completed_unhealth"}

    alarms = unhealthy(out["a"])
    check(unhealthy(out["c"]) == alarms | set(spiked), "12(d) (c) did not flag exactly the spiked docs")
    for name in "bc":
        t = out[name]
        check(not t["refit"] and t["launched"]["lstm_ae_backward"] == 0
              and (t["launched"]["lstm_ae_forward"] > 0 or torch.device(dev).type == "cpu"),
              f"12(d) ({name}): the warm tick trained, or never scored on the card: {t['launched']}")
        check(t["fast"]["bivariate"] > 0 and t["fast"]["lstm"] > 0, f"12(d) ({name}): kinds {t['fast']}")
    arenas = list(gw._mvj._joint_arenas.values())
    n = mesh.shape["data"]
    check(arenas and all(a.shards == n and a.cap == n * a.cap_s for a in arenas), "12(d): the joint arenas are not "
                                                                                    "sharded")
    print(f"phase 12: (d) joint fleet of {n_docs} docs (m={SEASON}): cold / warm / spiked warm "
          + ", ".join(f"{out[t]['seconds']:.3f} s (single {out[t]['single_seconds']:.3f})" for t in "abc")
          + f"; writes equal the single-device worker's (its LSTM entries carried); {len(alarms)} cold false alarms; "
          f"(c) flagged exactly the spiked open docs; joint arenas {[(a.cap, a.cap_s) for a in arenas]}")
    return out


def mesh_context_arm(dev, devices) -> dict:
    """12(e): context parallelism over a 1 x MESH_BLOCKS mesh: CP_B rows
    at CP_TH steps (28 days of 1-minute steps, a burst each day) with
    gaps, judged by score_time_sharded for moving_average_all and
    phase_means (m=1440), held to scoring.score and to fit_forecast +
    score_from_state on one device; sharded_ewma held to ewma_levels."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.ops.forecasters import ewma_levels
    from foremast_tpu_torch.ops.windows import MetricWindows
    from foremast_tpu_torch.parallel import make_mesh, score_time_sharded, sharded_ewma, sharded_phase_means

    mesh = make_mesh(n_data=1, n_model=MESH_BLOCKS, devices=devices)
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    g = torch.Generator(device=dev).manual_seed(12)
    b, th, tc, m = CP_B, CP_TH, FULL_TC, SEASON
    # a daily burst half a day away from the current window's phases
    burst = max(2, m // 24)

    def daily(steps):
        return 2.0 * (((steps % m) >= m // 2) & ((steps % m) < m // 2 + burst)).float()

    t = torch.arange(th, device=dev)
    hv = 5.0 + daily(t) + 0.1 * torch.randn((b, th), generator=g, device=dev)
    hm = torch.rand((b, th), generator=g, device=dev) > 0.02
    tcur = th + torch.arange(tc, device=dev)
    cv = 5.0 + daily(tcur) + 0.02 * torch.randn((b, tc), generator=g, device=dev)
    spiked = torch.arange(b, device=dev) % 16 == 5
    cv[spiked, tc // 2] += 3.0
    zeros = torch.zeros((b, tc), device=dev)
    batch = scoring.ScoreBatch(
        historical=MetricWindows(values=hv, mask=hm, times=None),
        current=MetricWindows(values=cv, mask=torch.ones((b, tc), dtype=torch.bool, device=dev), times=None),
        baseline=MetricWindows(values=zeros, mask=zeros.bool(), times=None),
        threshold=torch.full((b,), 4.0, device=dev),
        bound=torch.full((b,), 1, dtype=torch.int32, device=dev),
        min_lower_bound=torch.zeros(b, device=dev),
        min_points=torch.full((b,), 10, dtype=torch.int32, device=dev),
    )
    cfg = BrainConfig(season_steps=m)
    out = {}

    def timed(fn):
        sync()
        t1 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t1

    def same(res, ref, tol, what):
        for field in ("verdict", "anomalies"):
            check(torch.equal(res_field(res, field), getattr(ref, field)), f"12(e) {what}: {field} differs")
        err = float((res_field(res, "upper") - ref.upper).abs().max())
        check(err <= tol * (1 + float(ref.upper.abs().max())), f"12(e) {what}: upper off by {err}")
        return err

    def res_field(res, field):
        return getattr(res, field).gather(dev)

    with uncounted():
        ref, ref_s = timed(lambda: scoring.score(batch))
    res, res_s = timed(lambda: score_time_sharded(batch, mesh, cfg))
    out["ma"] = dict(err=same(res, ref, CP_TOL["upper"], "moving_average_all"), seconds=res_s, single_seconds=ref_s,
                     flagged=int((res_field(res, "verdict") == 1).sum()))
    check(torch.equal(res_field(res, "verdict") == 1, spiked), "12(e) moving_average_all: not the spiked rows")

    def single_pm():
        fc = scoring.fit_forecast(hv, hm, algorithm="phase_means", season_length=m)
        return fc, scoring.score_from_state(batch, fc.level, fc.trend, fc.season, fc.season_phase, fc.scale,
                                            hm.sum(-1, dtype=torch.int32))

    with uncounted():
        (fc, ref), ref_s = timed(single_pm)
    res, res_s = timed(lambda: score_time_sharded(batch, mesh, cfg, algorithm="phase_means"))
    season, level, trend, scale, phase, n_hist = sharded_phase_means(hv, hm, m, mesh)
    errs = {}
    for what, got, want in (("season", season, fc.season), ("level", level, fc.level), ("scale", scale, fc.scale)):
        got = got.gather(dev)
        errs[what] = float(((got - want).abs() / (1 + want.abs())).max())
        check(errs[what] <= CP_TOL[what], f"12(e) phase_means {what}: relative error {errs[what]}")
    check(torch.equal(phase.gather(dev), fc.season_phase), "12(e) phase_means: season phase differs")
    check(torch.equal(n_hist.gather(dev), hm.sum(-1, dtype=torch.int32)), "12(e) phase_means: n_hist differs")
    out["pm"] = dict(err=same(res, ref, CP_TOL["upper"], "phase_means"), seconds=res_s, single_seconds=ref_s,
                     state=errs, flagged=int((res_field(res, "verdict") == 1).sum()))
    check(torch.equal(res_field(res, "verdict") == 1, spiked), "12(e) phase_means: not the spiked rows")
    rows = slice(0, CP_EWMA_B)
    with uncounted():
        want, ref_s = timed(lambda: ewma_levels(hv[rows], hm[rows], 0.3))
    got, res_s = timed(lambda: sharded_ewma(hv[rows], hm[rows], 0.3, mesh))
    err = float((got.gather(dev) - want).abs().max())
    check(err <= CP_TOL["ewma"] * (1 + float(want.abs().max())), f"12(e) sharded_ewma off by {err}")
    out["ewma"] = dict(err=err, seconds=res_s, single_seconds=ref_s)
    print(f"phase 12: (e) context parallelism over a 1 x {MESH_BLOCKS} mesh ({devices[0]}), B={b}, Th={th} "
          f"({b * th * 5 / 1e9:.2f} GB of f32 values and mask), m={m}: moving_average_all {out['ma']['seconds']:.3f} s "
          f"(single {out['ma']['single_seconds']:.3f} s), upper off by {out['ma']['err']:.2e}; phase_means "
          f"{out['pm']['seconds']:.3f} s (single {out['pm']['single_seconds']:.3f} s), state {errs}, upper off by "
          f"{out['pm']['err']:.2e}; verdicts and flags equal, {out['pm']['flagged']} spiked rows flagged; sharded_ewma "
          f"of {CP_EWMA_B} rows {out['ewma']['seconds']:.3f} s (ewma_levels {out['ewma']['single_seconds']:.3f} s), "
          f"off by {err:.2e}")
    return out


def phase_device_mesh(dev, smi: str) -> dict:
    """Phase 12: the device mesh of one process. On one card the mesh is
    the card listed MESH_BLOCKS times (a one-card mesh: its times are the
    per-block overhead on one card, not the scaling of several); with
    more than one card, (a) and (c) run again over every card."""
    import torch

    from foremast_tpu_torch.parallel import mesh as meshlib

    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
    cuda = torch.device(dev).type == "cuda"
    card = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device(dev)
    devices = [card] * MESH_BLOCKS
    mesh = meshlib.make_mesh(n_data=MESH_BLOCKS, devices=devices)
    label = f"one-card mesh ({card} listed {MESH_BLOCKS} times)"
    t_now = int(time.time())
    t0 = time.perf_counter()
    docs, data, latency = worker_fleet(MESH_WORKER_DOCS, t_now)
    runs = mesh_worker_arm(dev, mesh, docs, data, latency, t_now)
    report_worker_arm(label, runs, smi)
    t1 = time.perf_counter()
    obj = mesh_object_arm(dev, mesh)
    t2 = time.perf_counter()
    dispatch = mesh_dispatch_arm(dev, label, runs)
    t3 = time.perf_counter()
    joint = mesh_joint_arm(dev, mesh, t_now)
    t4 = time.perf_counter()
    context = mesh_context_arm(dev, devices)
    t5 = time.perf_counter()
    n_cards = torch.cuda.device_count() if cuda else 1
    if n_cards > 1:
        cards = meshlib.make_mesh(devices=meshlib.local_devices())
        label = f"mesh over every card ({n_cards})"
        multi = mesh_worker_arm(dev, cards, docs, data, latency, t_now, single=runs["single"])
        report_worker_arm(label, multi, smi)
        mesh_dispatch_arm(dev, label, multi)
    else:
        print(f"phase 12: ran over one card ({card}, torch.cuda.device_count() = {n_cards}): no copy between cards "
              f"and no launch on a card other than the current one was exercised")
    print(f"phase 12: seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, "
          f"(e) {t5 - t4:.1f}, more cards {time.perf_counter() - t5:.1f}")
    return dict(runs=runs, obj=obj, dispatch=dispatch, joint=joint, context=context)


# -- phase 13: the control loop -------------------------------------------------

CL_NAMESPACES = 8
CL_APPS = 256  # one release wave: 32 Deployments a namespace
CL_PODS = 2  # pods of each ReplicaSet: old (v1) and new (v2)
CL_METRICS = {a: f"http_server_requests_{a}" for a in ALIASES}  # alias -> recording-rule metric
CL_HIST_POOL = 64  # seeded 7-day rows on a 1/64 grid; app i adds i/64 to its rows, so its 4 histories are its own
CL_MARGIN = 0.1  # in sigma: the spiked apps' points this far above the band, the others' closest this far below
CL_BAND_TOL = 1e-4  # absolute, on bands of 1.2-5.2: card against CPU, and the cold bands against float64
CL_POLLS = 6  # plane steps of a fault-free arm: prime, rollout, t1+140, t1+671 and the two closing resyncs
CL_TIMEOUT = 90.0  # seconds for a CLI process of (e)
CL_CHAOS = {"seed": 13, "rules": [  # (d): 0.2 on every read-only path of the kube edge
    {"edge": "kube", "op": op, "error_rate": 0.2, "kind": kind}
    for op, kind in (("/apis/apps/v1/deployments", "connection"), ("/replicasets", "timeout"),
                     ("/pods", "connection"), ("/deploymentmetadatas/", "timeout"),
                     ("/apis/deployment.foremast.ai/v1alpha1/deploymentmonitors", "connection"))
]}


def cl_app(i: int) -> tuple[str, str]:
    """(namespace, app) of the fleet's i-th Deployment."""
    return f"team-{i % CL_NAMESPACES}", f"svc-{i:03d}"


def cl_remediation(i: int) -> str:
    """Apps i % 4 == 0 or 1 roll back, 2 or 3 pause; the even ones spike."""
    return "AutoRollback" if i % 4 < 2 else "AutoPause"


class SteppedClock:
    """The plane's clock, stepped by the arm's loop."""

    def __init__(self, t: float):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def control_loop_fleet(t1: int, seed: int = 29) -> dict:
    """One release wave: 256 Deployments over 8 namespaces rolling from v1
    to v2 at `t1`, each with its DeploymentMetadata (4 monitored metrics)
    and its DeploymentMonitor (the remediation option set), its v1
    ReplicaSet and pods, and the v2 ReplicaSet and pods of the rollout.
    Series: each app's 4 histories (7 days at 60 s, the settled range the
    worker fits) are 4 rows of a seeded pool on a 1/64 grid (so the bf16
    deltas are exact) plus the app's own offset i/64, and the new pods'
    11-point current window (Barrelman's 600 s window plus the 60 s
    latency offset) is a slow wave at the same offset. On latency and
    error5xx, the upper band moving_average_all gives at the metric
    type's threshold (mean + thr std, ddof 0; thr 10 and 2), taken here
    in float64, places the current points: 3 of them CL_MARGIN std above
    it for the even apps, one CL_MARGIN std below it for the odd ones, so
    a band wrong by a tenth of a std flips a verdict. Endpoints are
    filled in by `cl_seed`."""
    from foremast_tpu_torch.config import BrainConfig

    rules = BrainConfig().anomaly
    rng = np.random.default_rng(seed)
    ht = t1 - 86_400 * 7 + 60 * np.arange(FULL_TH, dtype=np.int64)
    ct = t1 + 60 + 60 * np.arange(11, dtype=np.int64)
    pool = np.round(64 * rng.normal(1.0, 0.1, (CL_HIST_POOL, FULL_TH))).astype(np.int64)
    wave = 1.0 + 0.05 * np.sin(np.arange(11) / 3.0)
    apps = []
    for i in range(CL_APPS):
        ns, app = cl_app(i)
        spike = i % 2 == 0
        hist, cur, upper = {}, {}, {}
        for k, x in enumerate(ALIASES):
            codes = pool[(i * len(ALIASES) + k) % CL_HIST_POOL] + i
            v = codes / 64.0
            mu, sd = float(v.mean()), float(v.std())
            upper[x] = mu + rules.rule_for(x).threshold * sd
            c = wave + i / 64.0
            if x in ("latency", "error5xx"):
                if spike:
                    c[4:7] = upper[x] + CL_MARGIN * sd
                else:
                    c[5] = upper[x] - CL_MARGIN * sd
            hist[x], cur[x] = codes, c.astype(np.float32)
        apps.append(dict(
            i=i, ns=ns, app=app, uid=f"dep-{ns}-{app}", spike=spike, option=cl_remediation(i),
            hist=hist, cur=cur, upper=upper,
            old_pods=[f"{app}-v1-{k}" for k in range(CL_PODS)], new_pods=[f"{app}-v2-{k}" for k in range(CL_PODS)],
        ))
    return dict(t1=t1, ht=ht, ct=ct, apps=apps)


def cl_deployment(a: dict, version: int) -> dict:
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": a["app"], "namespace": a["ns"], "uid": a["uid"], "labels": {"app": a["app"]},
                     "annotations": {"deployment.kubernetes.io/revision": str(version)}},
        "spec": {"replicas": CL_PODS, "template": {
            "metadata": {"labels": {"app": a["app"]}},
            "spec": {"containers": [{"name": "main", "image": f"{a['app']}:v{version}"}]}}},
    }


def cl_replicaset(a: dict, version: int) -> dict:
    name = f"{a['app']}-v{version}"
    return {
        "metadata": {"name": name, "namespace": a["ns"], "uid": f"rs-{a['ns']}-{name}",
                     "annotations": {"deployment.kubernetes.io/revision": str(version)},
                     "ownerReferences": [{"uid": a["uid"]}]},
        "spec": {"replicas": CL_PODS, "template": {
            "metadata": {"labels": {"app": a["app"], "pod-template-hash": name}},
            "spec": {"containers": [{"name": "main", "image": f"{a['app']}:v{version}"}]}}},
        "status": {"replicas": CL_PODS},
    }


def cl_pods(a: dict, version: int) -> list:
    rs_uid = f"rs-{a['ns']}-{a['app']}-v{version}"
    names = a["old_pods"] if version == 1 else a["new_pods"]
    return [{"metadata": {"name": n, "namespace": a["ns"], "uid": f"pod-{a['ns']}-{n}",
                          "ownerReferences": [{"uid": rs_uid}]}} for n in names]


def cl_seed(srv, fleet: dict, gateway_url: str, prom_url: str) -> None:
    """The cluster before the rollout: namespaces, one DeploymentMetadata
    and one DeploymentMonitor (remediation option set) per app, v1
    Deployments, ReplicaSets and pods."""
    from foremast_tpu_torch.watch.crds import (DeploymentMetadata, DeploymentMonitor, MonitoredMetric,
                                               Remediation)

    st = srv.state
    st.watch_cap = 1 << 20  # the streaming arm's 410s are injected, never compaction's
    for k in range(CL_NAMESPACES):
        st.put("namespaces", "", {"metadata": {"name": f"team-{k}", "annotations": {}}})
    for a in fleet["apps"]:
        md = DeploymentMetadata(
            name=a["app"], namespace=a["ns"], analyst_endpoint=gateway_url + "/v1/healthcheck/",
            metrics_endpoint=prom_url + "/api/v1/",
            monitoring=[MonitoredMetric(CL_METRICS[x], metric_type=x, metric_alias=x) for x in ALIASES],
        )
        st.put("deploymentmetadatas", a["ns"], md.to_json())
        mon = DeploymentMonitor(name=a["app"], namespace=a["ns"], selector={"app": a["app"]},
                                remediation=Remediation(option=a["option"]))
        st.put("deploymentmonitors", a["ns"], mon.to_json())
        st.put("deployments", a["ns"], cl_deployment(a, 1))
        st.put("replicasets", a["ns"], cl_replicaset(a, 1))
        for pod in cl_pods(a, 1):
            st.put("pods", a["ns"], pod)


def cl_rollout(srv, fleet: dict) -> None:
    """Every Deployment of the wave goes to v2 while its v1 pods still run."""
    for a in fleet["apps"]:
        srv.state.put("replicasets", a["ns"], cl_replicaset(a, 2))
        for pod in cl_pods(a, 2):
            srv.state.put("pods", a["ns"], pod)
        srv.state.put("deployments", a["ns"], cl_deployment(a, 2))


def cl_prometheus(fleet: dict):
    """The fake Prometheus for the wave: every query Barrelman builds for
    the rollout at t1 (`pods_query` / `app_query` over its windows)
    answered by its series under its exact URL, every body encoded up
    front."""
    from foremast_tpu_torch.metrics.promql import app_query, pods_query
    from torch_fake_services import FakePrometheus

    fake = FakePrometheus()
    t1, ht, ct = fleet["t1"], fleet["ht"], fleet["ct"]

    def key(q, start, end):
        return f"/api/v1/query_range?query={urllib.parse.quote(q, safe='')}&start={start}&end={end}&step=60"

    for a in fleet["apps"]:
        for x in ALIASES:
            fake.put_grid(key(app_query(CL_METRICS[x], a["ns"], a["app"]), t1 - 86_400 * 7, t1), ht, a["hist"][x])
            fake.set_series(key(pods_query(CL_METRICS[x], a["ns"], a["new_pods"]), t1 + 60, t1 + 660),
                            (ct, a["cur"][x]))
    return fake


def recording_source(record: dict):
    """The worker's PrometheusSource, recording every answer: later arms
    replay the record (`replay_record`), so each arm after (a) times its
    judging rather than the fake Prometheus' JSON."""
    from foremast_tpu_torch.metrics.source import PrometheusSource

    class RecordingSource(PrometheusSource):
        def fetch(self, url):
            out = super().fetch(url)
            record[url] = out
            return out

    return RecordingSource()


def replay_record(record: dict):
    from foremast_tpu_torch.metrics.source import MetricSource

    class ReplayRecord(MetricSource):
        concurrent_fetch = False

        def fetch(self, url):
            return record[url]  # a URL (a) never fetched fails the arm

    return ReplayRecord()


def gateway_requests(url: str) -> dict:
    """The gateway's requests by route pattern (all codes), from the
    foremast_service_requests_total samples on its /metrics."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out: dict = {}
    for m in re.finditer(r'^foremast_service_requests_total\{(.*)\} (\S+)$', text, re.M):
        route = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))["route"]
        out[route] = out.get(route, 0) + int(float(m.group(2)))
    return out


def cl_snapshot(srv, es, bands: dict) -> dict:
    """The loop's outcome: each job's (status, code, reason, anomaly),
    each verdict's (verdict, flagged points, band) by tick, each
    monitor's (phase, remediation taken, anomaly, job), each
    Deployment's (image, paused)."""
    from foremast_tpu_torch.watch.crds import DeploymentMonitor

    monitors = {}
    for (ns, name), obj in srv.state.objects["deploymentmonitors"].items():
        m = DeploymentMonitor.from_json(obj)
        monitors[f"{ns}/{name}"] = json.dumps(
            [m.status.phase, m.status.remediation_taken, m.status.anomaly, m.status.job_id], sort_keys=True)
    deps = {}
    for (ns, name), obj in srv.state.objects["deployments"].items():
        deps[f"{ns}/{name}"] = (obj["spec"]["template"]["spec"]["containers"][0]["image"],
                                bool(obj["spec"].get("paused", False)))
    return dict(docs=es_written(es.sources()), monitors=monitors, deployments=deps, bands=bands)


def cl_terminal(srv) -> int:
    from foremast_tpu_torch.watch.crds import DeploymentMonitor

    return sum(DeploymentMonitor.from_json(o).status.phase in ("Healthy", "Unhealthy")
               for o in srv.state.objects["deploymentmonitors"].values())


def cl_arm(label: str, dev, fleet: dict, es, es_url: str, gateway_url: str, prom_url: str, source,
           stream: bool = False, chaos_plan=None, retries=None) -> dict:
    """One run of the loop over a fresh fake API server and an emptied
    fake index: prime the plane, roll the wave out, then the plane's
    steps and the worker's ticks on a stepped clock (t1: the plane's
    resync sees the rollout and Barrelman POSTs a job per Deployment to
    the gateway; t1+130: first tick, the histories settled (the worker's
    120 s), so the cold fits go into the fit cache and the state arena;
    t1+140: the poll remediates the anomalies; t1+661: tick past the
    window, warm (the columnar path, no history fetched); t1+671: the
    poll takes the healthy ones to Healthy; two more resyncs see the
    rollback patches). Every verdict is recorded through the worker's
    on_verdict hook (verdict, flagged points, the band's last point).
    A plane step that raises is recorded and the loop steps on, as
    WatchPlane.run does; without a chaos plan no step may fail and the
    wave must end in CL_POLLS steps, with one every step may fail only
    by an injected fault. `stream` primes and delivers the rollout
    through the streaming informer with one torn stream and one 410
    armed, and the stream alone must make one job per rollout. Returns
    the snapshot and the arm's timings."""
    from foremast_tpu_torch.chaos import CircuitBreaker, InjectedFault
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.watch.kubeapi import HttpKube
    from foremast_tpu_torch.watch.plane import WatchPlane

    from fake_kube_server import FakeKubeServer

    t1 = fleet["t1"]
    with es.lock:
        es.docs.clear()
        es.writes.clear()
    with FakeKubeServer() as srv:
        cl_seed(srv, fleet, gateway_url, prom_url)
        breaker = CircuitBreaker("kube") if chaos_plan is not None else None
        kube = HttpKube(base_url=srv.url, retries=retries, backoff_seconds=0.01,
                        chaos=chaos_plan.edge("kube") if chaos_plan is not None else None, breaker=breaker)
        clock = SteppedClock(t1 - 60)
        plane = WatchPlane(kube, own_namespace="foremast", clock=clock, sleep=lambda s: None,
                           tracer=Tracer(service="controller"), stream=stream)
        bands: dict = {}
        at = [0]  # the tick being judged, seconds after t1

        def on_verdict(doc, verdicts):
            for v in verdicts:
                bands[(at[0], doc.id, v.alias)] = (int(v.verdict), list(v.anomaly_pairs),
                                                   float(np.asarray(v.upper).reshape(-1)[-1]),
                                                   float(np.asarray(v.lower).reshape(-1)[-1]))

        worker = BrainWorker(ElasticsearchStore(es_url), source, config=BrainConfig(), device=dev,
                             claim_limit=CL_APPS, worker_id=f"phase13-{label}", on_verdict=on_verdict)
        polls, ticks, step_errors = [], [], []

        def step(t: float) -> None:
            """WatchPlane.run's step: resync and poll; a failure is
            recorded and the next step retries."""
            clock.t = t
            t0 = time.perf_counter()
            try:
                plane.informer.resync()
            except Exception as e:  # noqa: BLE001 - run() logs and steps again; the arm checks the record
                step_errors.append(("resync", e))
            t_poll = time.perf_counter()
            try:
                plane.controller.tick()
            except Exception as e:  # noqa: BLE001 - run() logs and steps again; the arm checks the record
                step_errors.append(("poll", e))
            polls.append((t - t1, time.perf_counter() - t_poll, t_poll - t0))

        def tick(t: float) -> None:
            at[0] = int(t - t1)
            t0 = time.perf_counter()
            n = worker.tick(now=t)
            sync_card()
            ticks.append((t - t1, n, time.perf_counter() - t0))

        try:
            step(t1 - 60)  # prime: the informer's first list, every monitor exists already
            base = gateway_requests(gateway_url)
            t_roll = time.perf_counter()
            cl_rollout(srv, fleet)
            informer, streamed = {}, None
            if stream:
                clock.t = t1
                srv.state.add_watch_fault(disconnect=True, after_events=CL_APPS // 3)
                srv.state.add_watch_fault(gone=True)
                for _ in range(12):  # a faulted connect returns at once
                    plane.informer.consume(1.0, stall_margin=1.0)
                    if len(es.docs) >= CL_APPS and plane.informer.counts["restart_gone"]:
                        break
                informer = dict(plane.informer.counts)
                with es.lock:
                    streamed = len(es.docs)
                step(t1 + 1)
            else:
                step(t1)
            created_s = time.perf_counter() - t_roll
            tick(t1 + 130)
            step(t1 + 140)
            tick(t1 + 661)
            t = t1 + 671
            step(t)
            while cl_terminal(srv) < CL_APPS and t < t1 + 671 + 600:
                t += 30  # only faults leave monitors behind; the plane's next steps take them
                tick(t)
                step(t)
            done_s = time.perf_counter() - t_roll
            terminal = cl_terminal(srv)
            for extra in (30, 60):  # the resyncs that see the rollback patches
                step(t + extra)
            reqs = gateway_requests(gateway_url)
            requests = {k: reqs.get(k, 0) - base.get(k, 0) for k in reqs if reqs.get(k, 0) - base.get(k, 0)}
            snap = cl_snapshot(srv, es, bands)
        finally:
            worker.close()
    failed = [f"{where}: {e.edge}/{e.kind}" if isinstance(e, InjectedFault) else f"{where}: {type(e).__name__}: {e}"
              for where, e in step_errors]
    check(all(isinstance(e, InjectedFault) for _, e in step_errors),
          f"phase 13 ({label}): plane steps failed on other than an injected fault: {failed}")
    if chaos_plan is None:
        check(not step_errors and len(polls) == CL_POLLS,
              f"phase 13 ({label}): {len(polls)} plane steps (want {CL_POLLS}), failed: {failed}")
    if stream:
        check(streamed == CL_APPS, f"phase 13 ({label}): the stream alone made {streamed} jobs for {CL_APPS} rollouts")
    check(terminal == CL_APPS, f"phase 13 ({label}): {CL_APPS - terminal} monitors never reached a terminal phase")
    check(len(snap["docs"]) == CL_APPS, f"phase 13 ({label}): {len(snap['docs'])} jobs for {CL_APPS} rollouts")
    creates = requests.get("/v1/healthcheck/create", 0)
    check(creates == CL_APPS, f"phase 13 ({label}): {creates} creates for {CL_APPS} rollouts (one job each)")
    return dict(snap=snap, created_s=created_s, done_s=done_s, ticks=ticks, polls=polls, requests=requests,
                informer=informer, step_errors=failed,
                breaker=breaker.debug_state() if breaker is not None else None)


def cl_expected(fleet: dict, snap: dict, label: str) -> float:
    """The wave's outcome by construction: spiked apps Unhealthy and
    remediated (rolled back to v1 or paused), the others Healthy; each
    metric's cold verdict as its current points were placed, and its
    cold band within CL_BAND_TOL of the float64 band."""
    from foremast_tpu_torch.jobs.models import STATUS_COMPLETED_HEALTH, STATUS_COMPLETED_UNHEALTH

    docs = {json.loads(v)[0] for v in snap["docs"].values()}
    check(docs <= {STATUS_COMPLETED_HEALTH, STATUS_COMPLETED_UNHEALTH}, f"phase 13 ({label}): job statuses {docs}")
    worst = 0.0
    for a in fleet["apps"]:
        key = f"{a['ns']}/{a['app']}"
        phase, taken, anomaly, job = json.loads(snap["monitors"][key])
        image, paused = snap["deployments"][key]
        want_image = f"{a['app']}:v1" if a["spike"] and a["option"] == "AutoRollback" else f"{a['app']}:v2"
        ok = (phase == ("Unhealthy" if a["spike"] else "Healthy") and taken == a["spike"] and bool(job)
              and bool(anomaly) == a["spike"] and image == want_image
              and paused == (a["spike"] and a["option"] == "AutoPause"))
        check(ok, f"phase 13 ({label}): {key} ended {phase}, remediated={taken}, image {image}, paused={paused}")
        for x in ALIASES:
            band = snap["bands"].get((130, job, x))
            check(band is not None, f"phase 13 ({label}): no cold verdict for {key} {x}")
            want = int(a["spike"] and x in ("latency", "error5xx"))
            check(band[0] == want, f"phase 13 ({label}): {key} {x}: verdict {band[0]}, placed as {want}")
            worst = max(worst, abs(band[2] - a["upper"][x]))
    check(worst <= CL_BAND_TOL, f"phase 13 ({label}): a cold band is {worst:.3g} off its float64 value")
    return worst


def cl_same(got: dict, want: dict, what: str) -> float:
    """Docs, monitors and Deployments equal; the same verdicts with the
    same flagged points at every tick, each band within CL_BAND_TOL.
    Returns the largest band difference."""
    for part in ("docs", "monitors", "deployments"):
        bad = [k for k in want[part] if got[part].get(k) != want[part][k]]
        check(not bad and set(got[part]) == set(want[part]),
              f"phase 13: {what}: {len(bad)} {part} differ, e.g. {bad[:2]}")
    g, w = got["bands"], want["bands"]
    check(set(g) == set(w), f"phase 13: {what}: verdicts for {len(set(g) ^ set(w))} (tick, job, metric) differ")
    bad = [k for k in w if g[k][:2] != w[k][:2]]
    check(not bad, f"phase 13: {what}: {len(bad)} verdicts or flagged points differ, e.g. {bad[:2]}")
    worst = max((max(abs(g[k][2] - w[k][2]), abs(g[k][3] - w[k][3])) for k in w), default=0.0)
    check(worst <= CL_BAND_TOL, f"phase 13: {what}: bands differ by up to {worst:.3g}")
    return worst


def cl_report(label: str, run: dict, smi: str) -> None:
    ticks = ", ".join(f"t1+{int(t)} s: {n} docs in {s:.3f} s" for t, n, s in run["ticks"])
    polls = [p for _, p, _ in run["polls"]]
    print(f"phase 13: ({label}) rollout -> {CL_APPS} jobs in {run['created_s']:.3f} s, rollout -> last monitor "
          f"terminal {run['done_s']:.3f} s; worker ticks [{ticks}]; plane steps {len(polls)}, controller poll "
          f"median {statistics.median(polls):.3f} s, max {max(polls):.3f} s; gateway requests by route "
          f"{run['requests']}; {smi}")


def cl_score_request(workdir: str) -> str:
    """The request of tests/test_cli.py's score cases (one alias)."""
    def mq(query):
        return {"dataSourceType": "prometheus", "parameters": {
            "endpoint": "http://prometheus:9090/api/v1/", "query": query,
            "start": "1600000000", "end": "1600000600", "step": "60"}}

    req = {"appName": "demo-app", "startTime": "2020-09-13T12:26:40Z", "endTime": "2020-09-13T12:36:40Z",
           "strategy": "canary", "metrics": {"current": {"error4xx": mq("cur:error4xx")},
                                             "baseline": {"error4xx": mq("base:error4xx")},
                                             "historical": {"error4xx": mq("hist:error4xx")}}}
    path = os.path.join(workdir, "request.json")
    with open(path, "w") as f:
        json.dump(req, f)
    return path


def cl_start(args: list, workdir: str, tag: str, env_extra=None) -> tuple:
    """`python -m foremast_tpu_torch <args>` started in the background,
    stdout and stderr to files of `workdir`."""
    out_path, err_path = os.path.join(workdir, f"{tag}.out"), os.path.join(workdir, f"{tag}.err")
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_extra or {}))
    out, err = open(out_path, "w"), open(err_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "foremast_tpu_torch", *args], cwd=ROOT, env=env, stdout=out,
                            stderr=err)
    return proc, out, err, out_path, err_path


def cl_finish(started: tuple, timeout: float = CL_TIMEOUT) -> tuple:
    """(exit code, stdout, stderr) of a started process, killed at `timeout`."""
    proc, out, err, out_path, err_path = started
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.close()
    err.close()
    return rc, open(out_path).read(), open(err_path).read()


def cl_subcommands(dev, workdir: str) -> dict:
    """(e): `score` on the card as three processes started together,
    beside them watch / unwatch and watch-plane for a bounded time, each
    against what it needs; every process's exit code and output checked.
    It runs after the timed arms, so no process of it shares the card or
    the host with them."""
    import signal
    from contextlib import redirect_stdout
    from io import StringIO

    from foremast_tpu_torch.cli import main as port_main
    from foremast_tpu_torch.watch.crds import DeploymentMonitor, MonitorStatus
    from foremast_tpu_torch.watch.kubeapi import HttpKube

    from fake_kube_server import FakeKubeServer

    out = {}
    t_e = time.perf_counter()
    req = cl_score_request(workdir)
    data = os.path.join(ROOT, "tests", "data")
    spike, normal = os.path.join(data, "demo_canary_spike.csv"), os.path.join(data, "demo_canary_normal.csv")
    score_args = [["score", "--request", req, "--current", f"error4xx={cur}", "--baseline",
                   f"error4xx={normal}", "--historical", f"error4xx={normal}"] for cur in (spike, normal)]
    score_args.append(["score", "--request", req])
    score_procs = [cl_start(args + ["--device", dev.type], workdir, f"score-{k}") for k, args in enumerate(score_args)]
    try:
        # watch / unwatch against the fake API server
        t0 = time.perf_counter()
        with FakeKubeServer() as srv:
            HttpKube(base_url=srv.url).upsert_monitor(DeploymentMonitor(
                name="shop", namespace="prod", status=MonitorStatus(job_id="job-42", phase="Running")))
            rcs = []
            for verb, name, want in (("watch", "shop", True), ("unwatch", "shop", False), ("watch", "ghost", None)):
                rc, stdout, stderr = cl_finish(cl_start([verb, name, "-n", "prod", "--api-server", srv.url],
                                                        workdir, f"{verb}-{name}"))
                rcs.append(rc)
                if want is not None:
                    mon = HttpKube(base_url=srv.url).get_monitor("prod", "shop")
                    check(rc == 0 and mon.continuous is want and "Job: job-42" in stdout,
                          f"phase 13: (e) {verb} {name}: rc {rc}, continuous {mon.continuous}, out {stdout!r}")
            check(rcs == [0, 0, 1], f"phase 13: (e) watch / unwatch / watch ghost exited {rcs}")
        out["watch, unwatch, watch ghost"] = rcs
        watch_s = time.perf_counter() - t0
        # watch-plane for a bounded time, chaos on its kube edge, then SIGTERM
        t0 = time.perf_counter()
        with FakeKubeServer() as srv:
            deps = 32
            for k in range(CL_NAMESPACES):
                srv.state.put("namespaces", "", {"metadata": {"name": f"team-{k}", "annotations": {}}})
            for i in range(deps):
                a = dict(ns=cl_app(i)[0], app=cl_app(i)[1], uid=f"dep-{i}")
                srv.state.put("deployments", a["ns"], cl_deployment(a, 1))
            # seed 12 faults the plane's first list; its retry lists again
            plan = json.dumps({"seed": 12, "rules": [{"edge": "kube", "op": "/apis/apps/v1/deployments",
                                                      "error_rate": 0.2}]})
            started = cl_start(["watch-plane", "--api-server", srv.url, "--namespace", "foremast"], workdir,
                               "watch-plane", {"FOREMAST_CHAOS_PLAN": plan})
            deadline = time.perf_counter() + CL_TIMEOUT
            while len(srv.state.objects["deploymentmonitors"]) < deps and time.perf_counter() < deadline:
                if started[0].poll() is not None:
                    break
                time.sleep(0.2)
            made = len(srv.state.objects["deploymentmonitors"])
            up_s = time.perf_counter() - t0
            started[0].send_signal(signal.SIGTERM)
            rc, stdout, stderr = cl_finish(started, timeout=30)
        stopped = [json.loads(ln) for ln in stderr.splitlines() if ln.startswith("{") and "watch plane stopped" in ln]
        if rc != 0 or made < deps or not stopped:
            print(f"phase 13: (e) watch-plane stderr:\n{stderr[-4000:]}", file=sys.stderr)
        check(made == deps, f"phase 13: (e) watch-plane made {made} of {deps} monitors")
        check(rc == 0 and stopped, f"phase 13: (e) watch-plane exited {rc} on SIGTERM")
        check(sum((stopped[0].get("chaos_injections") or {}).values()) >= 1,
              f"phase 13: (e) watch-plane's kube edge injected nothing: {stopped[0]}")
        out["watch-plane"] = dict(rc=rc, monitors=made, seconds_to_monitors=round(up_s, 3),
                                  injections=stopped[0].get("chaos_injections"))
        plane_s = time.perf_counter() - t0
        # score on the card, held to the port's score on the CPU (plain versions)
        for (tag, want_rc, want_status), started, args in zip(
                (("spike", 0, "anomaly"), ("normal", 0, "success"), ("no traces", 1, None)), score_procs, score_args):
            rc, stdout, stderr = cl_finish(started)
            if rc != want_rc:
                print(f"phase 13: (e) score {tag} stderr:\n{stderr[-4000:]}", file=sys.stderr)
            check(rc == want_rc,
                  f"phase 13: (e) score --device {dev.type} on the {tag} request exited {rc}, not {want_rc}")
            got = json.loads(stdout)
            buf = StringIO()
            with redirect_stdout(buf):
                cpu_rc = port_main(args + ["--device", "cpu"])
            check(cpu_rc == rc and json.loads(buf.getvalue()) == got,
                  f"phase 13: (e) score {tag}: the card's answer differs from the CPU's")
            if want_status is not None:
                check(got["status"] == want_status, f"phase 13: (e) score {tag}: status {got['status']}")
            out[f"score {tag}"] = (rc, got["status"])
    finally:
        for started in score_procs:
            if started[0].poll() is None:
                started[0].kill()
                started[0].wait()
    print(f"phase 13: (e) subcommands as processes: {out}; seconds: watch / unwatch {watch_s:.1f}, watch-plane "
          f"{plane_s:.1f}, (e) in all {time.perf_counter() - t_e:.1f} (the three score processes, started "
          f"together, ran beside the others and were then held to the CPU's answers)")
    return out


def phase_control_loop(dev, smi: str) -> dict:
    """Phase 13: the control loop (gateway, watch plane, worker on `dev`)
    over one release wave, its arms held to the same loop with a CPU
    worker, and the subcommands as processes."""
    import signal
    import tempfile

    from foremast_tpu_torch.chaos import FaultPlan
    from foremast_tpu_torch.ops import kernels as K

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import serve_fake_es, serve_fake_prometheus

    t_phase = time.perf_counter()
    t1 = (int(time.time()) // 60) * 60 - 3600
    cpu = "cpu"
    with tempfile.TemporaryDirectory(prefix="foremast-phase13-", ignore_cleanup_errors=True) as workdir:
        es_srv, es, es_url = serve_fake_es()
        port = free_port()
        gateway_url = f"http://127.0.0.1:{port}"
        gw = cl_start(["serve", "--host", "127.0.0.1", "--port", str(port), "--elastic-url", es_url], workdir,
                      "gateway")
        prom_srv = None
        try:
            fleet = control_loop_fleet(t1)  # while the gateway starts
            prom = cl_prometheus(fleet)
            prom_srv, prom_url = serve_fake_prometheus(prom)
            deadline = time.perf_counter() + CL_TIMEOUT
            while True:
                try:
                    with urllib.request.urlopen(gateway_url + "/healthz", timeout=5) as r:
                        if json.loads(r.read())["store_ok"]:
                            break
                except OSError:
                    pass
                check(gw[0].poll() is None and time.perf_counter() < deadline,
                      f"phase 13: the gateway did not come up:\n{open(gw[4]).read()[-4000:]}")
                time.sleep(0.2)
            setup_s = time.perf_counter() - t_phase
            record: dict = {}
            args = (fleet, es, es_url, gateway_url, prom_url)
            # (a) the loop with the worker on the card, then on the CPU
            a_card = cl_arm("a card", dev, *args, source=recording_source(record))
            prom_requests = sum(prom.requests.values())
            a_cpu = cl_arm("a cpu", cpu, *args, source=replay_record(record))
            a_float64 = cl_expected(fleet, a_card["snap"], "a card")
            cl_expected(fleet, a_cpu["snap"], "a cpu")
            a_diff = cl_same(a_card["snap"], a_cpu["snap"], "(a) the card's loop against the CPU's")
            cl_report("a card", a_card, smi)
            cl_report("a cpu", a_cpu, smi)
            # (b) the f32 cold route (masked_stats) on the card, against (a)'s CPU loop
            saved = os.environ.get("FOREMAST_BF16_DELTA")
            os.environ["FOREMAST_BF16_DELTA"] = "0"
            try:
                before = dict(K.LAUNCHES)
                b_card = cl_arm("b card", dev, *args, source=replay_record(record))
                b_launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] - before[k]}
            finally:
                os.environ.pop("FOREMAST_BF16_DELTA")
                if saved is not None:
                    os.environ["FOREMAST_BF16_DELTA"] = saved
            if dev.type == "cuda":
                check(b_launches.get("masked_stats", 0) > 0, "phase 13 (b): the f32 route never launched masked_stats")
            b_float64 = cl_expected(fleet, b_card["snap"], "b card")
            b_diff = cl_same(b_card["snap"], a_cpu["snap"], "(b) the card's f32 loop against (a)'s CPU loop")
            cl_report("b card", b_card, smi)
            print(f"phase 13: (b) FOREMAST_BF16_DELTA=0: launches {b_launches}")
            # (c) the streaming informer with one torn stream and one 410,
            # and (d) the kube chaos edge, in one arm (their checks are
            # independent; one loop of HTTP traffic keeps the phase short)
            plan = FaultPlan.from_json(CL_CHAOS).activate()
            cd_card = cl_arm("c+d card", dev, *args, source=replay_record(record), stream=True, chaos_plan=plan,
                             retries=6)
            cd_diff = cl_same(cd_card["snap"], a_cpu["snap"], "(c, d) the streaming loop under kube faults against "
                                                              "(a)'s CPU loop")
            check(cd_card["informer"].get("restart_gone", 0) >= 1, f"phase 13 (c): no 410: {cd_card['informer']}")
            injected = plan.debug_state()["injections"]
            check(sum(injected.values()) > 0, "phase 13 (d): the kube edge injected nothing")
            cl_report("c+d card", cd_card, smi)
            print(f"phase 13: (c) streaming informer counts {cd_card['informer']}, the stream alone made "
                  f"{CL_APPS} jobs; (d) kube edge at error_rate 0.2 on its read paths (the watch's connects "
                  f"included): injections {injected}, breaker {cd_card['breaker']}, plane steps "
                  f"{len(cd_card['polls'])} (fault-free: {CL_POLLS}), failed {len(cd_card['step_errors'])}, every "
                  f"one an injected fault: {cd_card['step_errors']}")
            print(f"phase 13: bands (the band's last point of every verdict): card against CPU within "
                  f"{max(a_diff, b_diff, cd_diff):.3g} ((a) {a_diff:.3g}, (b) {b_diff:.3g}, (c+d) {cd_diff:.3g}); "
                  f"cold bands against float64 within {max(a_float64, b_float64):.3g} (tolerance {CL_BAND_TOL})")
            loop_s = time.perf_counter() - t_phase - setup_s
            # (e) the subcommands as processes
            sub = cl_subcommands(dev, workdir)
        finally:
            gw[0].send_signal(signal.SIGTERM)
            gw_rc, _, gw_err = cl_finish(gw, timeout=30)
            es_srv.shutdown()
            es_srv.server_close()
            if prom_srv is not None:
                prom_srv.shutdown()
                prom_srv.server_close()
        check(gw_rc == 0, f"phase 13: the gateway exited {gw_rc} on SIGTERM:\n{gw_err[-4000:]}")
    print(f"phase 13: fleet {CL_APPS} Deployments over {CL_NAMESPACES} namespaces x {len(ALIASES)} metrics "
          f"(Th={FULL_TH}, every history its own, 11-point current windows, every 2nd app {CL_MARGIN} sigma above "
          f"its band and the others {CL_MARGIN} sigma below, remediation alternating rollback / pause); fake "
          f"Prometheus requests {prom_requests} in (a); seconds: set-up {setup_s:.1f}, arms (a)-(d) {loop_s:.1f}, "
          f"phase {time.perf_counter() - t_phase:.1f}")
    return dict(a=a_card, b=b_card, cd=cd_card, e=sub, b_launches=b_launches)


# -- phase 14: the dashboard and demo loop --------------------------------------

DB_APPS = 256  # demo apps, each a Deployment with its own DeploymentMetadata
DB_NAMESPACES = 8
DB_METRIC = "http_server_requests_error_5xx"  # the 5XX Errors panel's base family
DB_ALIAS = "error5xx"
DB_MARGIN = 0.1  # in sigma: the edge apps' point this far above (spiked) or below (others) the band
DB_STEP = 15  # seconds between the current window's points, the dashboard's default step
DB_TAIL = 120  # history points (60 s apart) put into the scrape store for the dashboard
DB_PANEL_APPS = 8  # apps whose panel is read through a `ui` process each
DB_BAND_TOL = {"bf16": 1e-5, "f32": 1e-4}  # card against CPU, as tests/test_kernels.py
DB_TIMEOUT = 60.0  # seconds for a `ui` / `rules` / gateway process to answer


def demo_trace(name: str) -> np.ndarray:
    """The demo's per-minute error-rate trace (tests/data), as float64."""
    with open(os.path.join(ROOT, "tests", "data", f"demo_canary_{name}.csv")) as f:
        return np.array([float(ln.split(",")[1]) for ln in f if ln.strip()])


def db_app(i: int) -> tuple[str, str]:
    """(namespace, app) of the fleet's i-th demo app."""
    return f"demo-{i % DB_NAMESPACES}", f"demo-{i:03d}"


def dashboard_fleet(t1: int, n: int | None = None, seed: int = 41, th: int | None = None) -> dict:
    """The demo runbook's fleet: `n` demo apps rolling v1 -> v2 at t1,
    every even one's v2 replaying the spike trace (tests/data/
    demo_canary_spike.csv) and the others the normal trace, each app
    with its own scale s and offset o on the trace (s * trace + o) and
    its own 7-day history at 60 s (Th points, ending at t1 - 60: error
    rates s * N(0.3, 0.25) + o on a 1/64 grid, so the bf16 deltas are
    exact). The current window's points are DB_STEP s apart from t1 + 45
    (the spike trace's 42 end at t1 + 660), so the spike trace's first
    spike lands at t1 + 60, the first tick. Apps i % 4 == 1 have their highest point DB_MARGIN sigma
    below the error5xx band (mean + 2 std, ddof 0, in float64) and apps
    i % 4 == 2 their first point DB_MARGIN sigma above it: a band wrong
    by a tenth of a sigma flips a verdict or an anomaly point. `flagged`
    is what the first tick (t1 + 60) must flag, by construction."""
    thr = 2.0  # config.py's error5xx rule: upper band at 2 std
    th = FULL_TH if th is None else th
    n = DB_APPS if n is None else n
    rng = np.random.default_rng(seed)
    ht = t1 - 60 * th + 60 * np.arange(th, dtype=np.int64)
    traces = {True: demo_trace("spike"), False: demo_trace("normal")}
    apps = []
    for i in range(n):
        ns, app = db_app(i)
        spike = i % 2 == 0
        s, o = 0.5 + 1.5 * rng.random(), int(rng.integers(0, 128)) / 64
        codes = np.maximum(np.round(64 * (s * rng.normal(0.3, 0.25, th) + o)), 0).astype(np.int64)
        v = codes / 64.0
        mu, sd = float(v.mean()), float(v.std())
        upper = mu + thr * sd
        tr = traces[spike]
        ct = t1 + 45 + DB_STEP * np.arange(len(tr), dtype=np.int64)
        cur = (s * tr + o).astype(np.float32)
        if i % 4 == 1:
            cur[int(np.argmax(cur))] = upper - DB_MARGIN * sd
        elif i % 4 == 2:
            cur[0] = upper + DB_MARGIN * sd
        first = ct <= t1 + 60
        flagged = [(int(t), float(x)) for t, x in zip(ct[first], cur[first]) if float(x) > upper]
        later = [float(x) for x in cur[~first]] if not spike else []
        assert all(x < upper - 0.05 * sd for x in cur[first] if float(x) <= upper) and all(
            x < upper - 0.05 * sd for x in later), f"{app}: a point unplaced near the band"
        assert bool(flagged) == spike
        apps.append(dict(i=i, ns=ns, app=app, uid=f"dep-{ns}-{app}", spike=spike, scale=s, offset=o,
                         hist=v.astype(np.float32), ct=ct, cur=cur, upper=upper, sd=sd, flagged=flagged))
    return dict(t1=t1, ht=ht, apps=apps)


def db_modules():
    """The port's modules the runbook drives (tests pass the JAX
    package's, under the same names, to drive the same runbook)."""
    import types

    from foremast_tpu_torch import config
    from foremast_tpu_torch.jobs import store
    from foremast_tpu_torch.metrics import promql, source
    from foremast_tpu_torch.observe import gauges
    from foremast_tpu_torch.watch import analyst, crds, kubeapi, plane

    return types.SimpleNamespace(config=config, store=store, promql=promql, source=source, gauges=gauges,
                                 analyst=analyst, crds=crds, kubeapi=kubeapi, plane=plane,
                                 logger="foremast_tpu_torch")


def db_source(mods, fleet: dict, clock):
    """The fleet's series as the worker fetches them: each app's history
    under its per-app query, its new pods' current window under theirs,
    served up to the runbook's clock (the points that exist by then)."""
    hist, cur = {}, {}
    for a in fleet["apps"]:
        hist[mods.promql.app_query(DB_METRIC, a["ns"], a["app"])] = (fleet["ht"], a["hist"])
        cur[mods.promql.pods_query(DB_METRIC, a["ns"], [f"{a['app']}-v2-0"])] = (a["ct"], a["cur"])

    class ClockedReplay(mods.source.MetricSource):
        concurrent_fetch = False

        def fetch(self, url):
            q = urllib.parse.parse_qs(urllib.parse.urlsplit(url).query).get("query", [""])[0]
            if q in hist:
                return hist[q]
            if q in cur:
                t, v = cur[q]
                k = int(np.searchsorted(t, clock(), side="right"))
                return t[:k], v[:k]
            return np.zeros(0, np.int64), np.zeros(0, np.float32)

    return ClockedReplay()


def db_kube(mods, fleet: dict):
    """The kube fake before the rollout: a namespace per team, each app's
    DeploymentMetadata (error5xx on the 5XX Errors panel's family), its
    v1 and v2 ReplicaSets and one pod each, its v1 Deployment."""
    crds = mods.crds
    kube = mods.kubeapi.InMemoryKube()
    for k in range(DB_NAMESPACES):
        kube.add_namespace(f"demo-{k}")
    for a in fleet["apps"]:
        ns, app = a["ns"], a["app"]
        kube.add_metadata(crds.DeploymentMetadata(
            name=app, namespace=ns, analyst_endpoint="local://", metrics_endpoint="http://prom:9090/",
            monitoring=[crds.MonitoredMetric(DB_METRIC, metric_type=DB_ALIAS, metric_alias=DB_ALIAS)]))
        for version in (1, 2):
            rs = f"{app}-v{version}"
            kube.add_replicaset({
                "metadata": {"name": rs, "namespace": ns, "uid": f"rs-{ns}-{rs}",
                             "annotations": {"deployment.kubernetes.io/revision": str(version)},
                             "ownerReferences": [{"uid": a["uid"]}]},
                "spec": {"replicas": 1, "template": {
                    "metadata": {"labels": {"app": app, "pod-template-hash": rs}},
                    "spec": {"containers": [{"name": "main", "image": f"{app}:v{version}"}]}}},
                "status": {"replicas": 1}})
            kube.add_pod({"metadata": {"name": f"{rs}-0", "namespace": ns, "uid": f"pod-{ns}-{rs}-0",
                                       "ownerReferences": [{"uid": f"rs-{ns}-{rs}"}]}})
        kube.deployments[(ns, app)] = db_deployment(a, 1)
    return kube


def db_deployment(a: dict, version: int) -> dict:
    """An app's Deployment at `version` (one replica: its ReplicaSet's pod)."""
    return {
        "metadata": {"name": a["app"], "namespace": a["ns"], "uid": a["uid"], "labels": {"app": a["app"]},
                     "annotations": {"deployment.kubernetes.io/revision": str(version)},
                     "resourceVersion": str(version)},
        "spec": {"template": {"metadata": {"labels": {"app": a["app"]}},
                              "spec": {"containers": [{"name": "main", "image": f"{a['app']}:v{version}",
                                                       "env": []}]}}},
    }


class _Recorder(logging.Handler):
    """Every WARNING or worse a package logs during an arm."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records: list = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}")


def db_arm(label: str, fleet: dict, make_worker, mods=None, scrape_into=None) -> dict:
    """The demo runbook over the fleet (tests/test_system_e2e.py's, at
    fleet size): the plane primes on v1 and creates each app's monitor
    (AutoRollback), v2 rolls out and Barrelman starts one job per app
    through LocalAnalyst over an in-memory store, then the worker made
    by `make_worker(store, source, on_verdict)` ticks every 60 s through
    the current window (t1 + 60 ... t1 + 660, the points served up to
    each tick) and once past it, the plane stepping 5 s after each tick;
    spiked jobs go Unhealthy at their first tick and are rolled back,
    the others end Healthy. The worker's BrainGauges (through
    `make_verdict_hook`) are scraped into `scrape_into` (a
    FakePrometheus) after each tick. No plane step, controller tick,
    resync or tick may fail, and no module of the package may log a
    warning. Returns the snapshot and timings."""
    from prometheus_client import CollectorRegistry, generate_latest

    mods = mods or db_modules()
    t1 = fleet["t1"]
    clock = SteppedClock(t1 - 60)
    kube = db_kube(mods, fleet)
    store = mods.store.InMemoryStore()
    registry = CollectorRegistry()
    publish = mods.gauges.make_verdict_hook(mods.gauges.BrainGauges(registry=registry))
    verdicts: dict = {}
    at = [0]

    def on_verdict(doc, vs):
        for v in vs:
            up, lo = np.asarray(v.upper).reshape(-1), np.asarray(v.lower).reshape(-1)
            verdicts[(at[0], doc.app_name, v.alias)] = (
                int(v.verdict), [float(x) for x in v.anomaly_pairs],
                float(up[-1]) if len(up) else None, float(lo[-1]) if len(lo) else None)
        publish(doc, vs)

    plane = mods.plane.WatchPlane(kube, clock=clock, sleep=lambda s: None, registry=CollectorRegistry(),
                                  analyst_factory=lambda ep: mods.analyst.LocalAnalyst(store))
    worker = make_worker(store, db_source(mods, fleet, clock), on_verdict)
    rec = _Recorder()
    logging.getLogger(mods.logger).addHandler(rec)
    n = len(fleet["apps"])
    ticks, first_verdict_s, done_s = [], None, None
    try:
        plane.step()  # prime: a monitor for each v1 Deployment
        for a in fleet["apps"]:
            mon = kube.get_monitor(a["ns"], a["app"])
            mon.remediation = mods.crds.Remediation(option=mods.crds.RemediationOption.AUTO_ROLLBACK)
            kube.upsert_monitor(mon)
        clock.t = t1
        t_roll = time.perf_counter()
        for a in fleet["apps"]:
            kube.deployments[(a["ns"], a["app"])] = db_deployment(a, 2)
        plane.step()  # Barrelman: one job per rollout
        t = t1 + 60
        while True:
            clock.t = t
            at[0] = int(t - t1)
            t0 = time.perf_counter()
            judged = worker.tick(now=t)
            sync_card()
            ticks.append((int(t - t1), judged, time.perf_counter() - t0))
            if first_verdict_s is None and verdicts:
                first_verdict_s = time.perf_counter() - t_roll
            if scrape_into is not None:
                scrape_into.scrape(generate_latest(registry).decode(), t)
            clock.t = t + 5
            plane.step(now=t + 5)
            if terminal_monitors(mods, kube, fleet) == n:
                done_s = time.perf_counter() - t_roll
                break
            if t >= t1 + 661 + 600:
                break
            t = t + 60 if t < t1 + 660 else (t1 + 661 if t == t1 + 660 else t + 60)
        for extra in (30, 60):  # the resyncs that see the rollback patches
            clock.t = t + extra
            plane.step(now=t + extra)
    finally:
        logging.getLogger(mods.logger).removeHandler(rec)
        close = getattr(worker, "close", None)
        if close is not None:
            close()
    if done_s is None:
        stuck = [(a["app"], kube.get_monitor(a["ns"], a["app"]).status.phase) for a in fleet["apps"]]
        check(False, f"phase 14 ({label}): {n - terminal_monitors(mods, kube, fleet)} monitors never reached a "
                     f"terminal phase: {stuck[:6]}, warnings {rec.records[:3]}")
    check(not rec.records, f"phase 14 ({label}): the loop logged {len(rec.records)} warnings: {rec.records[:3]}")
    snap = db_snapshot(mods, kube, store, fleet, verdicts)
    check(len(snap["docs"]) == n, f"phase 14 ({label}): {len(snap['docs'])} jobs for {n} rollouts")
    return dict(snap=snap, ticks=ticks, first_verdict_s=first_verdict_s, done_s=done_s)


def terminal_monitors(mods, kube, fleet) -> int:
    phases = (mods.crds.MonitorPhase.HEALTHY, mods.crds.MonitorPhase.UNHEALTHY)
    return sum(kube.get_monitor(a["ns"], a["app"]).status.phase in phases for a in fleet["apps"])


def db_snapshot(mods, kube, store, fleet: dict, verdicts: dict) -> dict:
    """Each app's monitor (phase, remediation taken, anomaly), its
    Deployment's image, its job's (status, code, reason, anomaly) and
    every verdict by (tick, app)."""
    monitors, images, docs = {}, {}, {}
    for a in fleet["apps"]:
        key = (a["ns"], a["app"])
        m = kube.get_monitor(*key)
        monitors[key] = json.dumps([m.status.phase, m.status.remediation_taken, m.status.anomaly], sort_keys=True)
        images[key] = kube.get_deployment(*key)["spec"]["template"]["spec"]["containers"][0]["image"]
        d = store.get(m.status.job_id)
        if d is not None:
            docs[key] = json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
    events = sorted((e["reason"], e.get("involvedObject", {}).get("name", "")) for e in kube.events)
    return dict(monitors=monitors, images=images, docs=docs, verdicts=verdicts, events=events)


def db_expected(fleet: dict, snap: dict, label: str, tol: float) -> float:
    """The runbook's outcome by construction: spiked apps Unhealthy and
    rolled back to v1, the others Healthy on v2; the first tick's
    verdict and flagged points as placed; every band within `tol` of
    the float64 band. Returns the largest band error."""
    worst = 0.0
    for a in fleet["apps"]:
        key = (a["ns"], a["app"])
        phase, taken, anomaly = json.loads(snap["monitors"][key])
        image = snap["images"][key]
        ok = (phase == ("Unhealthy" if a["spike"] else "Healthy") and bool(taken) == a["spike"]
              and bool(anomaly) == a["spike"] and image == f"{a['app']}:v{1 if a['spike'] else 2}")
        check(ok, f"phase 14 ({label}): {key} ended {phase}, remediated={taken}, image {image}")
        first = snap["verdicts"].get((60, a["app"], DB_ALIAS))
        check(first is not None, f"phase 14 ({label}): no verdict at the first tick for {key}")
        want = [x for tv in a["flagged"] for x in tv]
        check(first[0] == int(a["spike"]) and first[1] == want,
              f"phase 14 ({label}): {key}: verdict {first[0]} flagging {first[1]}, placed {want}")
        for (tick, app, _), v in snap["verdicts"].items():
            if app == a["app"]:
                worst = max(worst, abs(v[2] - a["upper"]))
                if a["spike"]:
                    check(tick == 60, f"phase 14 ({label}): {key} judged again at t1+{tick} after its anomaly")
    check(worst <= tol, f"phase 14 ({label}): a band is {worst:.3g} off its float64 value (tolerance {tol})")
    return worst


def db_same(got: dict, want: dict, what: str, tol: float) -> float:
    """Monitors, images, jobs and events equal; the same verdicts with
    the same flagged points at every tick, each band within `tol`.
    Returns the largest band difference."""
    for part in ("monitors", "images", "docs"):
        bad = [k for k in want[part] if got[part].get(k) != want[part][k]]
        check(not bad and set(got[part]) == set(want[part]), f"phase 14: {what}: {part} differ, e.g. {bad[:2]}")
    check(got["events"] == want["events"], f"phase 14: {what}: the events differ")
    g, w = got["verdicts"], want["verdicts"]
    check(set(g) == set(w), f"phase 14: {what}: verdicts for {len(set(g) ^ set(w))} (tick, app) differ")
    bad = [k for k in w if g[k][:2] != w[k][:2]]
    check(not bad, f"phase 14: {what}: {len(bad)} verdicts or flagged points differ, e.g. {bad[:2]}")
    worst = max((max(abs(g[k][2] - w[k][2]), abs(g[k][3] - w[k][3])) for k in w), default=0.0)
    check(worst <= tol, f"phase 14: {what}: bands differ by up to {worst:.3g} (tolerance {tol})")
    return worst


def db_base_samples(prom, fleet: dict) -> None:
    """The measured per-app series the panels chart: each app's last
    DB_TAIL history points and its current window."""
    for a in fleet["apps"]:
        labels = {"namespace": a["ns"], "app": a["app"]}
        prom.put_samples(f"namespace_app_per_pod:{DB_METRIC}", labels, fleet["ht"][-DB_TAIL:],
                         a["hist"][-DB_TAIL:].astype(np.float64))
        prom.put_samples(f"namespace_app_per_pod:{DB_METRIC}", labels, a["ct"], a["cur"].astype(np.float64))


def db_panel_query(fleet: dict) -> str:
    """The 5XX Errors panel over [t1 - 900, t1 + 900] at the default step."""
    return f"/api/v1/panel?i=0&end={fleet['t1'] + 900}&window=1800&step={DB_STEP}"


def db_panel_check(body: dict, a: dict, snap: dict, label: str) -> None:
    """One app's panel against the worker: the anomaly dot where the
    worker's last flagged point is, at its measured value; the band
    points equal to the bands the worker published for the app."""
    pairs = [v[1] for k, v in snap["verdicts"].items() if k[1] == a["app"] and v[1]]
    if a["spike"]:
        t_last, v_last = pairs[0][-2], pairs[0][-1]
        want = [{"t": t_last, "v": v_last}]
        check(body["anomalyJoined"] == want,
              f"phase 14 (c, {label}): {a['app']}'s dots {body['anomalyJoined']}, the worker flagged {want}")
        check({d["v"] for d in body["anomaly"]} == {v_last},
              f"phase 14 (c, {label}): {a['app']}'s anomaly gauge reads {body['anomaly'][:2]}")
    else:
        check(body["anomalyJoined"] == [] and body["anomaly"] == [],
              f"phase 14 (c, {label}): {a['app']} has dots {body['anomalyJoined']} but no anomaly")
    for side, col in (("upper", 2), ("lower", 3)):
        published = {v[col] for k, v in snap["verdicts"].items() if k[1] == a["app"]}
        got = {d["v"] for d in body[side]}
        check(got == published, f"phase 14 (c, {label}): {a['app']}'s {side} band {sorted(got)[:3]} is not what "
                                f"the worker published, {sorted(published)[:3]}")
    base = {d["t"]: d["v"] for d in body["base"]}
    for t, v in zip(a["ct"].tolist(), a["cur"].tolist()):
        check(base.get(float(t)) == v, f"phase 14 (c, {label}): {a['app']}'s base curve at {t} is {base.get(t)}")


def db_processes(workdir: str, gateway_url: str, fleet: dict) -> list:
    """One `ui` process for each of the first DB_PANEL_APPS apps, and one
    in --demo mode: (started, url, app or None)."""
    out = []
    for k in range(DB_PANEL_APPS + 1):
        port = free_port()
        if k < DB_PANEL_APPS:
            a = fleet["apps"][k]
            args = ["ui", "--host", "127.0.0.1", "--port", str(port), "--service-endpoint", gateway_url,
                    "--namespace", a["ns"], "--app", a["app"]]
        else:
            a, args = None, ["ui", "--host", "127.0.0.1", "--port", str(port), "--demo"]
        out.append((cl_start(args, workdir, f"ui-{k}"), f"http://127.0.0.1:{port}", a))
    return out


def http_json(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def wait_up(started: tuple, url: str, what: str) -> None:
    deadline = time.perf_counter() + DB_TIMEOUT
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        check(started[0].poll() is None and time.perf_counter() < deadline,
              f"phase 14: {what} did not come up:\n{open(started[4]).read()[-4000:]}")
        time.sleep(0.1)


def phase_dashboard(dev, smi: str) -> dict:
    """Phase 14: the demo runbook (WatchPlane over the kube fake,
    LocalAnalyst over the store, BrainWorker) over DB_APPS demo apps on
    the card, once with the default route and once with
    FOREMAST_BF16_DELTA=0, each against the same runbook with a CPU
    worker; the card worker's gauges scraped into the fake Prometheus
    and charted by `ui` processes through a `serve --query-endpoint`
    gateway; `rules` as a process."""
    import signal
    import tempfile

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine.scoring import set_bf16_delta
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.metrics.rules import prometheus_rule_manifest, rule_expr, to_yaml
    from foremast_tpu_torch.ops import kernels as K

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakePrometheus, serve_fake_prometheus

    t_phase = time.perf_counter()
    t1 = (int(time.time()) // 60) * 60 - 86_400
    check(BrainConfig().anomaly.rule_for(DB_ALIAS).threshold == 2.0, "phase 14: the error5xx band is not 2 std")
    with tempfile.TemporaryDirectory(prefix="foremast-phase14-", ignore_cleanup_errors=True) as workdir:
        prom = FakePrometheus()
        prom_srv, prom_url = serve_fake_prometheus(prom)
        gw_port = free_port()
        gateway_url = f"http://127.0.0.1:{gw_port}"
        # every process starts now, before the timed arms; none imports torch
        gw = cl_start(["serve", "--host", "127.0.0.1", "--port", str(gw_port), "--query-endpoint", prom_url],
                      workdir, "gateway")
        rules_proc = cl_start(["rules"], workdir, "rules")
        fleet = dashboard_fleet(t1)
        uis = db_processes(workdir, gateway_url, fleet)
        try:
            wait_up(gw, gateway_url + "/healthz", "the gateway")
            for started, url, _ in uis:
                wait_up(started, url + "/healthz", "a ui process")
            setup_s = time.perf_counter() - t_phase

            def worker_on(device, label):
                return lambda store, source, hook: BrainWorker(store, source, config=BrainConfig(), device=device,
                                                               claim_limit=DB_APPS, worker_id=f"phase14-{label}",
                                                               on_verdict=hook)

            runs, seconds, launches, scraped = {}, {}, {}, {}
            for route, bf16 in (("bf16", None), ("f32", False)):
                set_bf16_delta(bf16)
                try:
                    # the default route's gauges are charted in (c)
                    card_prom = scraped.setdefault("card", FakePrometheus()) if route == "bf16" else None
                    before = dict(K.LAUNCHES)
                    t0 = time.perf_counter()
                    runs[f"card {route}"] = db_arm(f"card {route}", fleet, worker_on(dev, f"card-{route}"),
                                                   scrape_into=card_prom)
                    seconds[f"card {route}"] = time.perf_counter() - t0
                    launches[route] = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
                    cpu_prom = scraped.setdefault("cpu", FakePrometheus()) if route == "bf16" else None
                    t0 = time.perf_counter()
                    runs[f"cpu {route}"] = db_arm(f"cpu {route}", fleet, worker_on("cpu", f"cpu-{route}"),
                                                  scrape_into=cpu_prom)
                    seconds[f"cpu {route}"] = time.perf_counter() - t0
                finally:
                    set_bf16_delta(None)
            diffs, float64 = {}, {}
            for route in ("bf16", "f32"):
                tol = DB_BAND_TOL[route]
                for side in ("card", "cpu"):
                    float64[f"{side} {route}"] = db_expected(fleet, runs[f"{side} {route}"]["snap"],
                                                             f"{side} {route}", max(tol, 1e-4))
                diffs[route] = db_same(runs[f"card {route}"]["snap"], runs[f"cpu {route}"]["snap"],
                                       f"(b) the card's {route} runbook against the CPU's", tol)
            if dev.type == "cuda":
                check(launches["f32"].get("masked_stats", 0) > 0,
                      "phase 14 (a): the f32 route never launched masked_stats")
            for label, run in runs.items():
                ticks = ", ".join(f"t1+{t} s: {n} docs in {s:.3f} s" for t, n, s in run["ticks"])
                print(f"phase 14: ({label}) {seconds[label]:.3f} s; rollout -> first verdict "
                      f"{run['first_verdict_s']:.3f} s, rollout -> last terminal monitor {run['done_s']:.3f} s; "
                      f"worker ticks [{ticks}]; {smi}")
            print(f"phase 14: (a) launches, default route {launches['bf16']}, FOREMAST_BF16_DELTA=0 "
                  f"{launches['f32']}; (b) card against CPU: bands within {diffs['bf16']:.3g} (bf16-delta, "
                  f"tolerance {DB_BAND_TOL['bf16']}) and {diffs['f32']:.3g} (f32, tolerance {DB_BAND_TOL['f32']}); "
                  f"against float64 within {max(float64.values()):.3g}")
            # (c) the dashboard: the card arm's gauges, then the CPU arm's, behind the one fake Prometheus
            t0 = time.perf_counter()
            bodies = {}
            for side in ("card", "cpu"):
                with prom.lock:
                    prom.samples = dict(scraped[side].samples)
                db_base_samples(prom, fleet)
                for started, url, a in uis[:DB_PANEL_APPS]:
                    status, body = http_json(url + db_panel_query(fleet))
                    check(status == 200, f"phase 14 (c): {a['app']}'s panel answered {status}")
                    db_panel_check(body, a, runs[f"{side} bf16"]["snap"], side)
                    bodies[(side, a["app"])] = body
            band_diff = 0.0
            for started, url, a in uis[:DB_PANEL_APPS]:
                c, p = bodies[("card", a["app"])], bodies[("cpu", a["app"])]
                for key in ("base", "anomaly", "anomalyJoined"):
                    check(c[key] == p[key], f"phase 14 (c): {a['app']}'s {key} differs between the card and the CPU")
                for key in ("upper", "lower"):
                    check([d["t"] for d in c[key]] == [d["t"] for d in p[key]],
                          f"phase 14 (c): {a['app']}'s {key} points differ between the card and the CPU")
                    band_diff = max([band_diff] + [abs(x["v"] - y["v"]) for x, y in zip(c[key], p[key])])
            check(band_diff <= DB_BAND_TOL["bf16"], f"phase 14 (c): the card's panel bands are {band_diff:.3g} off "
                                                    "the CPU's")
            same_bytes = sum(bodies[("card", a["app"])] == bodies[("cpu", a["app"])] for _, _, a in uis[:DB_PANEL_APPS])
            status, demo = http_json(uis[-1][1] + "/api/v1/panel?i=0&end=7200")
            check(status == 200 and demo["base"] and demo["anomalyJoined"]
                  and {d["t"] for d in demo["anomalyJoined"]} <= {d["t"] for d in demo["base"]},
                  "phase 14 (c): the --demo panel has no base curve or no dots on it")
            spiked = sum(a["spike"] for _, _, a in uis[:DB_PANEL_APPS])
            dash_s = time.perf_counter() - t0
            print(f"phase 14: (c) {DB_PANEL_APPS} `ui` processes through the gateway's query proxy: {spiked} spiked "
                  f"apps' dots on the worker's flagged points, every band point a published band, "
                  f"{DB_PANEL_APPS - spiked} clean apps without dots; card and CPU bodies equal but for bands within "
                  f"{band_diff:.3g} ({same_bytes} of {DB_PANEL_APPS} equal outright); the --demo panel "
                  f"{len(demo['anomalyJoined'])} dots; {dash_s:.3f} s; {smi}")
            # (d) rules
            rc, stdout, stderr = cl_finish(rules_proc, timeout=DB_TIMEOUT)
            check(rc == 0 and stdout == to_yaml(prometheus_rule_manifest()),
                  f"phase 14 (d): `rules` exited {rc}:\n{stderr[-2000:]}")
            names = [f"namespace_app_per_pod:{DB_METRIC}", f"namespace_pod:{DB_METRIC}"]
            names += [f"foremastbrain:namespace_app_per_pod:{DB_METRIC}_{s}" for s in ("upper", "lower", "anomaly")]
            missing = [n for n in names if rule_expr(n) is None]
            check(not missing, f"phase 14 (d): no recording rule for {missing}")
            exported = {key[0] for key in scraped["card"].samples}
            gauges = [rule_expr(n) for n in names[2:]]
            check(set(gauges) <= exported, f"phase 14 (d): the brain rules read {gauges}, the worker exported "
                                           f"{sorted(exported)[:4]}")
            print(f"phase 14: (d) `rules` exited 0 with the manifest's YAML ({len(stdout)} bytes); rule_expr "
                  f"resolves {names}")
        finally:
            for started in [gw, rules_proc] + [u[0] for u in uis]:
                if started[0].poll() is None:
                    started[0].send_signal(signal.SIGTERM)
            rcs = [cl_finish(started, timeout=30)[0] for started in [gw] + [u[0] for u in uis]]
            prom_srv.shutdown()
            prom_srv.server_close()
        check(rcs == [0] * len(rcs), f"phase 14: the gateway and ui processes exited {rcs} on SIGTERM")
    print(f"phase 14: fleet {DB_APPS} demo apps over {DB_NAMESPACES} namespaces (Th={FULL_TH}, every history its "
          f"own, scale and offset on the demo traces, half the rollouts spiked, {DB_MARGIN} sigma edge points); "
          f"seconds: set-up {setup_s:.1f}, arms {sum(seconds.values()):.1f}, phase "
          f"{time.perf_counter() - t_phase:.1f}; {smi}")
    return dict(runs=runs, seconds=seconds, launches=launches)


# ---------------------------------------------------------------------------
# phase 15: the diagnosis surface: profiler, lock witness, manifests, lint
# ---------------------------------------------------------------------------

OPS_B = 4096  # one fit chunk: the profiled fit_forecast, score and score_bf16_delta
OPS_JUDGE_TASKS = 64  # the judge pass whose span markers the trace must hold
OPS_DOCS = 256  # (b)'s witnessed worker
OPS_CLI_DOCS = 32  # (c)'s witnessed CLI worker
# each kernel's __global__ name, as CUPTI reports it (demangled)
OPS_KERNEL_RE = {
    "masked_stats": re.compile(r"\bmasked_stats_kernel\b"),
    "ma_judgment": re.compile(r"\bma_judgment_kernel\b"),
    "ma_judgment_bf16_delta": re.compile(r"\bma_judgment_bf16_delta_kernel\b"),
}
OPS_MARKERS = ("judge.fit", "judge.score", "judge.decode")


def same_tensors(got, want, what: str) -> None:
    """Every tensor field of two results equal, bit for bit (NaN where
    NaN)."""
    import dataclasses

    import torch

    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            try:
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
            except AssertionError as e:
                check(False, f"{what}: {f.name} differs: {e}")


def phase_ops(dev, smi: str) -> dict:
    """Phase 15: (a) fit_forecast of a 4,096-row f32 history
    (masked_stats), score at B=4,096, Th=10,080, Tc=30 (ma_judgment) and
    score_bf16_delta (ma_judgment_bf16_delta), then a cold fit-cache judge
    pass, all inside `observe.trace_scoring`: the exported Chrome trace
    must hold each kernel as a device event under its __global__ name (as
    many as its wrapper counted) and the judge's record_function markers,
    and each profiled result must equal the same call's without the
    profiler; each kernel's summed device µs from the trace is printed
    beside the call's cuda_ms. (b) With the port's lock witness installed:
    a ring with a RingSnapshotter attached takes every series of a
    256-doc fleet, a snapshot pass, and two ticks of a BrainWorker over
    RingSource on that ring (fit journals on, the snapshotter attached);
    every observed edge must be in analysis_lockgraph_torch.json. (c) The
    CLI worker with FOREMAST_LOCK_WITNESS=1 and FOREMAST_INGEST=1 takes a
    32-doc fleet as a push and judges it: its /debug/state env_overrides
    are the registered knobs it was started with, and after SIGTERM its
    exit log says every observed edge lies within the static graph. (d)
    The manifests rendered into a tempdir equal the committed
    deploy_torch/, and the lint finds nothing in (b)'s worker's registry.
    Returns the launches of (a)-(c); the timing loops run after."""
    import dataclasses
    import tempfile

    import torch
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.analysis import witness
    from foremast_tpu_torch.config import BrainConfig, env_overrides
    from foremast_tpu_torch.deploy import render
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.engine.judge import HealthJudge
    from foremast_tpu_torch.ingest import IngestCollector, RingSnapshotter, RingSource, RingStore, SnapshotCollector
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.models.cache import ModelCache
    from foremast_tpu_torch.observe import annotate, trace_scoring
    from foremast_tpu_torch.observe.gauges import WorkerMetrics
    from foremast_tpu_torch.observe.metrics_lint import lint_registry
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.parallel.batch import throughput_batch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    from foremast_tpu_torch import native

    t_phase = time.perf_counter()
    # the CLI of (c) packs through the native library: built here, as in
    # phase 9 (a no-op when phase 9 ran before)
    check(native.ensure_built(), f"phase 15: the native packing library did not load: {native.error()}")
    parts = {"native": time.perf_counter() - t_phase}
    with tempfile.TemporaryDirectory(prefix="foremast-phase15-", ignore_cleanup_errors=True) as workdir:
        # (a) the three MA kernels and a judge pass under the profiler
        t0 = time.perf_counter()
        batch = throughput_batch(OPS_B, FULL_TH, FULL_TC, device=dev)
        slim, anchor, delta = scoring.make_bf16_delta_batch(batch)
        calls = {
            "masked_stats": ("fit_forecast", lambda: scoring.fit_forecast(batch.historical.values,
                                                                          batch.historical.mask)),
            "ma_judgment": ("score", lambda: scoring.score(batch)),
            "ma_judgment_bf16_delta": ("score_bf16_delta", lambda: scoring.score_bf16_delta(slim, anchor, delta)),
        }
        unprofiled = {kname: fn() for kname, (_, fn) in calls.items()}
        tasks = [dataclasses.replace(t, fit_key=f"ops-{i}") for i, t in enumerate(fleet_tasks(OPS_JUDGE_TASKS)[0])]
        judge = HealthJudge(BrainConfig(), device=dev)
        judge.fit_cache = ModelCache(4 * len(tasks))
        judge_plain = HealthJudge(BrainConfig(), device=dev)
        judge_plain.fit_cache = ModelCache(4 * len(tasks))
        verdicts_plain = judge_plain.judge(tasks)
        torch.cuda.synchronize()
        before = dict(K.LAUNCHES)
        with trace_scoring(os.path.join(workdir, "trace")) as handle:
            profiled = {}
            for kname, (call, fn) in calls.items():
                with annotate(f"phase15.{call}"):
                    profiled[kname] = fn()
                torch.cuda.synchronize()
            launched_calls = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
            with annotate("phase15.judge"):
                verdicts = judge.judge(tasks)
            torch.cuda.synchronize()
        check(handle.path is not None and os.path.exists(handle.path), "phase 15: (a) trace_scoring wrote no trace")
        with open(handle.path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        judge_ts = min(float(e["ts"]) for e in events if e.get("name") == "phase15.judge")
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        check(kernel_events, f"phase 15: (a) the trace holds no device kernel event ({len(events)} events)")
        for marker in OPS_MARKERS:
            check(marker in names, f"phase 15: (a) the trace lacks the span marker {marker}")
        device_us = {}
        for kname, (call, _) in calls.items():
            same_tensors(profiled[kname], unprofiled[kname], f"phase 15: (a) {call} under the profiler")
            mine = [e for e in kernel_events if OPS_KERNEL_RE[kname].search(e.get("name", ""))
                    and float(e["ts"]) < judge_ts]
            check(mine, f"phase 15: (a) no device event of {kname} in the trace (kernels seen: "
                  f"{sorted({e.get('name', '')[:60] for e in kernel_events})[:12]})")
            check(len(mine) == launched_calls[kname] > 0,
                  f"phase 15: (a) {len(mine)} device events of {kname} for {launched_calls[kname]} launches")
            device_us[kname] = sum(float(e.get("dur", 0.0)) for e in mine)
        same_verdicts(verdicts, verdicts_plain, "phase 15: (a) the judge pass under the profiler")
        parts["a"] = time.perf_counter() - t0
        print(f"phase 15: (a) trace {os.path.basename(handle.path)}: {len(events)} events, "
              f"{len(kernel_events)} device kernel events, markers {', '.join(OPS_MARKERS)} present; "
              f"fit_forecast, score and score_bf16_delta equal their results without the profiler, and the "
              f"judge's {len(tasks)} verdicts equal its pass without it")

        # (b) the lock witness in process: ring, snapshot pass, worker ticks
        t0 = time.perf_counter()
        t_now = int(time.time()) - 600
        docs, data, _ = worker_fleet(OPS_DOCS, t_now)
        entries = push_entries(data)
        wit = witness.install()
        try:
            ring = RingStore(budget_bytes=PUSH_BUDGET_BYTES)
            snapshotter = RingSnapshotter(ring, os.path.join(workdir, "ring"))
            snapshotter.attach()
            for key, t, v, start in entries:
                ring.push(key, t, v, start=start)
            written = snapshotter.snapshot()
            reg = CollectorRegistry()
            store = InMemoryStore()
            for d in docs:
                store.create(Document.from_json(d))
            worker = BrainWorker(
                store, RingSource(ring, fallback=array_source(data)),
                config=BrainConfig(max_cache_size=len(docs) * len(ALIASES) + 64), device=dev,
                claim_limit=OPS_DOCS, worker_id="smoke-ops", metrics=WorkerMetrics(registry=reg),
                tracer=Tracer(service="phase15", registry=reg),
            )
            worker.enable_fit_persistence(os.path.join(workdir, "fits"))
            worker.attach_ring_snapshotter(snapshotter)
            reg.register(IngestCollector(ring))
            reg.register(SnapshotCollector(snapshotter))
            ticked = []
            for _ in range(2):
                ticked.append((worker.tick(now=time.time()), dict(worker._last_tick)))
            worker.close()
            snapshotter.close()
        finally:
            witness.uninstall()
        check([n for n, _ in ticked] == [OPS_DOCS, OPS_DOCS], f"phase 15: (b) the ticks judged {ticked}")
        graph = witness.load_graph()
        check(graph is not None, "phase 15: (b) analysis_lockgraph_torch.json is missing")
        missing = wit.unobserved_edges(graph)
        check(missing == [], f"phase 15: (b) observed lock edges missing from the static graph: {missing}")
        site_to_id = {n["site"]: n["id"] for n in graph["nodes"]}
        observed = sorted({(site_to_id.get(a, a), site_to_id.get(b, b)) for a, b in wit.edges()})
        check(observed, "phase 15: (b) the witness observed no edge")
        parts["b"] = time.perf_counter() - t0
        print(f"phase 15: (b) witness in process: {len(entries)} series pushed into a journaled ring, a snapshot "
              f"pass ({written} series written), two worker ticks of {OPS_DOCS} docs over RingSource "
              f"(fast path {ticked[0][1].get('fast')} then {ticked[1][1].get('fast')}); observed edges "
              f"{'; '.join(f'{a} -> {b}' for a, b in observed)}; none missing from the static graph")

        # (c) the lock witness through the CLI
        t0 = time.perf_counter()
        cdocs, cdata, _ = worker_fleet(OPS_CLI_DOCS, t_now, seed=43)
        centries = push_entries(cdata)
        prom = FakePrometheus()
        prom_srv, prom_url = serve_fake_prometheus(prom)
        es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
        try:
            rdocs, keyed = rebase(cdocs, cdata, "http://prom", prom_url)
            prom.data = dict(keyed)
            ing_port, gauge = free_port(), free_port()
            env_c = {"FOREMAST_LOCK_WITNESS": "1", "FOREMAST_INGEST": "1", "FOREMAST_INGEST_PORT": str(ing_port),
                     "FOREMAST_INGEST_BUDGET_BYTES": str(PUSH_BUDGET_BYTES)}
            state = {}

            def push_then_load():
                push_frames(f"http://127.0.0.1:{ing_port}/api/v1/write", centries, wait=CLI_TIMEOUT)
                es.load(rdocs)

            def read_state():
                state.update(http_json(f"http://127.0.0.1:{gauge}/debug/state")[1])

            t_start = time.time()
            run = cli_run(es_url, os.path.join(workdir, "cli-snap"), es, workdir, "witness", dev, env_c,
                          started=push_then_load, gauge_port=gauge, judged=read_state, fleet_docs=len(rdocs))
        finally:
            for srv in (es_srv, prom_srv):
                srv.shutdown()
                srv.server_close()
        verdict = [r for r in run["records"] if str(r.get("msg", "")).startswith("lock witness")]
        check(len(verdict) == 1 and "all within the static graph" in verdict[0]["msg"],
              f"phase 15: (c) the CLI's witness verdict: {verdict}\n{run['stderr'][-4000:]}")
        check(state.get("env_overrides") == env_overrides(run["env"]),
              f"phase 15: (c) /debug/state env_overrides {state.get('env_overrides')} != "
              f"{env_overrides(run['env'])}")
        parts["c"] = time.perf_counter() - t0
        up = [r["ts"] - t_start for r in run["records"] if r.get("msg") == "worker started"]
        judging = [r["seconds"] for r in run["records"] if r.get("msg") == "tick complete" and r.get("docs")]
        print(f"phase 15: (c) python3 -m foremast_tpu_torch worker with FOREMAST_LOCK_WITNESS=1 FOREMAST_INGEST=1: "
              f"{OPS_CLI_DOCS} docs pushed and judged in {run['seconds']:.1f} s (its 'worker started' record "
              f"{up[0] if up else float('nan'):.1f} s after the start, its first judging ticks {judging[:2]} s), "
              f"SIGTERM exit 0; "
              f"exit log "
              f"\"{verdict[0]['msg']}\"; /debug/state env_overrides = the {len(state['env_overrides'])} registered "
              f"knobs it was started with ({', '.join(sorted(state['env_overrides']))})")
        launches = dict(K.LAUNCHES)

        # (d) manifests and lint
        t0 = time.perf_counter()
        out = os.path.join(workdir, "deploy_torch")
        rendered = {os.path.relpath(p, out).replace(os.sep, "/") for p in render(out)}
        committed_root = os.path.join(ROOT, "deploy_torch")
        committed = {os.path.relpath(os.path.join(d, f), committed_root).replace(os.sep, "/")
                     for d, _, files in os.walk(committed_root) for f in files}
        check(rendered == committed, f"phase 15: (d) rendered files {sorted(rendered ^ committed)} differ from deploy_torch/")
        for rel in sorted(rendered):
            with open(os.path.join(out, rel), "rb") as a, open(os.path.join(committed_root, rel), "rb") as b:
                check(a.read() == b.read(), f"phase 15: (d) deploy_torch/{rel} is not what the generator renders")
        problems = lint_registry(reg)
        check(problems == [], f"phase 15: (d) the lint over (b)'s worker registry: {problems}")
        n_families = len(list(reg.collect()))
        parts["d"] = time.perf_counter() - t0
        print(f"phase 15: (d) {len(rendered)} manifests rendered equal the committed deploy_torch/; the lint finds "
              f"nothing in (b)'s worker registry ({n_families} families)")

    # after the readings: each call's device time, beside the trace's
    for kname, (call, fn) in calls.items():
        ms = cuda_ms(fn)
        print(f"phase 15: (a) {kname}: {launched_calls[kname]} launch(es) in the trace, {device_us[kname]:.1f} "
              f"device us summed from the trace; {call} {ms:.4f} ms per call by cuda_ms on {smi}")
    print(f"phase 15: passed in {time.perf_counter() - t_phase:.1f} s (native library {parts['native']:.1f}, "
          f"a {parts['a']:.1f}, b {parts['b']:.1f}, c {parts['c']:.1f}, d {parts['d']:.1f}); launches {launches}")
    return launches


# -- phase 16: pod mode ------------------------------------------------------

POD_RANKS = 2
POD_DOCS = 256  # (a): x 4 aliases, the cold and warm ticks (cut from 512: the phase's 60 s budget)
POD_F32_DOCS = 128  # (a): the f32 cold tick of a fresh pod (cut from 256)
POD_CLI_DOCS = 64  # (b)
POD_DEATH_DOCS = 64  # (c)
POD_TIMEOUT = 10  # (c): FOREMAST_POD_TIMEOUT_SECONDS of the dying pod
POD_FOLLOWER_GRACE = 15.0  # (c): the follower exits within POD_TIMEOUT + this after the leader died
POD_BAND_TOL = 1e-5  # (a): last band points, pod against the single worker on the card
POD_RANK_TIMEOUT = 180.0  # seconds for a rank process


def band_recorder(into: dict):
    """on_verdict hook: each (doc, alias)'s last band point, as floats."""

    def on_verdict(doc, verdicts):
        for v in verdicts:
            up = np.asarray(v.upper, np.float32).ravel()
            lo = np.asarray(v.lower, np.float32).ravel()
            into[f"{doc.id}|{v.alias}"] = [float(up[-1]) if up.size else None, float(lo[-1]) if lo.size else None]

    return on_verdict


def store_written(store) -> dict:
    return {
        d.id: json.dumps([d.status, d.status_code, d.reason, d.anomaly_info], sort_keys=True)
        for d in store._docs.values()
    }


def pod_parity_rank(workdir: str, t_now: int, device: str) -> None:
    """16(a), one rank: PodWorkers over the leader's in-memory store and
    source, (a) cold and (b) warm over POD_DOCS docs on the default route,
    then (d) a fresh pod's cold tick over POD_F32_DOCS docs with only the
    leader's environment setting FOREMAST_BF16_DELTA=0. Writes what it saw
    (its launches, broadcasts and gathers a tick; the leader's writes and
    bands) to `pod-parity-rank<r>.json`. The ticks wait for the parent's
    `pod-go` file: the single worker's reference runs while the ranks
    start, never beside their ticks."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import Document, InMemoryStore
    from foremast_tpu_torch.ops import kernels as K
    from foremast_tpu_torch.parallel import LeaderSource, LeaderStore, PodWorker, init_distributed, is_leader
    from foremast_tpu_torch.parallel import distributed as D

    check(init_distributed(), "the rank did not join a pod (JAX_* rendezvous unset)")
    leader = is_leader()
    rank = torch.distributed.get_rank()
    cuda = torch.device(device).type == "cuda"
    docs = data = None
    if leader:
        docs, data, _ = worker_fleet(POD_DOCS, t_now)
    out = {"rank": rank, "ticks": {}, "written": {}, "bands": {}}

    def new_pod(n: int):
        store = source = None
        if leader:
            store = InMemoryStore()
            for d in docs[:n]:
                store.create(Document.from_json(d))
            source = array_source(data)
        bands: dict = {}
        worker = PodWorker(LeaderStore(store), LeaderSource(source), config=BrainConfig(max_cache_size=4 * n + 64),
                           device=device, claim_limit=n, worker_id="smoke-pod",
                           on_verdict=band_recorder(bands) if leader else None)
        if cuda:
            worker.warmup()  # local: a plain judge of its own, no collective
        return worker, store, bands

    def tick(name: str, worker, store, bands: dict, n: int, now: float) -> None:
        uni = worker.judge.univariate
        launches, casts, gathers = dict(K.LAUNCHES), dict(D.BROADCASTS), dict(uni.mesh_stats)
        bands.clear()
        sync_card()
        t0 = time.perf_counter()
        got = worker.tick(now=now)
        sync_card()
        seconds = time.perf_counter() - t0
        check(got == n, f"16(a) rank {rank}: tick {name} judged {got} of {n} docs")
        out["ticks"][name] = dict(
            seconds=seconds,
            launched={k: K.LAUNCHES[k] - v for k, v in launches.items()},
            broadcasts={k: D.BROADCASTS[k] - v for k, v in casts.items()},
            gathers={k: uni.mesh_stats[k] - gathers[k] for k in ("gathers", "gather_seconds", "gather_bytes")},
            fetch_seconds=uni.mesh_stats["fetch_seconds"] - gathers["fetch_seconds"],
        )
        if leader:
            out["written"][name] = store_written(store)
            out["bands"][name] = dict(bands)

    worker, store, bands = new_pod(POD_DOCS)
    deadline = time.monotonic() + POD_RANK_TIMEOUT
    while not os.path.exists(os.path.join(workdir, "pod-go")):
        check(time.monotonic() < deadline, f"16(a) rank {rank}: the parent never said go")
        time.sleep(0.05)
    pod = worker.judge.univariate.mesh.pod
    out.update(backend=pod.backend, reason=pod.reason, blocks=[pod.first, pod.first + pod.n_local - 1],
               n_data=pod.n_data, device=str(worker.judge.device))
    tick("a", worker, store, bands, POD_DOCS, t_now + 150)
    tick("b", worker, store, bands, POD_DOCS, t_now + 200)
    worker.close()
    if leader:
        os.environ["FOREMAST_BF16_DELTA"] = "0"
    fresh, fstore, fbands = new_pod(POD_F32_DOCS)
    out["f32_route"] = not scoring.bf16_delta_enabled()
    tick("d", fresh, fstore, fbands, POD_F32_DOCS, t_now + 150)
    fresh.close()
    with open(os.path.join(workdir, f"pod-parity-rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def pod_death_rank(workdir: str, t_now: int, device: str, es_url: str) -> None:
    """16(c), one rank: a PodWorker over the fake Elasticsearch whose
    leader calls os._exit(17) on its 3rd fetch (after the claim, before
    any verdict); the follower must not get past the tick."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.parallel import LeaderSource, LeaderStore, PodWorker, init_distributed, is_leader

    check(init_distributed(), "the rank did not join a pod (JAX_* rendezvous unset)")
    rank = torch.distributed.get_rank()
    store = source = None
    if is_leader():
        _, data, _ = worker_fleet(POD_DEATH_DOCS, t_now, seed=29)
        inner = array_source(data)
        calls = [0]

        class Dying(type(inner)):
            def fetch(self, url):
                calls[0] += 1
                if calls[0] >= 3:
                    os._exit(17)  # a crash: no cleanup, no error marker broadcast
                return inner.fetch(url)

        store, source = ElasticsearchStore(es_url), Dying()
    worker = PodWorker(LeaderStore(store), LeaderSource(source),
                       config=BrainConfig(max_stuck_seconds=90.0, max_cache_size=4 * POD_DEATH_DOCS + 64),
                       device=device, claim_limit=POD_DEATH_DOCS, worker_id="smoke-pod")
    print(f"rank {rank} ticking", flush=True)
    worker.tick(now=t_now + 150)
    print(f"rank {rank} SURVIVED", flush=True)  # reachable only on a fault


def pod_rank_main(argv: list) -> int:
    """`chip_smoke.py --pod-rank <arm> <workdir> <t_now> <device> [es_url]`:
    one rank of a phase 16 pod (the JAX_* rendezvous in its environment)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    arm, workdir, t_now, device = argv[0], argv[1], int(argv[2]), argv[3]
    # the parent's sizes (a rehearsal may lower them)
    with open(os.path.join(workdir, "pod-sizes.json")) as fh:
        globals().update(json.load(fh))
    if arm == "parity":
        pod_parity_rank(workdir, t_now, device)
    elif arm == "death":
        pod_death_rank(workdir, t_now, device, argv[4])
    else:
        check(False, f"unknown pod arm {arm}")
    return 0


def pod_env(addr: str, rank: int, n_cards: int, extra: dict | None = None) -> dict:
    """A rank's environment: the JAX_* rendezvous, and on a host of 2+
    cards its own card (CUDA_VISIBLE_DEVICES), so the gather takes NCCL;
    on one card both ranks share it over gloo."""
    env = {k: v for k, v in os.environ.items() if k not in ("FOREMAST_BF16_DELTA", "FOREMAST_POD_TIMEOUT_SECONDS")}
    env.update(JAX_COORDINATOR_ADDRESS=addr, JAX_NUM_PROCESSES=str(POD_RANKS), JAX_PROCESS_ID=str(rank),
               PYTHONPATH=ROOT, **(extra or {}))
    if n_cards >= POD_RANKS:
        env["CUDA_VISIBLE_DEVICES"] = str(rank)
    return env


def pod_launch(cmd_of, workdir: str, tag: str, n_cards: int, extra: dict | None = None) -> tuple[list, list]:
    """Start the POD_RANKS rank processes `cmd_of(rank)`, output to
    `<workdir>/pod-<tag>-rank<r>.log`."""
    addr = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    for rank in range(POD_RANKS):
        path = os.path.join(workdir, f"pod-{tag}-rank{rank}.log")
        with open(path, "w") as log:
            procs.append(subprocess.Popen(cmd_of(rank), cwd=ROOT, env=pod_env(addr, rank, n_cards, extra),
                                          stdout=log, stderr=subprocess.STDOUT))
        logs.append(path)
    return procs, logs


def pod_finish(procs, logs, tag: str, timeout: float = POD_RANK_TIMEOUT, expect=None) -> list:
    """Wait for every rank (killing one past `timeout`); their exit codes.
    A rank's log is printed when it exited otherwise than `expect` (by
    default 0 for every rank)."""
    deadline = time.monotonic() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    for rank, (rc, path) in enumerate(zip(rcs, logs)):
        if rc != (expect[rank] if expect is not None else 0):
            print(f"(16 {tag}) rank {rank} exited {rc}:\n{open(path).read()[-6000:]}", file=sys.stderr)
    return rcs


def pod_single_reference(dev, docs, data, t_now: int) -> dict:
    """16(a)'s single-process port worker on the card: the same ticks over
    the same fleet, (d) on the f32 route."""
    import torch

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.engine import scoring
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore

    out = {}

    def run(n: int, ticks) -> None:
        store = InMemoryStore()
        for d in docs[:n]:
            store.create(Document.from_json(d))
        bands: dict = {}
        worker = BrainWorker(store, array_source(data), config=BrainConfig(max_cache_size=4 * n + 64), device=dev,
                             claim_limit=n, worker_id="smoke-single", on_verdict=band_recorder(bands),
                             device_mesh=None)
        if torch.device(dev).type == "cuda":
            worker.warmup()
        for name, now in ticks:
            bands.clear()
            sync_card()
            t0 = time.perf_counter()
            check(worker.tick(now=now) == n, f"16(a) the single worker's tick {name} lost docs")
            sync_card()
            out[name] = dict(seconds=time.perf_counter() - t0, written=store_written(store), bands=dict(bands))
        worker.close()

    run(POD_DOCS, (("a", t_now + 150), ("b", t_now + 200)))
    scoring.set_bf16_delta(False)
    try:
        run(POD_F32_DOCS, (("d", t_now + 150),))
    finally:
        scoring.set_bf16_delta(None)
    return out


def pod_parity_arm(dev, smi: str, workdir: str, n_cards: int) -> dict:
    """16(a): the pod's ticks against the single worker's, doc for doc;
    returns the pod's launches (both ranks, every tick)."""
    t_now = int(time.time())
    t0 = time.perf_counter()
    procs, logs = pod_launch(
        lambda rank: [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--pod-rank", "parity", workdir, str(t_now),
                      str(dev)],
        workdir, "parity", n_cards)
    # the single worker runs while the ranks start, and they tick only
    # after it is done (`pod-go`); its launches are a comparison's, not
    # the pod's (the ranks count their own)
    try:
        docs, data, _ = worker_fleet(POD_DOCS, t_now)
        with uncounted():
            single = pod_single_reference(dev, docs, data, t_now)
    finally:
        open(os.path.join(workdir, "pod-go"), "w").close()
    rcs = pod_finish(procs, logs, "a")
    check(rcs == [0] * POD_RANKS, f"16(a) the pod's ranks exited {rcs}")
    arm_s = time.perf_counter() - t0
    ranks = []
    for rank in range(POD_RANKS):
        with open(os.path.join(workdir, f"pod-parity-rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    lead = ranks[0]
    check(len({r["backend"] for r in ranks}) == 1, "16(a) the ranks chose different gather backends")
    want_backend = "nccl" if n_cards >= POD_RANKS else "gloo"
    check(lead["backend"] == want_backend, f"16(a) the gather ran over {lead['backend']}, want {want_backend}")
    check(all(r["f32_route"] for r in ranks), "16(a) a rank's fresh pod did not take the leader's f32 route")
    worst = 0.0
    for name in ("a", "b", "d"):
        got, want = lead["written"][name], single[name]["written"]
        diff = [k for k in want if got.get(k) != want[k]]
        check(set(got) == set(want) and not diff,
              f"16(a) tick {name}: {len(diff)} docs differ from the single worker's, e.g. {diff[:3]}")
        gb, wb = lead["bands"][name], single[name]["bands"]
        check(set(gb) == set(wb) and gb, f"16(a) tick {name}: band keys differ ({len(gb)} against {len(wb)})")
        for key, (u, lo) in wb.items():
            for a, b in zip(gb[key], (u, lo)):
                if a is None or b is None or (a != a and b != b):
                    check((a is None) == (b is None) and (a is None or (a != a) == (b != b)),
                          f"16(a) tick {name}: {key} bands {gb[key]} against {[u, lo]}")
                    continue
                worst = max(worst, abs(a - b))
        check(worst <= POD_BAND_TOL, f"16(a) tick {name}: bands differ by {worst:.3g} > {POD_BAND_TOL}")
    for r in ranks:
        check(r["ticks"]["d"]["launched"]["masked_stats"] > 0,
              f"16(a) rank {r['rank']}'s f32 cold tick never launched masked_stats")
    launched = {k: sum(r["ticks"][t]["launched"][k] for r in ranks for t in ("a", "b", "d")) for k in KERNEL_FILES}
    print(f"phase 16: (a) {POD_RANKS} ranks, {lead['n_data']} data-axis blocks, result gather over {lead['backend']} "
          f"({lead['reason']}); rank devices {[r['device'] for r in ranks]}; blocks {[r['blocks'] for r in ranks]}")
    print(f"phase 16: (a) every doc's (status, code, reason, anomaly_info) after the cold, warm and f32 cold ticks "
          f"equals the single worker's on the card ({POD_DOCS}, {POD_DOCS} and {POD_F32_DOCS} docs x 4 aliases, "
          f"Th={FULL_TH}, Tc={FULL_TC}); last band points within {worst:.3g} (tolerance {POD_BAND_TOL}); the "
          f"follower took the f32 route from the leader's knob broadcast")
    for name, label in (("a", "cold"), ("b", "warm"), ("d", "f32 cold")):
        parts = []
        for r in ranks:
            t = r["ticks"][name]
            b, g = t["broadcasts"], t["gathers"]
            parts.append(f"rank {r['rank']} {t['seconds']:.3f} s (broadcasts {b['calls']}, {b['bytes']} B, "
                         f"{b['seconds']:.3f} s; gathers {g['gathers']}, {g['gather_bytes']} B, "
                         f"{g['gather_seconds']:.4f} s; fetch {t['fetch_seconds']:.4f} s; launches "
                         f"{ {k: v for k, v in t['launched'].items() if v} })")
        print(f"phase 16: (a) {label} tick on {smi}: single worker {single[name]['seconds']:.3f} s; pod "
              + "; ".join(parts))
    print(f"phase 16: (a) took {arm_s:.1f} s (rank start-up included)")
    return launched


def pod_cli_arm(dev, workdir: str, n_cards: int) -> None:
    """16(b): two `python -m foremast_tpu_torch worker --sharded` ranks with
    the JAX_* rendezvous judge a POD_CLI_DOCS-doc fleet on the fake
    Elasticsearch and Prometheus to the single worker's writes; only the
    leader serves the gauge port; a SIGTERM to the leader stops both."""
    import importlib.util
    import signal

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.jobs.store import ElasticsearchStore
    from foremast_tpu_torch.metrics.source import PrometheusSource

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, FakePrometheus, rebase, serve_fake_es, serve_fake_prometheus

    # endTime an hour past (every doc terminal on its first judgment, so
    # the pod does not re-claim the fleet tick after tick) and settled
    # histories
    t_now = int(time.time()) - 7200
    docs, data, _ = worker_fleet(POD_CLI_DOCS, t_now, seed=23)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    prom = FakePrometheus()
    prom_srv, prom_url = serve_fake_prometheus(prom)
    try:
        docs, prom.data = rebase(docs, data, "http://prom", prom_url)
        prom.prepare()  # set-up: every answer encoded before the ranks start
        check(ElasticsearchStore(es_url).wait_ready(max_wait=30), "16(b) the fake Elasticsearch never answered")
        es.load(docs)
        gauges = [free_port() for _ in range(POD_RANKS)]
        metrics = importlib.util.find_spec("prometheus_client") is not None
        t0 = time.perf_counter()
        base = dict(es.writes)
        procs, logs = pod_launch(
            lambda rank: [sys.executable, "-m", "foremast_tpu_torch", "worker", "--sharded", "--device", str(dev),
                          "--elastic-url", es_url, "--gauge-port", str(gauges[rank] if metrics else 0),
                          "--poll", "0.2"],
            workdir, "cli", n_cards)
        served = refused = False
        try:
            while not all_judged(es, base):
                check(all(p.poll() is None for p in procs) and time.perf_counter() - t0 < POD_RANK_TIMEOUT,
                      "16(b) the pod did not judge the fleet")
                time.sleep(0.25)
            judged_s = time.perf_counter() - t0
            if metrics:
                with urllib.request.urlopen(f"http://127.0.0.1:{gauges[0]}/metrics", timeout=10) as r:
                    served = r.status == 200 and b"foremast_tick_stage_seconds" in r.read()
                try:
                    urllib.request.urlopen(f"http://127.0.0.1:{gauges[1]}/metrics", timeout=5)
                except OSError:
                    refused = True
        finally:
            if procs[0].poll() is None:
                procs[0].send_signal(signal.SIGTERM)
            rcs = pod_finish(procs, logs, "b", timeout=60)
        check(rcs == [0] * POD_RANKS, f"16(b) the CLI ranks exited {rcs} after the leader's SIGTERM")
        texts = [open(p).read() for p in logs]
        for rank, text in enumerate(texts):
            check(f"pod mode: rank {rank} of {POD_RANKS}" in text, f"16(b) rank {rank} never logged its pod line")
        # the single worker over the same HTTP fakes, at the real clock
        ref_store = InMemoryStore()
        for d in docs:
            ref_store.create(Document.from_json(d))
        with uncounted():
            ref = BrainWorker(ref_store, PrometheusSource(), config=BrainConfig(max_cache_size=4 * len(docs) + 64),
                              device=dev, claim_limit=len(docs), worker_id="smoke-single", device_mesh=None)
            check(ref.tick() == len(docs), "16(b) the single worker lost docs")
            ref.close()
        got = es_written(es.sources())
        want = store_written(ref_store)
        diff = [k for k in want if got.get(k) != want[k]]
        check(not diff, f"16(b) {len(diff)} docs differ from the single worker's, e.g. {diff[:3]}")
        if metrics:
            check(served and refused, f"16(b) /metrics: leader served {served}, follower refused {refused}")
        line = next(ln for ln in texts[0].splitlines() if ln.startswith("pod mode: rank 0"))
        stops = []
        for text in texts:
            rec = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{") and '"worker stopped"' in ln]
            stops.append(rec[-1].get("kernel_launches") if rec else None)
        print(f"phase 16: (b) two `worker --sharded --device {dev}` ranks judged the {POD_CLI_DOCS}-doc fleet in "
              f"{judged_s:.1f} s from start, writes equal the single worker's; {line!r}; /metrics "
              f"{'served by the leader alone' if metrics else 'not checked (no prometheus_client on this host)'}; "
              f"both exited 0 on the leader's SIGTERM; launches by rank {stops}")
    finally:
        for srv in (es_srv, prom_srv):
            srv.shutdown()
            srv.server_close()


def pod_death_arm(dev, workdir: str, n_cards: int) -> None:
    """16(c): the leader dies on its 3rd fetch with POD_TIMEOUT; the
    follower exits nonzero within POD_TIMEOUT + POD_FOLLOWER_GRACE of it;
    a single takeover worker judges every parked doc exactly once, to the
    single worker's writes."""
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker, Document, InMemoryStore
    from foremast_tpu_torch.jobs.store import ElasticsearchStore

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fake_services import FakeElasticsearch, serve_fake_es

    t_now = int(time.time()) - 600
    docs, data, _ = worker_fleet(POD_DEATH_DOCS, t_now, seed=29)
    es_srv, es, es_url = serve_fake_es(FakeElasticsearch())
    try:
        check(ElasticsearchStore(es_url).wait_ready(max_wait=30), "16(c) the fake Elasticsearch never answered")
        es.load(docs)
        procs, logs = pod_launch(
            lambda rank: [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--pod-rank", "death", workdir,
                          str(t_now), str(dev), es_url],
            workdir, "death", n_cards, {"FOREMAST_POD_TIMEOUT_SECONDS": str(POD_TIMEOUT)})
        ended = [None] * POD_RANKS
        deadline = time.monotonic() + POD_RANK_TIMEOUT
        while None in ended and time.monotonic() < deadline:
            for rank, p in enumerate(procs):
                if ended[rank] is None and p.poll() is not None:
                    ended[rank] = time.monotonic()
            time.sleep(0.05)
        rcs = pod_finish(procs, logs, "c", timeout=1, expect=[17, 1])
        texts = [open(p).read() for p in logs]
        check(rcs[0] == 17, f"16(c) the leader exited {rcs[0]}, not by its os._exit(17)")
        check(rcs[1] != 0 and "SURVIVED" not in texts[1] and "rank 1 ticking" in texts[1],
              f"16(c) the follower exited {rcs[1]}: {texts[1][-2000:]}")
        lag = ended[1] - ended[0]
        check(lag <= POD_TIMEOUT + POD_FOLLOWER_GRACE, f"16(c) the follower outlived the leader by {lag:.1f} s")
        cause = [ln for ln in texts[1].splitlines() if "PodCollective" in ln]
        parked = sum(1 for d in es.sources().values() if d.get("status") == "preprocess_inprogress")
        check(parked > 0, "16(c) the leader died before persisting any claim")
        # the takeover: one worker on the card, past the stuck window
        base = dict(es.writes)
        with uncounted():
            takeover = BrainWorker(ElasticsearchStore(es_url), array_source(data),
                                   config=BrainConfig(max_stuck_seconds=2.0, max_cache_size=4 * len(docs) + 64),
                                   device=dev, claim_limit=len(docs), worker_id="takeover", device_mesh=None)
            total = 0
            t0 = time.perf_counter()
            while total < len(docs) and time.perf_counter() - t0 < 60:
                time.sleep(1.0)
                total += takeover.tick(now=t_now + 7200)
            check(total == len(docs), f"16(c) the takeover judged {total} of {len(docs)} docs")
            check(takeover.tick(now=t_now + 7300) == 0, "16(c) the takeover found a doc to judge twice")
            takeover.close()
            ref_store = InMemoryStore()
            for d in docs:
                ref_store.create(Document.from_json(d))
            ref = BrainWorker(ref_store, array_source(data),
                              config=BrainConfig(max_cache_size=4 * len(docs) + 64), device=dev,
                              claim_limit=len(docs), worker_id="smoke-single", device_mesh=None)
            check(ref.tick(now=t_now + 7200) == len(docs), "16(c) the single worker lost docs")
            ref.close()
        srcs = es.sources()
        check(all(s.get("processingContent") == "takeover" for s in srcs.values()),
              "16(c) a doc was last claimed by another worker than the takeover")
        once = [k for k in srcs if es.writes[k] - base.get(k, 0) != 2]
        check(not once, f"16(c) docs not written exactly once by the takeover (claim + verdict): {once[:3]}")
        got, want = es_written(srcs), store_written(ref_store)
        diff = [k for k in want if got.get(k) != want[k]]
        check(not diff, f"16(c) {len(diff)} docs differ from the single worker's, e.g. {diff[:3]}")
        print(f"phase 16: (c) the leader died on its 3rd fetch with {parked} of {len(docs)} docs parked in progress; "
              f"the follower exited {rcs[1]} {lag:.1f} s later (FOREMAST_POD_TIMEOUT_SECONDS={POD_TIMEOUT}; "
              f"{cause[-1][:200] if cause else 'no PodCollective line'}); the takeover judged every doc exactly "
              f"once after the {2.0:.0f} s stuck window, writes equal the single worker's")
    finally:
        es_srv.shutdown()
        es_srv.server_close()


def phase_pod(dev, smi: str) -> dict:
    """Phase 16: pod mode, two ranks over torch.distributed (gloo for host
    objects; the result gather over gloo when the ranks share the one
    card, over NCCL when each rank has a card of its own): (a) parity,
    then (b) the CLI and (c) leader death side by side. The kernels and
    the native library are built before the ranks start (a rank only
    loads them). Returns the pod's launches (every rank of (a))."""
    import tempfile
    import threading

    import torch

    from foremast_tpu_torch import native
    from foremast_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        _build.build_all()
    check(native.ensure_built(), f"phase 16: the native packing library did not build ({native.error()})")
    n_cards = torch.cuda.device_count() if cuda else 0
    print(f"phase 16: pod mode, {POD_RANKS} ranks on {smi}: "
          + ("each rank on a card of its own (CUDA_VISIBLE_DEVICES), result gather over NCCL"
             if n_cards >= POD_RANKS else "both ranks on the one card, result gather over gloo"))
    with tempfile.TemporaryDirectory(prefix="foremast-phase16-", ignore_cleanup_errors=True) as workdir:
        with open(os.path.join(workdir, "pod-sizes.json"), "w") as fh:
            json.dump(dict(POD_DOCS=POD_DOCS, POD_F32_DOCS=POD_F32_DOCS, POD_DEATH_DOCS=POD_DEATH_DOCS,
                           FULL_TH=FULL_TH), fh)
        launched = pod_parity_arm(dev, smi, workdir, n_cards)
        # (b) and (c) run side by side (their pods, fakes and ports are
        # their own); neither times anything the other could disturb but
        # (b)'s seconds to a judged fleet
        death: dict = {}

        def run_death() -> None:
            try:
                pod_death_arm(dev, workdir, n_cards)
            except BaseException as e:  # noqa: BLE001 - re-raised on the phase's thread
                death["error"] = e

        side = threading.Thread(target=run_death, name="phase16-death", daemon=True)
        side.start()
        pod_cli_arm(dev, workdir, n_cards)
        side.join(timeout=POD_RANK_TIMEOUT + 120)
        check(not side.is_alive(), "16(c) did not finish")
        if "error" in death:
            raise death["error"]
    print(f"phase 16: passed in {time.perf_counter() - t0:.1f} s; the pod's launches (both ranks, (a)) {launched}")
    return launched


def main() -> int:
    import torch

    t_main = time.perf_counter()
    if "--pod-rank" in sys.argv[1:]:
        # one rank of a phase 16 pod, started by the phase itself
        sys.path.insert(0, ROOT)
        return pod_rank_main(sys.argv[sys.argv.index("--pod-rank") + 1 :])
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from foremast_tpu_torch.ops import _build
    from foremast_tpu_torch.ops import kernels as K

    kernels_only = "--kernels-only" in sys.argv[1:]
    deployable_only = "--deployable-only" in sys.argv[1:]
    tenants_only = "--tenants-only" in sys.argv[1:]
    mesh_only = "--mesh-only" in sys.argv[1:]
    device_mesh_only = "--device-mesh-only" in sys.argv[1:]
    control_loop_only = "--control-loop-only" in sys.argv[1:]
    dashboard_only = "--dashboard-only" in sys.argv[1:]
    ops_only = "--ops-only" in sys.argv[1:]
    pod_only = "--pod-only" in sys.argv[1:]
    # the seasonal model's f32 products must not round through TF32 (its
    # normal equations run in float64, which never does)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # every worker of phases 3-11 (and the CLI runs they start) judges on
    # one card whatever the host holds; phase 12 passes its meshes itself
    os.environ["FOREMAST_DEVICE_MESH"] = "off"
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
    import importlib.util

    print("phase 1: optional packages on this host (the port needs none of them): " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("aiohttp", "yaml", "requests", "prometheus_client")))
    build_s = _build.build_all()
    print(f"phase 1: kernels built in {build_s:.1f} s")
    for kname in KERNEL_FILES:
        for line in ptxas_report(kname):
            print(f"phase 1: {kname}: {line}")

    if deployable_only:
        os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
        t_now = int(time.time())
        docs, data, _ = worker_fleet(WORKER_DOCS, t_now)
        launched = phase_deployable_worker(dev, smi, fit_cache_fleet(FIT_FLEET)[0], (docs, data, t_now))
        print(f"chip_smoke: --deployable-only: phase 9 passed; its main path launched {launched}")
        return 0
    if mesh_only:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        phase_mesh(dev, smi)
        check(K.LAUNCHES["masked_stats"] > 0, "phase 11 never launched masked_stats")
        print(f"chip_smoke: --mesh-only: phase 11 passed; its main path launched {dict(K.LAUNCHES)}")
        return 0
    if device_mesh_only:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        phase_device_mesh(dev, smi)
        for kname in ("masked_stats", "ma_judgment", "ma_judgment_bf16_delta", "lstm_ae_forward"):
            check(K.LAUNCHES[kname] > 0, f"phase 12 never launched {kname}")
        print(f"chip_smoke: --device-mesh-only: phase 12 passed; its main path launched {dict(K.LAUNCHES)}")
        return 0
    if control_loop_only:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        phase_control_loop(dev, smi)
        check(K.LAUNCHES["masked_stats"] > 0, "phase 13 never launched masked_stats")
        print(f"chip_smoke: --control-loop-only: phase 13 passed; its main path launched {dict(K.LAUNCHES)}")
        return 0
    if dashboard_only:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        phase_dashboard(dev, smi)
        check(K.LAUNCHES["masked_stats"] > 0, "phase 14 never launched masked_stats")
        print(f"chip_smoke: --dashboard-only: phase 14 passed; its main path launched {dict(K.LAUNCHES)}")
        return 0
    if ops_only:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        launched = phase_ops(dev, smi)
        for kname in MA_KERNELS:
            check(launched[kname] > 0, f"phase 15 never launched {kname}")
        print(f"chip_smoke: --ops-only: phase 15 passed; its main path launched {launched}")
        return 0
    if pod_only:
        launched = phase_pod(dev, smi)
        check(launched["masked_stats"] > 0, "phase 16 never launched masked_stats")
        print(f"chip_smoke: --pod-only: phase 16 passed; its main path launched {launched}")
        return 0
    if tenants_only:
        os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        phase_tenants_and_chaos(dev, smi, costs=True)
        check(K.LAUNCHES["masked_stats"] > 0, "phase 10 never launched masked_stats")
        print(f"chip_smoke: --tenants-only: phase 10 passed; its main path launched {dict(K.LAUNCHES)}")
        return 0
    worst = phase_kernels_vs_plain(dev)
    worst.update(phase_scan_kernels_vs_plain(dev))
    worst.update(phase_lstm_kernels_vs_plain(dev))
    if kernels_only:
        time_scan_kernels(dev, peak_bytes, sm_clock_hz)
        print("chip_smoke: --kernels-only: every kernel built and equals its plain version; the scans were timed")
        return 0

    # each main path runs with the launch counts zeroed just before it and
    # read just after; the timing loops run after the readings
    started = time.perf_counter()

    def path(fn, *args):
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"chip_smoke: {fn.__name__} took {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - started:.1f} s since the kernels were checked)")
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
    worker_run, launched_worker = path(phase_worker, dev, smi, fit_cache["seconds"]["c"])
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
    group, launched_group = path(phase_lstm_group, dev)
    _, launched_quality = path(phase_joint_quality, dev)
    joint, launched_joint_worker = path(phase_joint_worker, dev, smi)
    for label, got in (("cold LSTM group (phase 8b)", launched_group),
                       ("joint quality gates (phase 8c)", launched_quality),
                       ("joint worker fleet tick (phase 8d)", launched_joint_worker)):
        for kname in ("lstm_ae_forward", "lstm_ae_backward", "holt_winters_scan"):
            check(got[kname] > 0, f"the {label} never launched {kname}")
    # phase 9 reads its counts itself: its in-process pull and push passes
    # (the bf16 default launches no kernel; the push arm's f32 pass
    # launches masked_stats), the admission arm (its f32 route launches
    # masked_stats), the micro-tick arm, and the CLI subprocess's f32 run
    t0 = time.perf_counter()
    launched_deploy = phase_deployable_worker(dev, smi, fit_cache["tasks"], worker_run["fleet"])
    print(f"chip_smoke: phase_deployable_worker took {time.perf_counter() - t0:.1f} s")
    check(launched_deploy["masked_stats"] > 0, "the deployable worker (phase 9) never launched masked_stats")
    _, launched_tenants = path(phase_tenants_and_chaos, dev, smi)
    check(launched_tenants["masked_stats"] > 0, "the tenanted f32 cold sweep (phase 10) never launched masked_stats")
    _, launched_mesh = path(phase_mesh, dev, smi)
    check(launched_mesh["masked_stats"] > 0, "the mesh's f32 refit of orphans (phase 11 d) never launched masked_stats")
    _, launched_device_mesh = path(phase_device_mesh, dev, smi)
    for kname in ("masked_stats", "ma_judgment", "ma_judgment_bf16_delta", "lstm_ae_forward"):
        check(launched_device_mesh[kname] > 0, f"the device mesh (phase 12) never launched {kname}")
    _, launched_control_loop = path(phase_control_loop, dev, smi)
    check(launched_control_loop["masked_stats"] > 0, "the control loop's f32 arm (phase 13 b) never launched masked_stats")
    _, launched_dashboard = path(phase_dashboard, dev, smi)
    check(launched_dashboard["masked_stats"] > 0, "the demo runbook's f32 arm (phase 14 a) never launched masked_stats")
    # phase 15 reads its counts itself, before its timing loops
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    launched_ops = phase_ops(dev, smi)
    print(f"chip_smoke: phase_ops took {time.perf_counter() - t0:.1f} s "
          f"({time.perf_counter() - started:.1f} s since the kernels were checked)")
    for kname in MA_KERNELS:
        check(launched_ops[kname] > 0, f"the profiled calls (phase 15 a) never launched {kname}")
    # phase 16's ranks count their own launches around their ticks
    t0 = time.perf_counter()
    launched_pod = phase_pod(dev, smi)
    print(f"chip_smoke: phase_pod took {time.perf_counter() - t0:.1f} s "
          f"({time.perf_counter() - started:.1f} s since the kernels were checked)")
    check(launched_pod["masked_stats"] > 0, "the pod's f32 cold tick (phase 16 a) never launched masked_stats")
    paths = {
        "object path (phases 3-4)": launched_object,
        "fit-cache path (phase 5)": launched_fit_cache,
        "worker fleet tick (phase 6)": launched_worker,
        "cold fits of every algorithm (phase 7b)": launched_fits,
        "seasonal fit-cache fleet (phase 7c)": launched_seasonal,
        "seasonal worker fleet tick (phase 7d)": launched_seasonal_worker,
        "cold LSTM group (phase 8b)": launched_group,
        "joint quality gates (phase 8c)": launched_quality,
        "joint worker fleet tick (phase 8d)": launched_joint_worker,
        "deployable worker (phase 9, with the CLI's f32 run)": launched_deploy,
        "tenants and chaos (phase 10)": launched_tenants,
        "worker mesh (phase 11)": launched_mesh,
        "device mesh (phase 12)": launched_device_mesh,
        "control loop (phase 13)": launched_control_loop,
        "dashboard and demo loop (phase 14)": launched_dashboard,
        "profiler, witness, manifests and lint (phase 15)": launched_ops,
        "pod mode, both ranks (phase 16)": launched_pod,
    }
    print("launches: " + "; ".join(f"{label} {counts}" for label, counts in paths.items()))
    launches = {k: sum(counts[k] for counts in paths.values()) for k in KERNEL_FILES}

    scan = time_scan_kernels(dev, peak_bytes, sm_clock_hz)
    for kname in ("holt_winters_scan", "holt_scan"):
        timings[kname] = scan[kname]
        full_err[kname] = scan[kname]["full_err"]
    lstm = time_lstm_kernels(dev, group["hist"], peak_bytes, sm_clock_hz)
    for kname in ("lstm_ae_forward", "lstm_ae_backward"):
        timings[kname] = lstm[kname]
        full_err[kname] = lstm[kname]["full_err"]
    profile_joint_cold_tick(dev, joint["fleet"])

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_main:.1f} s of this process")
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
