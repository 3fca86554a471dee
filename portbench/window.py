"""One run of a cell: set-up, the measured window, the check.

The window drives `foremast_tpu_torch.jobs.BrainWorker.tick`, sweep
after sweep (a closed loop: the worker sweeps again as soon as a sweep
ends, as a worker that is behind does), over the harness's store and
source. Before each sweep the mix's generator moves every window on and
creates the sweep's newcomers. Set-up runs the fleet's first (cold)
sweep and WARMUP_SWEEPS sweeps of the mix itself, so every shape the
window uses has run once before it opens.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import statistics
import sys
import threading
import time

from portbench import check, fleet, spec, stores, tracing

WARMUP_SWEEPS = 2  # sweeps of the mix in set-up, after the fleet's cold sweep
PROFILE_SECONDS = 1.0  # a traced run profiles the window's sweeps up to this many seconds


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric reader reads (`metrics/<name>.py`)."""

    spans: list  # (name, stage, trace id, start, end, root) of the window's ticks
    windows: int  # (document, metric) windows given a verdict in the window
    newcomer_windows: int  # ... of documents created in the window
    device: tracing.DeviceStretch | None
    sweeps: int
    latency: list  # seconds from a newcomer's landing to its first verdict


def apply_env(env: dict) -> None:
    """The process environment of the configuration: its own keys set,
    every other knob of the worker and the judge cleared, so nothing of
    the caller's environment changes the run."""
    for key in list(os.environ):
        if key.startswith(("FOREMAST_", "ML_", "MIN_", "metric_type", "threshold", "bound",
                           "min_lower_bound", "MAX_CACHE_SIZE", "MAX_STUCK_IN_SECONDS")):
            del os.environ[key]
    os.environ.update({k: str(v) for k, v in env.items()})


def run(cell, seed: int, seconds: float, trace: bool, device: str, log, services: int | None = None,
        started: float | None = None) -> dict:
    """Run `cell` once; returns the result line's parts and the check."""
    started = time.perf_counter() if started is None else started
    cfg = cell.config
    apply_env(cfg["env"])
    import torch

    from foremast_tpu_torch import native
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs import BrainWorker
    from foremast_tpu_torch.ops import kernels

    cuda = device == "cuda"
    shape = fleet.FleetShape.from_config(cfg, services)
    traffic = fleet.Traffic.from_dict(cell.traffic)
    reference = spec.reference(cfg["reference"])
    pools = fleet.make_pools(shape, seed, device)
    schedule = fleet.Schedule(shape, traffic, seed)
    urls = fleet.Urls(shape, traffic)
    sampled = {d.id for d in schedule.docs if d.sampled}
    n_aliases: dict = {}
    store = stores.make_store(n_aliases, sampled)
    source = stores.make_source(pools, urls, traffic)
    hook = stores.VerdictLog(sampled)
    tracer = tracing.recording_tracer() if trace else None
    native.ensure_built()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    worker = BrainWorker(
        store, source, config=BrainConfig.from_env(cfg["env"]), device=device,
        worker_id="portbench", claim_limit=int(cfg["claim_limit"]), on_verdict=hook, tracer=tracer,
    )
    worker.warmup(hist_len=shape.history_points, cur_len=shape.current_points)

    def create(docs) -> None:
        for d in docs:
            if d.sampled:
                sampled.add(d.id)
            n_aliases[d.id] = len(shape.aliases)
            store.create(urls.document(d))
        # a rollout lands whole: its documents wait from the moment the
        # last of them is in the store
        landed = time.perf_counter()
        for d in docs:
            store.created[d.id] = landed

    traffic_s = [0.0]
    sweep_s: list = []  # the worker's seconds of each sweep
    sweep_log: list = []  # (start on the host clock, windows judged, newcomer windows, sweep) a sweep
    host_log: list = []  # (collector s, full collections, process CPU s) a sweep
    gc_s = [0.0, 0.0, 0]  # the collector's pauses, the start of the open one, full collections

    def gc_timer(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]
            gc_s[2] += info["generation"] == 2

    def sweep(k: int) -> int:
        """The mix's step (the job service's work: not timed), then one
        sweep of the worker (timed)."""
        t = time.perf_counter()
        pools.ensure(traffic.advance_points * k + shape.current_points)
        born = schedule.newcomers(k)
        create(born)
        source.at_sweep(k)
        store.sweep = hook.sweep = k
        store.judged = set()
        open_before = store.open_count()
        w0 = store.windows
        g0, c0 = list(gc_s), time.process_time()
        t1 = time.perf_counter()
        traffic_s[0] += t1 - t
        worker.tick(now=fleet.now_of(k, traffic.advance_points))
        if cuda:
            torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t1)
        sweep_log.append((t1, store.windows - w0, len(born) * len(shape.aliases), k))
        host_log.append((gc_s[0] - g0[0], gc_s[2] - g0[2], time.process_time() - c0))
        return open_before

    create(schedule.by_sweep[0])
    for k in range(WARMUP_SWEEPS + 1):
        sweep(k)
    if cuda:
        torch.cuda.synchronize()

    # the window: sweeps back to back until the worker has swept for
    # `seconds`; the mix's steps between sweeps, and the profiler's
    # export after its stretch, are not the worker's time
    first = WARMUP_SWEEPS + 1
    k = first
    attempted = failed = 0
    windows0, failed0 = store.windows, store.failed
    launches0 = dict(kernels.LAUNCHES)
    spans0 = len(tracer.spans) if tracer else 0
    prof = tracing.Profiled() if (trace and cuda) else None
    profiled_until = None  # host clock at the end of the profiled stretch
    device_stretch = None

    def end_profile() -> None:
        """Stop the profiler and reduce its trace now, between sweeps, so
        its events leave the heap before the sweeps the spans are read
        from (a profiler held to the end lengthened their collections)."""
        nonlocal prof, profiled_until, device_stretch
        prof.stop()
        profiled_until = time.perf_counter()
        device_stretch = prof.read(tracer.spans[spans0:])
        prof = None
        gc.collect()

    traffic_s[0] = 0.0
    del sweep_s[:], sweep_log[:], host_log[:]
    t_setup = time.perf_counter() - started
    gc.callbacks.append(gc_timer)
    if prof is not None:
        prof.start()
    while True:
        open_before = sweep(k)
        attempted += open_before
        failed += max(0, open_before - len(store.judged))
        k += 1
        if prof is not None and sum(sweep_s) >= PROFILE_SECONDS:
            end_profile()
        if sum(sweep_s) >= seconds:
            break
    if prof is not None:
        end_profile()
    gc.callbacks.remove(gc_timer)
    window_s = sum(sweep_s)
    last = k - 1
    sweeps = last - first + 1
    windows = store.windows - windows0
    failed += store.failed - failed0
    launched = {n: v - launches0.get(n, 0) for n, v in kernels.LAUNCHES.items() if v != launches0.get(n, 0)}
    newcomers = [d for d in schedule.docs if first <= d.birth <= last]
    latency = [store.first_verdict.get(d.id, math.inf) - store.created[d.id] for d in newcomers]
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    spans = []
    read = sweep_log
    if tracer is not None:
        spans = tracer.spans[spans0:]
    if profiled_until is not None:
        # the spans' metrics read the sweeps that ran without the profiler
        # (when the whole window was profiled, all of them)
        later = [x for x in sweep_log if x[0] >= profiled_until]
        if later:
            read = later
            spans = [s for s in spans if s[3] >= profiled_until]
    read_sweeps = {x[3] for x in read}
    ctx = ReadContext(spans=spans, windows=sum(x[1] for x in read), newcomer_windows=sum(x[2] for x in read),
                      device=device_stretch, sweeps=len(read),
                      latency=[x for d, x in zip(newcomers, latency) if d.birth in read_sweeps])

    # free the program's state before the reference runs
    worker.close()
    del worker
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    exp = reference.expected(shape, traffic, schedule, pools, cfg["env"], first, last)
    obs, dup = check.observed(store.log, hook.rows, first, last)
    numbers = check.compare(exp, obs, dup)
    correct, shown = check.verdict(numbers, cfg["checks"])

    log(f"window: {sweeps} sweeps in {window_s:.4f} s ({window_s / sweeps:.4f} s a sweep), "
        f"{windows} windows; the mix's steps between sweeps {traffic_s[0]:.4f} s (not timed)")
    log(f"host: {os.cpu_count()} vCPUs, {len(os.sched_getaffinity(0))} usable, torch's intra-op threads "
        f"{torch.get_num_threads()}, {threading.active_count()} Python threads at the close")
    log("sweep seconds: " + " ".join(f"{x:.4f}" for x in sweep_s))
    log(f"the collector's pauses a sweep ({sum(h[0] for h in host_log):.4f} s, "
        f"{sum(h[1] for h in host_log)} full collections): " + " ".join(f"{h[0]:.4f}" for h in host_log))
    log("full collections a sweep: " + " ".join(str(h[1]) for h in host_log))
    log("process CPU seconds a sweep: " + " ".join(f"{h[2]:.4f}" for h in host_log))
    log(f"kernel launches a sweep: " + (", ".join(f"{n} {v / sweeps:.2f}" for n, v in sorted(launched.items()))
                                        or "none"))
    if latency:
        finite = [x for x in latency if math.isfinite(x)]
        log(f"verdict latency of {len(latency)} newcomers: median {statistics.median(finite):.4f} s, "
            f"p95 {quantile(latency, 0.95):.4f} s, {len(latency) - len(finite)} never judged")
    log(f"check: {numbers['pairs']} (document, sweep) pairs, {numbers['windows_checked']} windows held to "
        f"the reference, {numbers['near']} pairs at an edge left out")
    return dict(
        correct=correct, attempted=attempted, failed=failed, shown=shown, numbers=numbers,
        setup_s=t_setup, window_s=window_s, windows=windows, latency=latency, ctx=ctx, peak=peak,
        device_stretch=device_stretch, sweeps=sweeps,
    )


def quantile(xs, q: float) -> float:
    """The q-quantile of xs by the nearest rank (an infinite sample counts
    as the slowest)."""
    s = sorted(xs)
    if not s:
        return math.nan
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the port's run must not load."""
    banned = {"jax", "jaxlib", "flax", "foremast_tpu", "benchmarks"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)


def control(cell, seed: int, sweeps: int, device: str, services: int | None = None) -> dict:
    """The control of `correct`: the configuration's reference one
    precision step lower (its precision `CONTROL`) put in the program's
    place over the same fleet, mix and sample as a run of `sweeps`
    window sweeps, and compared as a run's outputs are. No worker runs.
    Returns the compared numbers."""
    cfg = cell.config
    reference = spec.reference(cfg["reference"])
    shape = fleet.FleetShape.from_config(cfg, services)
    traffic = fleet.Traffic.from_dict(cell.traffic)
    first, last = WARMUP_SWEEPS + 1, WARMUP_SWEEPS + sweeps
    pools = fleet.make_pools(shape, seed, device)
    pools.ensure(traffic.advance_points * last + shape.current_points)
    schedule = fleet.Schedule(shape, traffic, seed)
    schedule.newcomers(last)
    exp = reference.expected(shape, traffic, schedule, pools, cfg["env"], first, last)
    got = reference.expected(shape, traffic, schedule, pools, cfg["env"], first, last, precision=reference.CONTROL)
    return check.compare(exp, check.control_observed(got))

