"""Command line of the port: `python -m foremast_tpu_torch worker`.

The single-worker arm of the JAX package's `cmd_worker`
(`foremast_tpu/cli.py`), with the same flags, defaults and environment:
the deployed `foremast-brain` container's loop. It dials Elasticsearch
(`--elastic-url`, else `ELASTIC_URL` / `ES_ENDPOINT`; in-memory without
any) for jobs and Prometheus for series, judges on the card (`--device`,
default `cuda`; `cpu` runs every kernel's plain version), journals its
fits under `FOREMAST_SNAPSHOT_DIR` so a restart is warm, and serves
`/metrics`, `/healthz` and `/debug/state` on `--gauge-port`. With
`FOREMAST_INGEST=1` it also mounts the push-based ingest plane: a
remote-write receiver on `FOREMAST_INGEST_PORT` fills resident rings,
and fetches and cold fits read them before Prometheus; with
`FOREMAST_MICROTICK_SECONDS` > 0 as well, the receiver marks each pushed
series dirty and the worker judges just those documents in micro-ticks
between its sweeps. `FOREMAST_CHAOS_PLAN` (inline JSON or `@path`)
injects faults on the `store`, `prometheus` and `receiver` edges, and
`FOREMAST_TENANTS` (inline JSON or `@path`) makes the tenant a scheduling
and accounting dimension of the ring, the dirty set, the receiver and
the worker.

The JAX CLI's other subcommands and its multi-device modes are not
ported yet; each mode that would need them raises `NotImplementedError`
naming its ROADMAP.md Queue 1 item instead of running something else.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("foremast_tpu_torch.cli")

# env switches of JAX-only modes -> (what is missing, its ROADMAP.md
# Queue 1 item); each is refused when it asks for the mode
_UNPORTED_ENV = {
    "FOREMAST_MESH": ("the worker mesh", "item 7"),
    "FOREMAST_LOCK_WITNESS": ("the lock-order witness", "item 8"),
    "FOREMAST_RECOMPILE_WITNESS": ("the recompile witness", "item 8"),
}


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise for every requested mode the port does not have."""
    if args.sharded:
        raise NotImplementedError(
            "--sharded (the device mesh and pod mode) is not ported yet: ROADMAP.md Queue 1 item 7"
        )
    for name, (what, item) in _UNPORTED_ENV.items():
        if os.environ.get(name, "0") not in ("", "0"):
            raise NotImplementedError(f"{name}={os.environ[name]}: {what} is not ported yet: ROADMAP.md Queue 1 {item}")


def _make_store(elastic_url: str | None, chaos=None, breaker=None, stop=None):
    """ES-backed store with the reference's connect-retry loop, or
    in-memory when no URL is given (flag, then `ELASTIC_URL`, then
    `ES_ENDPOINT`). `FOREMAST_ES_CONNECT_DEADLINE_SECONDS` (0/unset =
    retry forever) turns a store that never comes up into a loud exit;
    `stop` (the shutdown signal) is honored between retries, and a stop
    during the connect loop exits 0."""
    from foremast_tpu_torch.jobs.store import ElasticsearchStore, InMemoryStore

    elastic_url = elastic_url or os.environ.get("ELASTIC_URL") or os.environ.get("ES_ENDPOINT")
    if not elastic_url:
        return InMemoryStore()
    store = ElasticsearchStore(elastic_url, chaos=chaos, breaker=breaker)
    deadline = float(os.environ.get("FOREMAST_ES_CONNECT_DEADLINE_SECONDS", "") or 0.0)
    log.info("connecting to Elasticsearch at %s (deadline %s)", elastic_url, f"{deadline:g} s" if deadline else "none")
    if not store.wait_ready(max_wait=deadline or None, stop=stop):
        if stop and stop():
            # a SIGTERM during the connect loop is a GRACEFUL shutdown:
            # exit 0, or a rolling restart reads as a crash loop
            print("shutdown requested during Elasticsearch connect; exiting cleanly", file=sys.stderr)
            raise SystemExit(0)
        state = store.connect_state
        raise SystemExit(
            f"could not reach Elasticsearch at {elastic_url} within "
            f"{deadline:.0f}s ({state['attempts']} attempts, last error: "
            f"{state['last_error']}); set "
            "FOREMAST_ES_CONNECT_DEADLINE_SECONDS=0 to wait forever"
        )
    return store


def _mount_ingest(inner, gauge_port: int, snapshot_dir: str | None = None, chaos=None, degrade=None, dirty=None):
    """FOREMAST_INGEST=1: wrap the pull source in the push plane's
    RingSource, so fetches and cold fits read resident ring columns and
    a miss falls back to `inner` (Prometheus) and backfills the ring,
    making the next read resident. With `snapshot_dir` the ring is
    durable: it restores BEFORE the receiver takes its first push, then
    every push journals. The receiver listens on FOREMAST_INGEST_PORT
    (default 9009; 0 = no receiver, backfill only), and the
    foremast_ingest_* families join /metrics when a gauge port is live.
    `dirty` (reactive.DirtySet) makes the receiver mark each applied
    series for the next micro-tick; `chaos` is the receiver's fault edge.
    The ring and the receiver take the process's tenancy
    (`FOREMAST_TENANTS`) themselves.
    Returns (source, ring, receiver or None, snapshotter or None)."""
    from foremast_tpu_torch.ingest import IngestCollector, RingSnapshotter, RingSource, RingStore, start_ingest_server
    from foremast_tpu_torch.jobs.refine import refine_docs_per_tick_from_env

    ring = RingStore.from_env()
    snapshotter = None
    if snapshot_dir:
        snapshotter = RingSnapshotter.from_env(ring, snapshot_dir)
        snapshotter.restore()  # logs series, samples and discards itself
        snapshotter.attach()
    source = RingSource(ring, fallback=inner)
    # the worker reads historical ranges straight off resident columns,
    # admits newcomers on short coverage and refines provisional fits in
    # the background: say so, with the two knobs that tune it. Partial
    # admission is pure-push only (RingSource.hist_columns), so a fleet
    # with a fallback is told its floor is inert
    log.info("cold-start path: ring-resident historical reads ON (admit floor %.0f s%s: "
             "FOREMAST_ADMIT_MIN_COVERAGE_SECONDS; refinement %d docs/tick: FOREMAST_REFINE_DOCS_PER_TICK)",
             source.admit_floor, "" if inner is None else " [inert: fallback configured]",
             refine_docs_per_tick_from_env())
    port = _env_int("FOREMAST_INGEST_PORT", 9009)
    srv = None
    if port:
        srv, _ = start_ingest_server(port, ring, book=source.book, chaos=chaos,
                                     degrade_stats=degrade.stats if degrade is not None else None, dirty=dirty)
    log.info("ingest plane ON: %d shards, budget %d bytes, staleness %.0f s, receiver %s; cold fits read "
             "ring columns first, misses fall back to Prometheus and backfill",
             ring.shard_count, ring.budget_bytes, ring.stale_seconds,
             f":{srv.server_address[1]}" if srv is not None else "off")
    if gauge_port:
        from prometheus_client import REGISTRY

        REGISTRY.register(IngestCollector(ring, book=source.book, wire=getattr(srv, "_foremast_wire_stats", None)))
    return source, ring, srv, snapshotter


def _persistent_worker_id(snap_dir: str, minted: str) -> str:
    """Stable worker identity across restarts (`<snap_dir>/worker.id`);
    the first boot persists the minted id."""
    from foremast_tpu_torch.ingest.snapshot import atomic_write

    path = os.path.join(snap_dir, "worker.id")
    try:
        with open(path) as fh:
            wid = fh.read().strip()
        if wid:
            return wid
    except OSError:
        pass
    atomic_write(path, minted.encode())
    return minted


def cmd_worker(args: argparse.Namespace) -> int:
    import signal
    import threading
    import uuid

    _refuse_unported(args)
    if args.gauge_port:
        try:
            import prometheus_client  # noqa: F401
        except ImportError:
            raise SystemExit(
                f"--gauge-port {args.gauge_port} needs the prometheus_client package, which this host "
                "lacks; install it or pass --gauge-port 0"
            ) from None

    from foremast_tpu_torch import native
    from foremast_tpu_torch.chaos import Degradation, chaos_from_env
    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs.worker import BrainWorker
    from foremast_tpu_torch.metrics.source import PrometheusSource
    from foremast_tpu_torch.observe.logs import ctx_log, setup_logging
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.ops import kernels
    from foremast_tpu_torch.ops.windows import resolve_device

    resolve_device(args.device)  # a missing card fails before any connect
    setup_logging()
    # startup-time build of the packing library, never inside a tick
    native_ok = native.ensure_built()
    if not native_ok:
        print(
            f"WARNING: the native packing library is unavailable ({native.error()}); "
            "cold ticks pack histories with the numpy fallback",
            file=sys.stderr,
        )
    config = BrainConfig.from_env()
    # the chaos plane: FOREMAST_CHAOS_PLAN unset (production) means every
    # injection seam below receives None, a plain attribute check. The
    # Degradation bundle (breakers, write-behind, tick budget) is always
    # on: degrading through a real outage must not need a chaos plan
    chaos_plan = chaos_from_env()

    def _edge(name: str):
        return chaos_plan.edge(name) if chaos_plan is not None else None

    degrade = Degradation.from_env(max_stuck_seconds=config.max_stuck_seconds, chaos_plan=chaos_plan)
    # the tenant plane: FOREMAST_TENANTS is read once here, so a malformed
    # envelope fails at startup; the ring, dirty set, receiver and worker
    # all take this process-global registry
    from foremast_tpu_torch.tenant import get_tenancy

    tenancy = get_tenancy()

    # graceful shutdown flag, installed BEFORE the store connect loop so
    # a SIGTERM during an ES outage at startup stops the retry promptly;
    # the worker loop reuses the same event
    stop_event = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda s, f: stop_event.set())
        signal.signal(signal.SIGINT, lambda s, f: stop_event.set())
    except ValueError:
        pass  # not the main thread (embedded use); rely on the caller

    store = _make_store(args.elastic_url, chaos=_edge("store"), breaker=degrade.breakers.get("store"),
                        stop=stop_event.is_set)
    source = PrometheusSource(chaos=_edge("prometheus"), breaker=degrade.breakers.get("prometheus"))

    snap_dir = os.environ.get("FOREMAST_SNAPSHOT_DIR") or None
    worker_id = f"brain-{uuid.uuid4().hex[:8]}"
    snap_lock = None
    if snap_dir:
        # two live workers on one directory would interleave torn frames
        # into the same logs; flock dies with the process, so a restart
        # acquires it at once and only a concurrent second worker runs
        # ephemeral
        from foremast_tpu_torch.ingest.snapshot import lock_snapshot_dir

        snap_lock = lock_snapshot_dir(snap_dir)
        if snap_lock is None:
            print(
                f"FOREMAST_SNAPSHOT_DIR {snap_dir} is held by another live worker; running "
                "ephemeral (give each co-hosted worker its own directory)",
                file=sys.stderr,
            )
            snap_dir = None
    if snap_dir:
        worker_id = _persistent_worker_id(snap_dir, worker_id)
    ingest_on = os.environ.get("FOREMAST_INGEST", "0") == "1"
    # the reactive plane: FOREMAST_MICROTICK_SECONDS > 0 turns pushed-sample
    # arrivals into micro-ticks. It needs the ingest receiver: arrivals are
    # what the receiver sees
    from foremast_tpu_torch.reactive import DirtySet, ReactiveCollector, microtick_docs_from_env, \
        microtick_seconds_from_env

    micro_seconds = microtick_seconds_from_env()
    dirty = None
    if micro_seconds > 0 and not ingest_on:
        print("FOREMAST_MICROTICK_SECONDS needs FOREMAST_INGEST=1 (the receiver is what marks arrivals); "
              "staying tick-paced", file=sys.stderr)
        micro_seconds = 0.0
    if micro_seconds > 0:
        dirty = DirtySet.from_env()
        log.info("reactive plane ON: micro-ticks every %.3f s, %d dirty keys/tick, dirty-set cap %d",
                 micro_seconds, microtick_docs_from_env(), dirty.max_keys)
    ingest_srv = snapshotter = None
    if ingest_on:
        source, _, ingest_srv, snapshotter = _mount_ingest(source, args.gauge_port, snapshot_dir=snap_dir,
                                                           chaos=_edge("receiver"), degrade=degrade, dirty=dirty)

    on_verdict = worker_metrics = None
    if args.gauge_port:
        from prometheus_client import REGISTRY

        from foremast_tpu_torch.observe.gauges import BrainGauges, WorkerMetrics, make_verdict_hook

        # the stage histograms, the engine's counters and the model gauges
        tracer = Tracer(service="worker", registry=REGISTRY)
        worker_metrics = WorkerMetrics()
        on_verdict = make_verdict_hook(BrainGauges())
    else:
        tracer = Tracer(service="worker")
    worker = BrainWorker(
        store,
        source,
        config=config,
        device=args.device,
        worker_id=worker_id,
        claim_limit=args.claim_limit,
        on_verdict=on_verdict,
        tracer=tracer,
        degrade=degrade,
        metrics=worker_metrics,
        dirty=dirty,
    )
    if snap_dir:
        # fit journals restore lazily (the first claim of each doc
        # rehydrates its fits, so admission passes with no history
        # re-fetch) and write through on fit completion
        restored = worker.enable_fit_persistence(snap_dir)
        if any(restored.values()):
            print(f"restored fit state {restored} from {snap_dir}", file=sys.stderr)
        if snapshotter is not None:
            # the snapshot cadence runs in the tick loop
            worker.attach_ring_snapshotter(snapshotter)
            ring_restored = snapshotter.stats()
            if ring_restored["restored_series"]:
                print(f"restored ring state {ring_restored['restored_series']} series, "
                      f"{ring_restored['restored_samples']} samples from {snap_dir}", file=sys.stderr)

    obs_srv = None
    if args.gauge_port:
        from prometheus_client import REGISTRY

        from foremast_tpu_torch.chaos import ChaosCollector
        from foremast_tpu_torch.observe.spans import start_observe_server

        obs_srv, _ = start_observe_server(args.gauge_port, state_fn=worker.debug_state, max_port_tries=32)

        # breaker states, degraded-doc counters and injected-fault counts
        # ride the same scrape port (the worker registered the tenant
        # ledger's collector itself)
        REGISTRY.register(ChaosCollector(degrade))
        if snap_dir:
            from foremast_tpu_torch.ingest import SnapshotCollector

            REGISTRY.register(SnapshotCollector(snapshotter, journals=worker._fit_journals.values()))
        if dirty is not None:
            REGISTRY.register(ReactiveCollector(dirty))

    ckpt_path = None
    after_tick = None
    cache = worker.judge.cache  # the joint models (LSTM-AE weights)
    if args.model_cache_dir:
        import ast

        ckpt_path = os.path.abspath(os.path.join(args.model_cache_dir, "model_cache"))
        if os.path.exists(ckpt_path):
            try:
                n = cache.load(ckpt_path, key_parser=ast.literal_eval)
                print(f"restored {n} cached models from {ckpt_path}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 - stale/corrupt
                print(f"model-cache restore failed ({e}); starting cold", file=sys.stderr)
        state = {"dirty": False}

        def after_tick(n, _state=state):
            # checkpoint when work happened, on the following idle tick,
            # so saves never add latency to a busy scoring cycle
            if n > 0:
                _state["dirty"] = True
            elif _state["dirty"]:
                os.makedirs(args.model_cache_dir, exist_ok=True)
                cache.save(ckpt_path)
                _state["dirty"] = False

    if args.warmup:
        worker.warmup()
    ctx_log(log, logging.INFO, "worker started", worker_id=worker_id, device=str(worker.judge.device),
            claim_limit=args.claim_limit, snapshot_dir=snap_dir, native=native_ok,
            chaos_rules=len(chaos_plan.rules) if chaos_plan is not None else 0,
            tenants=sorted(tenancy.specs) if tenancy is not None else None)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    loop_failed = False
    try:
        worker.run(poll_seconds=args.poll, stop=stop_event.is_set, after_tick=after_tick)
    except BaseException:
        loop_failed = True
        raise
    finally:
        # runs even when a tick raises: pools must not linger, and the
        # checkpoint is worth keeping from a crashed loop. After a loop
        # failure a cleanup error is logged, never allowed to mask it; on
        # a clean shutdown a failed checkpoint raises
        try:
            worker.close()
        except Exception as e:  # noqa: BLE001 - cleanup must not mask
            log.warning("worker shutdown failed: %s", e)
        if obs_srv is not None:
            obs_srv.shutdown()
            obs_srv.server_close()
        if ingest_srv is not None:
            # bounded drain: in-flight pushes finish (or are abandoned as
            # daemon threads), the listen port frees at once
            from foremast_tpu_torch.ingest import stop_ingest_server

            try:
                stop_ingest_server(ingest_srv)
            except Exception as e:  # noqa: BLE001 - see loop_failed
                log.warning("ingest receiver shutdown failed: %s", e)
        if snapshotter is not None:
            # one final pass AFTER the receiver drained (the last pushes
            # are in), so a restart replays a snapshot, not a long log
            try:
                snapshotter.snapshot()
                snapshotter.close()
            except Exception as e:  # noqa: BLE001 - see loop_failed
                if not loop_failed:
                    raise
                log.warning("final ring snapshot failed: %s", e)
        if ckpt_path and len(cache):
            try:
                os.makedirs(args.model_cache_dir, exist_ok=True)
                cache.save(ckpt_path)
            except Exception as e:  # noqa: BLE001 - see loop_failed
                if not loop_failed:
                    raise
                log.warning("final model-cache checkpoint failed: %s", e)
        # what the run injected and charged, for hosts without the gauge
        # port's /debug/state (no prometheus_client)
        ctx_log(log, logging.INFO, "worker stopped", worker_id=worker_id,
                kernel_launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                chaos_injections=(chaos_plan.debug_state()["injections"] if chaos_plan is not None else None),
                tenants=(worker._debug_tenants()["accounting"] if tenancy is not None else None))
        if snap_lock is not None:
            snap_lock.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="foremast_tpu_torch", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("worker", help="scoring worker loop (brain)")
    p.set_defaults(fn=cmd_worker)
    p.add_argument(
        "--device", default="cuda",
        help="torch device the judge runs on (cuda by default; it raises without a card; cpu runs "
        "the kernels' plain versions)",
    )
    p.add_argument("--elastic-url", default=None)
    p.add_argument("--poll", type=float, default=5.0)
    p.add_argument(
        "--claim-limit",
        type=int,
        default=_env_int("FOREMAST_CLAIM_LIMIT", 256),
        help="jobs claimed per tick; the whole claim scores as one batched program "
        "(env FOREMAST_CLAIM_LIMIT)",
    )
    p.add_argument(
        "--sharded",
        action="store_true",
        help="score over a device mesh (not ported yet: refused)",
    )
    p.add_argument(
        "--model-cache-dir",
        default=None,
        help="checkpoint the joint models here with torch.save (a warm restart skips LSTM "
        "retraining); restored on startup",
    )
    p.add_argument(
        "--warmup",
        action="store_true",
        help="build the kernels and run the tick's programs once at startup instead of inside "
        "the first real tick",
    )
    p.add_argument(
        "--gauge-port",
        type=int,
        default=8000,
        help="/metrics, /healthz and /debug/state exposition port (0 disables)",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
