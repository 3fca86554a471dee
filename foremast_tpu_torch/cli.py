"""Command line of the port: `python -m foremast_tpu_torch <command>`.

The JAX package's CLI (`foremast_tpu/cli.py`) with the same flags,
defaults, environment and exit codes, for these commands:

  score        one-shot health judgment of an ApplicationHealthAnalyzeRequest
               JSON: request -> windows -> the batched judgment on the card
               (`--device`, default `cuda`; it raises without a card, and
               `cpu` runs every kernel's plain version) -> the reference's
               wire-format response; exit 0 when the metrics were judged
               (healthy or anomaly), 1 otherwise
  serve        the REST job gateway on :8099 (foremast-service equivalent),
               on the standard library's HTTP server
  worker       the scoring worker loop (brain equivalent)
  watch        / unwatch: toggle continuous monitoring on a
               DeploymentMonitor through the API server (kubectl-watch
               parity); exit 1 when the monitor does not exist
  watch-plane  the Kubernetes controller loop: deployment watcher, status
               poller and remediation (rollback or pause), with
               `FOREMAST_WATCH_STREAM=1` for the streaming informer
  ui           the dashboard on :8080 (foremast-browser equivalent), on the
               standard library's HTTP server: each panel's four series
               fetched through the gateway's query proxy
               (`--service-endpoint`, else `FOREMAST_SERVICE_ENDPOINT`) and
               joined server-side, or synthetic series with `--demo`
  rules        print the recording- and alert-rules manifest (a
               PrometheusRule) as YAML, byte for byte the JAX CLI's

`worker` dials Elasticsearch (`--elastic-url`, else `ELASTIC_URL` /
`ES_ENDPOINT`; in-memory without any) for jobs and Prometheus for series,
judges on the card (`--device`, as `score`), journals its fits under
`FOREMAST_SNAPSHOT_DIR` so a restart is warm, and serves `/metrics`,
`/healthz` and `/debug/state` on `--gauge-port`. With `FOREMAST_INGEST=1`
it also mounts the push-based ingest plane: a remote-write receiver on
`FOREMAST_INGEST_PORT` fills resident rings, and fetches and cold fits
read them before Prometheus; with `FOREMAST_MICROTICK_SECONDS` > 0 as
well, the receiver marks each pushed series dirty and the worker judges
just those documents in micro-ticks between its sweeps.
`FOREMAST_CHAOS_PLAN` (inline JSON or `@path`) injects faults on the
`store`, `prometheus`, `receiver`, `transfer` and `clock` edges of the
worker and on the `kube` edge of `watch-plane`, and `FOREMAST_TENANTS`
(inline JSON or `@path`) makes the tenant a scheduling and accounting
dimension of the ring, the dirty set, the receiver and the worker.
`FOREMAST_MESH=1` seats the worker in a worker mesh over the shared store
(`mesh/`): it claims only its partition, its receiver hints pushers at
each series' owner, and with `FOREMAST_INGEST=1` a planned join or a
SIGTERM moves ring and fit state to the new owners instead of leaving it
to cold refits.

`worker --sharded` with `JAX_COORDINATOR_ADDRESS` (`host:port`),
`JAX_NUM_PROCESSES` and `JAX_PROCESS_ID` set runs pod mode: one logical
worker across those processes (`parallel/distributed.py`). Rank 0, the
leader, alone dials the store and Prometheus, claims, fetches, writes,
serves the gauge port, checkpoints the model cache (`model_cache.pod`
under `--model-cache-dir`, restored on every rank) and, with
`FOREMAST_MESH=1`, holds the pod's one mesh seat; claims, series, the
clock and the stop decision are broadcast over gloo; each rank judges
its own blocks of the data axis on its own devices and every rank
gathers every result (over NCCL when each rank holds cards of its own,
else over gloo). `FOREMAST_SNAPSHOT_DIR` and `FOREMAST_MICROTICK_SECONDS`
are ignored there, as in the JAX package.

`FOREMAST_LOCK_WITNESS=1` makes `worker` install the lock-order witness
(`analysis/witness.py`) before it creates its first lock; at exit it
logs whether every lock acquisition order it saw lies within the static
graph `analysis_lockgraph_torch.json` (regenerate that with `python -m
foremast_tpu_torch.analysis --write-lockgraph`). `FOREMAST_PROFILE=<dir>`
records each of the worker's sweeps under `torch.profiler` (one
`observe.trace_scoring` region each) and writes one Chrome trace per
sweep there; micro-ticks between sweeps are not recorded. `/debug/state` lists the registered knobs
set in the worker's environment under `env_overrides` (the registry is
`config.ENV_KNOBS`). Beside the CLI: `python -m foremast_tpu_torch.deploy
deploy_torch/` renders the Kubernetes tree (one H100 per engine pod),
`python -m foremast_tpu_torch.observe.metrics_lint` lints the exported
metric families, and `python3 chip_smoke.py --ops-only` runs the
profiler, the witness, the manifests and the lint on the card.

`FOREMAST_RECOMPILE_WITNESS=1` is refused with `NotImplementedError`: it
counts XLA recompiles of traced programs, and the port has no traced
programs.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("foremast_tpu_torch.cli")

# env switches of JAX-only modes -> (why the port has none, its ROADMAP.md
# Queue 1 item); each is refused when it asks for the mode
_UNPORTED_ENV = {
    "FOREMAST_RECOMPILE_WITNESS": (
        "the recompile witness counts XLA recompiles of traced programs, and the port has none", "item 8"),
}


def _env_int(name: str, default: int) -> int:
    # thin wrapper: every call site passes a literal, registered knob
    raw = os.environ.get(name, "")  # foremast: ignore[env-contract]
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise for every requested mode the port does not have."""
    for name, (what, item) in _UNPORTED_ENV.items():
        # the registered knobs of _UNPORTED_ENV
        raw = os.environ.get(name, "0")  # foremast: ignore[env-contract]
        if raw not in ("", "0"):
            raise NotImplementedError(f"{name}={raw}: {what}: ROADMAP.md Queue 1 {item}")


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


def _mesh_member(store, worker_id: str, chaos_plan=None):
    """The worker mesh's Membership and MeshRouter from the environment
    (`FOREMAST_MESH_LEASE_SECONDS`, `_REPLICAS`, `_ROUTE_LABEL`). A chaos
    plan's ``clock`` edge skews the clock this member stamps leases with
    and reads its peers' by."""
    from foremast_tpu_torch.mesh import Membership, MeshRouter

    mesh_kw = {}
    if chaos_plan is not None:
        mesh_kw["clock"] = chaos_plan.edge("clock").clock()
    membership = Membership(
        store, worker_id, lease_seconds=float(os.environ.get("FOREMAST_MESH_LEASE_SECONDS", "") or "15"), **mesh_kw
    )
    router = MeshRouter(
        membership,
        replicas=_env_int("FOREMAST_MESH_REPLICAS", 64),
        route_label=os.environ.get("FOREMAST_MESH_ROUTE_LABEL", "") or "app",
    )
    return membership, router


def _mount_ingest(inner, gauge_port: int, snapshot_dir: str | None = None, chaos=None, degrade=None, dirty=None,
                  router=None, handoff=None):
    """FOREMAST_INGEST=1: wrap the pull source in the push plane's
    RingSource, so fetches and cold fits read resident ring columns and
    a miss falls back to `inner` (Prometheus) and backfills the ring,
    making the next read resident. With `snapshot_dir` the ring is
    durable: it restores BEFORE the receiver takes its first push, then
    every push journals. The receiver listens on FOREMAST_INGEST_PORT
    (default 9009; 0 = no receiver, backfill only), and the
    foremast_ingest_* families join /metrics when a gauge port is live.
    `dirty` (reactive.DirtySet) makes the receiver mark each applied
    series for the next micro-tick; `chaos` is the receiver's fault edge;
    `router` (mesh mode) makes it hint pushers at each series' owner and
    `handoff` mounts the transfer endpoint on this ring.
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
    if handoff is not None:
        # the handoff plane streams and applies THIS ring's series; the
        # manager exists before the ring, so it is bound here
        handoff.ring_store = ring
    port = _env_int("FOREMAST_INGEST_PORT", 9009)
    srv = None
    if port or router is not None:
        srv, _ = start_ingest_server(port, ring, book=source.book, router=router, chaos=chaos,
                                     degrade_stats=degrade.stats if degrade is not None else None, handoff=handoff,
                                     dirty=dirty)
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


def _sharded_mesh(device: str):
    """--sharded: the judge over the global mesh (`make_global_mesh`) —
    every card of this process, or the one CPU device with --device cpu,
    and in pod mode every other rank's after them. Without the flag the
    worker resolves FOREMAST_DEVICE_MESH and FOREMAST_DEVICE_MESH_MODEL
    (`parallel.mesh.worker_device_mesh`)."""
    import torch

    from foremast_tpu_torch.parallel import mesh as meshlib

    if torch.device(device).type == "cuda":
        return meshlib.make_global_mesh()
    return meshlib.make_global_mesh(devices=[device])


def _add_score(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("score", help="one-shot health judgment of a request JSON")
    p.set_defaults(fn=cmd_score)
    p.add_argument("--request", required=True, help="path to ApplicationHealthAnalyzeRequest JSON ('-' for stdin)")
    p.add_argument("--current", action="append", default=[], metavar="ALIAS=CSV",
                   help="replay trace for the current window of ALIAS")
    p.add_argument("--baseline", action="append", default=[], metavar="ALIAS=CSV")
    p.add_argument("--historical", action="append", default=[], metavar="ALIAS=CSV")
    p.add_argument("--prometheus", action="store_true", help="fetch real query_range URLs instead of replay traces")
    p.add_argument(
        "--follow",
        action="store_true",
        help="keep re-checking until the job reaches a terminal status (the reference's incremental re-check "
        "loop); default judges once and finalizes",
    )
    p.add_argument("--poll", type=float, default=5.0, help="--follow poll seconds")
    p.add_argument(
        "--device", default="cuda",
        help="torch device the judge runs on (cuda by default; it raises without a card; cpu runs the kernels' "
        "plain versions)",
    )


def _parse_assignments(pairs: list[str], flag: str) -> dict[str, str]:
    out = {}
    for pair in pairs:
        alias, sep, path = pair.partition("=")
        if not sep or not alias or not path:
            raise SystemExit(f"{flag} expects ALIAS=CSV, got {pair!r}")
        out[alias] = path
    return out


def cmd_score(args: argparse.Namespace) -> int:
    import json
    import time
    from urllib.parse import unquote

    from foremast_tpu_torch.config import BrainConfig
    from foremast_tpu_torch.jobs.convert import request_to_document
    from foremast_tpu_torch.jobs.models import (
        STATUS_COMPLETED_HEALTH,
        STATUS_COMPLETED_UNHEALTH,
        TERMINAL_STATUSES,
        AnalyzeRequest,
        document_response,
    )
    from foremast_tpu_torch.jobs.store import InMemoryStore, parse_time
    from foremast_tpu_torch.jobs.worker import BrainWorker
    from foremast_tpu_torch.metrics.promql import decode_config
    from foremast_tpu_torch.metrics.source import PrometheusSource, ReplaySource
    from foremast_tpu_torch.ops.windows import resolve_device

    resolve_device(args.device)  # a missing card fails before any work
    raw = sys.stdin.read() if args.request == "-" else open(args.request).read()
    req = AnalyzeRequest.from_json(json.loads(raw))
    doc = request_to_document(req)

    if args.prometheus:
        source = PrometheusSource()
    else:
        # replay traces are keyed by exact query URL: current/baseline/
        # historical configs for the same alias differ only in their URLs,
        # so route each category's URL to its own trace
        source = ReplaySource()
        for flag, config in (
            ("--current", doc.current_config),
            ("--baseline", doc.baseline_config),
            ("--historical", doc.historical_config),
        ):
            assignments = _parse_assignments(getattr(args, flag[2:]), flag)
            urls = decode_config(config)
            for alias, path in assignments.items():
                if alias not in urls:
                    raise SystemExit(
                        f"{flag} {alias}: no such alias in the request's "
                        f"{flag[2:]} metrics (have: {sorted(urls) or 'none'})"
                    )
                # ReplaySource matches patterns against the *unquoted* URL
                source.register_csv(unquote(urls[alias]), path)

    store = InMemoryStore()
    doc, _ = store.create(doc)
    # the worker loop's env-var config surface (the reference brain is
    # configured entirely through env, foremast-brain/README.md:20-38)
    worker = BrainWorker(store, source, config=BrainConfig.from_env(), device=args.device, claim_limit=1)
    try:
        if args.follow:
            while store.get(doc.id).status not in TERMINAL_STATUSES:
                worker.tick()
                if store.get(doc.id).status in TERMINAL_STATUSES:
                    break
                time.sleep(args.poll)
        else:
            # one-shot: clamp "now" past endTime so a healthy window finalizes
            end = parse_time(doc.end_time)
            worker.tick(now=max(time.time(), end + 1))
    finally:
        worker.close()

    final = store.get(doc.id)
    json.dump(document_response(final), sys.stdout, indent=2)
    print()
    # exit 0 only when the judgment actually evaluated the metrics
    # (healthy OR anomaly); preprocess_failed / abort / completed_unknown
    # mean no judgment was made, which must fail a CI gate
    return 0 if final.status in (STATUS_COMPLETED_HEALTH, STATUS_COMPLETED_UNHEALTH) else 1


def cmd_serve(args: argparse.Namespace) -> int:
    from foremast_tpu_torch.observe.logs import setup_logging
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.service.app import serve

    setup_logging()
    store = _make_store(args.elastic_url)
    serve(
        host=args.host,
        port=args.port,
        store=store,
        query_endpoint=args.query_endpoint,
        # per-request spans + the /debug/state trace section; the ring
        # buffer dump is gated by FOREMAST_TRACE_DIR as everywhere
        tracer=Tracer(service="service"),
    )
    return 0


def _toggle_continuous(args: argparse.Namespace, value: bool) -> int:
    from foremast_tpu_torch.watch.kubeapi import HttpKube, NotFound

    kube = HttpKube(base_url=args.api_server)
    try:
        # merge-patch only spec.continuous (what the reference plugin's
        # `kubectl patch --type=merge` does) so concurrent spec/status
        # writers are never reverted
        monitor = kube.patch_monitor(args.namespace, args.name, {"spec": {"continuous": value}})
    except NotFound:
        print(f"deploymentmonitor {args.namespace}/{args.name} not found", file=sys.stderr)
        return 1
    verb = "watching" if value else "no longer watching"
    print(f"Foremast is {verb} application {args.name}")
    print(f"Job: {monitor.status.job_id}")
    return 0


def cmd_watch(args: argparse.Namespace) -> int:
    return _toggle_continuous(args, True)


def cmd_unwatch(args: argparse.Namespace) -> int:
    return _toggle_continuous(args, False)


def cmd_watch_plane(args: argparse.Namespace) -> int:
    """Run the deployed watch-plane controller (barrelman equivalent)
    until SIGTERM or SIGINT."""
    import signal
    import threading

    if args.gauge_port:
        try:
            import prometheus_client  # noqa: F401
        except ImportError:
            raise SystemExit(
                f"--gauge-port {args.gauge_port} needs the prometheus_client package, which this host "
                "lacks; install it or pass --gauge-port 0"
            ) from None

    from foremast_tpu_torch.chaos import Degradation, chaos_from_env
    from foremast_tpu_torch.observe.logs import ctx_log, setup_logging
    from foremast_tpu_torch.observe.spans import Tracer
    from foremast_tpu_torch.watch.kubeapi import HttpKube
    from foremast_tpu_torch.watch.plane import WatchPlane

    setup_logging()
    # the controller's one dependency edge gets the chaos seam and breaker
    # the worker's clients carry: a FOREMAST_CHAOS_PLAN rule on edge
    # "kube" injects here, and a dead API server fails fast once the
    # breaker opens instead of stalling every poll
    chaos_plan = chaos_from_env()
    degrade = Degradation.from_env(chaos_plan=chaos_plan)
    kube = HttpKube(
        base_url=args.api_server,
        chaos=chaos_plan.edge("kube") if chaos_plan is not None else None,
        breaker=degrade.breakers.get("kube"),
    )
    stop_event = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda s, f: stop_event.set())
        signal.signal(signal.SIGINT, lambda s, f: stop_event.set())
    except ValueError:
        pass  # not the main thread (embedded use); rely on the caller
    plane = WatchPlane(
        kube,
        own_namespace=args.namespace or os.environ.get("NAMESPACE", "foremast"),
        tracer=Tracer(service="controller"),
        # the poll loop's pause wakes at once on the stop signal
        sleep=stop_event.wait,
    )
    obs_srv = None
    if args.gauge_port:
        # the transition counter and poll-stage histogram register on the
        # default registry; this server is what makes them scrapeable
        from prometheus_client import REGISTRY

        from foremast_tpu_torch.chaos import ChaosCollector
        from foremast_tpu_torch.observe.spans import start_observe_server

        REGISTRY.register(ChaosCollector(degrade))
        obs_srv, _ = start_observe_server(args.gauge_port, state_fn=plane.debug_state)
    ctx_log(log, logging.INFO, "watch plane started", api_server=kube.base_url, stream=plane.stream,
            chaos_rules=len(chaos_plan.rules) if chaos_plan is not None else 0)
    try:
        plane.run(stop=stop_event.is_set)
    finally:
        if obs_srv is not None:
            obs_srv.shutdown()
            obs_srv.server_close()
        # what the run injected and its breaker did, for hosts without the
        # gauge port's /debug/state (no prometheus_client)
        ctx_log(log, logging.INFO, "watch plane stopped",
                chaos_injections=(chaos_plan.debug_state()["injections"] if chaos_plan is not None else None),
                breakers=degrade.breakers.debug_state(),
                stream=(plane.informer.debug_state() if plane.stream else None))
    return 0


def cmd_worker(args: argparse.Namespace) -> int:
    # FIRST, before any import below creates a package lock (native.py,
    # observe/spans.py and ops/_build.py make module-level locks at import
    # time): FOREMAST_LOCK_WITNESS=1 wraps threading.Lock/RLock to record
    # the real acquisition order and checks it against the committed
    # static graph (analysis_lockgraph_torch.json) at exit; installed any
    # later, those locks would stay raw and their edges unseen
    from foremast_tpu_torch.analysis.witness import install_from_env

    install_from_env()

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

    # pod mode: join the process group before any judge exists (the pod's
    # mesh is itself a collective); --sharded without the JAX_* rendezvous
    # is the all-local mesh of one process
    pod_mode = False
    sharded_mesh = None
    if args.sharded:
        from foremast_tpu_torch.parallel import init_distributed

        pod_mode = init_distributed()
        sharded_mesh = _sharded_mesh(args.device)
    leader = not pod_mode or sharded_mesh.pod.rank == 0
    if pod_mode:
        pod = sharded_mesh.pod
        print(f"pod mode: rank {pod.rank} of {pod.world}{' (leader)' if leader else ''}, data-axis blocks "
              f"{pod.first}-{pod.first + pod.n_local - 1} of {pod.n_data}; result gather over {pod.backend} "
              f"({pod.reason})", file=sys.stderr)

    # followers never dial Elasticsearch or Prometheus: only the leader
    # needs their address and credentials
    store = source = None
    if leader:
        store = _make_store(args.elastic_url, chaos=_edge("store"), breaker=degrade.breakers.get("store"),
                            stop=stop_event.is_set)
        source = PrometheusSource(chaos=_edge("prometheus"), breaker=degrade.breakers.get("prometheus"))

    snap_dir = os.environ.get("FOREMAST_SNAPSHOT_DIR") or None
    if snap_dir and pod_mode:
        # pod mode's determinism contract (identical caches on every
        # rank, leader-only I/O) has its own durability path: the
        # leader's model-cache checkpoint, restored pod-wide
        print("FOREMAST_SNAPSHOT_DIR ignored in pod mode (use --model-cache-dir: leader checkpoint + broadcast)",
              file=sys.stderr)
        snap_dir = None
    worker_id = f"{'pod' if pod_mode else 'brain'}-{uuid.uuid4().hex[:8]}"
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
        # a restarted mesh member re-takes its seat: its ring never moves
        worker_id = _persistent_worker_id(snap_dir, worker_id)
    ingest_on = os.environ.get("FOREMAST_INGEST", "0") == "1"
    mesh_on = os.environ.get("FOREMAST_MESH", "0") == "1"
    membership = router = handoff = mesh_node = None
    if mesh_on and pod_mode:
        # mesh-of-pods: the pod is ONE member of the worker mesh. Only the
        # leader holds the lease and evaluates the claim filter (it alone
        # has the store); the filtered claim set broadcasts like any
        # other, so partitioning never shapes a follower's control flow.
        # Handoff and routed ingest stay off in pods
        print("mesh-of-pods: this pod joins the worker mesh as ONE member (leader-held lease + claim filter)",
              file=sys.stderr)
        if leader:
            from foremast_tpu_torch.mesh import MeshNode

            membership, router = _mesh_member(store, worker_id, chaos_plan)
            mesh_node = MeshNode(membership, router)
            mesh_node.start()
    elif mesh_on:
        membership, router = _mesh_member(store, worker_id, chaos_plan)
        # planned handoff: a joiner is fenced until the current owners
        # stream it its partition, and SIGTERM drains instead of leaving
        # state behind. It needs the receiver (the transfer endpoint), so
        # it is wired only with FOREMAST_INGEST=1
        if ingest_on and os.environ.get("FOREMAST_HANDOFF", "1") == "1":
            from foremast_tpu_torch.mesh import HandoffManager

            handoff = HandoffManager(route_label=router.route_label, chaos=_edge("transfer"),
                                     breaker=degrade.breakers.get("transfer"))
    # the reactive plane: FOREMAST_MICROTICK_SECONDS > 0 turns pushed-sample
    # arrivals into micro-ticks. It needs the ingest receiver: arrivals are
    # what the receiver sees
    from foremast_tpu_torch.reactive import DirtySet, ReactiveCollector, microtick_docs_from_env, \
        microtick_seconds_from_env

    micro_seconds = microtick_seconds_from_env()
    dirty = None
    if micro_seconds > 0 and pod_mode:
        # pod ticks are broadcast collectives; a leader-local micro-tick
        # would desynchronize the followers
        print("FOREMAST_MICROTICK_SECONDS ignored in pod mode (micro-ticks are single-worker; pod ticks are "
              "broadcast collectives)", file=sys.stderr)
        micro_seconds = 0.0
    if micro_seconds > 0 and not ingest_on:
        print("FOREMAST_MICROTICK_SECONDS needs FOREMAST_INGEST=1 (the receiver is what marks arrivals); "
              "staying tick-paced", file=sys.stderr)
        micro_seconds = 0.0
    if micro_seconds > 0:
        # with a mesh, pushes for series another member owns are counted
        # foreign and never marked (that member's receiver marks them)
        dirty = DirtySet.from_env(route_label=router.route_label if router is not None else "app",
                                  owns=router.owns_series if router is not None else None)
        log.info("reactive plane ON: micro-ticks every %.3f s, %d dirty keys/tick, dirty-set cap %d",
                 micro_seconds, microtick_docs_from_env(), dirty.max_keys)
    ingest_srv = snapshotter = ring = None
    if ingest_on and leader:
        # the ring and the receiver live where the fetches happen: the
        # single worker, or the pod's leader (followers' fetches stay
        # leader-broadcast collectives)
        source, ring, ingest_srv, snapshotter = _mount_ingest(source, args.gauge_port, snapshot_dir=snap_dir,
                                                              chaos=_edge("receiver"), degrade=degrade, dirty=dirty,
                                                              router=router, handoff=handoff)
    if mesh_on and not pod_mode:
        from foremast_tpu_torch.mesh import MeshNode

        if ingest_srv is not None:
            # advertise where pushers and peers reach the receiver:
            # FOREMAST_MESH_ADVERTISE (host or host:port) wins, the bound
            # port fills the gap
            import socket

            adv_host, _, adv_port = (os.environ.get("FOREMAST_MESH_ADVERTISE") or "").partition(":")
            membership.ingest_address = f"{adv_host or socket.gethostname()}:{adv_port or ingest_srv.server_address[1]}"
        mesh_node = MeshNode(membership, router, ring_store=ring, handoff=handoff)
        mesh_node.start()

    # pod mode: telemetry is the leader's alone. Every rank runs the whole
    # tick over the same fleet, so follower gauges would count every job
    # and verdict once a rank
    on_verdict = worker_metrics = tracer = None
    if args.gauge_port and leader:
        from prometheus_client import REGISTRY

        from foremast_tpu_torch.observe.gauges import BrainGauges, WorkerMetrics, make_verdict_hook

        # the stage histograms, the engine's counters and the model gauges
        tracer = Tracer(service="worker", registry=REGISTRY)
        worker_metrics = WorkerMetrics()
        on_verdict = make_verdict_hook(BrainGauges())
    elif leader:
        tracer = Tracer(service="worker")
    worker_kw = dict(
        config=config,
        device=args.device,
        device_mesh=sharded_mesh if args.sharded else "env",
        worker_id=worker_id,
        claim_limit=args.claim_limit,
        on_verdict=on_verdict,
        tracer=tracer,
        degrade=degrade,
        metrics=worker_metrics,
        mesh=mesh_node,
    )
    if pod_mode:
        # one logical worker across the process group: the leader claims,
        # fetches and writes, everything else is broadcast, each rank
        # judges its own blocks. Plain BrainWorkers must NOT share a pod's
        # mesh: each would claim different documents into one judgment
        from foremast_tpu_torch.parallel import LeaderSource, LeaderStore, PodWorker

        worker = PodWorker(LeaderStore(store), LeaderSource(source), **worker_kw)
    else:
        worker = BrainWorker(store, source, dirty=dirty, **worker_kw)
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
    if args.gauge_port and leader:
        from prometheus_client import REGISTRY

        from foremast_tpu_torch.chaos import ChaosCollector
        from foremast_tpu_torch.observe.spans import start_observe_server

        obs_srv, _ = start_observe_server(args.gauge_port, state_fn=worker.debug_state, max_port_tries=32)
        if mesh_node is not None:
            from foremast_tpu_torch.mesh import MeshCollector

            REGISTRY.register(MeshCollector(mesh_node))
            # co-hosted members auto-increment past a busy port: publish
            # the one this worker got
            mesh_node.membership.observe_port = obs_srv.server_address[1]
            mesh_node.membership.renew(force=True)

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
    ckpt_save = None
    after_tick = None
    cache = worker.judge.cache  # the joint models (LSTM-AE weights)
    if args.model_cache_dir and pod_mode:
        # the determinism contract needs IDENTICAL caches on every rank: a
        # rank restoring fewer fits than its peers would route documents
        # down other code paths. So only the leader touches disk (a
        # host-local pickle), the restored entries are broadcast to every
        # rank, and follower saves are no-ops
        from foremast_tpu_torch.parallel import broadcast_obj

        ckpt_path = os.path.abspath(os.path.join(args.model_cache_dir, "model_cache.pod"))
        ckpt_save = cache.save_local if leader else (lambda path: None)
        restored = None
        if leader and os.path.exists(ckpt_path):
            try:
                cache.load_local(ckpt_path)
                restored = cache.snapshot()
            except Exception as e:  # noqa: BLE001 - stale/corrupt
                print(f"model-cache restore failed ({e}); starting cold", file=sys.stderr)
        items = broadcast_obj(restored)
        if items:
            if not leader:
                cache.put_many(items.items())
            print(f"restored {len(items)} cached models pod-wide from {ckpt_path}", file=sys.stderr)
    elif args.model_cache_dir:
        import ast

        ckpt_path = os.path.abspath(os.path.join(args.model_cache_dir, "model_cache"))
        ckpt_save = cache.save
        if os.path.exists(ckpt_path):
            try:
                n = cache.load(ckpt_path, key_parser=ast.literal_eval)
                print(f"restored {n} cached models from {ckpt_path}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 - stale/corrupt
                print(f"model-cache restore failed ({e}); starting cold", file=sys.stderr)
    if ckpt_path:
        state = {"dirty": False}

        def after_tick(n, _state=state):
            # checkpoint when work happened, on the following idle tick,
            # so saves never add latency to a busy scoring cycle
            if n > 0:
                _state["dirty"] = True
            elif _state["dirty"]:
                os.makedirs(args.model_cache_dir, exist_ok=True)
                ckpt_save(ckpt_path)
                _state["dirty"] = False

    if args.warmup:
        worker.warmup()
    ctx_log(log, logging.INFO, "worker started", worker_id=worker_id, device=str(worker.judge.device),
            claim_limit=args.claim_limit, snapshot_dir=snap_dir, native=native_ok,
            chaos_rules=len(chaos_plan.rules) if chaos_plan is not None else 0,
            mesh_state=mesh_node.state if mesh_node is not None else None,
            tenants=sorted(tenancy.specs) if tenancy is not None else None)
    stop_fn = stop_event.is_set
    if mesh_node is not None and mesh_node.handoff is not None:
        # planned shutdown: on the stop signal, stream this partition to
        # the post-drain owners on a side thread while the loop KEEPS
        # TICKING (a draining member judges its partition to the end); the
        # loop exits once the stream landed or failed, and the finally
        # block's drain() then only leaves
        drain_box: list = [None]

        def stop_fn() -> bool:
            if not stop_event.is_set():
                return False
            t = drain_box[0]
            if t is None:
                t = drain_box[0] = threading.Thread(target=mesh_node.stream_drain, name="handoff-drain", daemon=True)
                t.start()
            return not t.is_alive()

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    loop_failed = False
    try:
        worker.run(poll_seconds=args.poll, stop=stop_fn, after_tick=after_tick)
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
        if mesh_node is not None:
            # drain when the handoff plane is wired (the stream ran under
            # the loop, so this only leaves); otherwise leave at once, so
            # peers take the partition without waiting out the lease
            try:
                if mesh_node.handoff is not None and not loop_failed:
                    mesh_node.drain()
                else:
                    mesh_node.close()
            except Exception as e:  # noqa: BLE001 - see loop_failed
                log.warning("mesh drain/leave failed: %s", e)
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
                ckpt_save(ckpt_path)
            except Exception as e:  # noqa: BLE001 - see loop_failed
                if not loop_failed:
                    raise
                log.warning("final model-cache checkpoint failed: %s", e)
        # what the run injected and charged, for hosts without the gauge
        # port's /debug/state (no prometheus_client)
        ctx_log(log, logging.INFO, "worker stopped", worker_id=worker_id,
                kernel_launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                chaos_injections=(chaos_plan.debug_state()["injections"] if chaos_plan is not None else None),
                tenants=(worker._debug_tenants()["accounting"] if tenancy is not None else None),
                mesh=(mesh_node.debug_state() if mesh_node is not None else None))
        if snap_lock is not None:
            snap_lock.close()
    return 0


def cmd_ui(args: argparse.Namespace) -> int:
    from foremast_tpu_torch.ui.app import serve as serve_ui

    serve_ui(
        host=args.host,
        port=args.port,
        service_endpoint=args.service_endpoint,
        namespace=args.namespace,
        app_name=args.app,
        demo=args.demo,
    )
    return 0


def cmd_rules(args: argparse.Namespace) -> int:
    from foremast_tpu_torch.metrics.rules import prometheus_rule_manifest, to_yaml

    sys.stdout.write(to_yaml(prometheus_rule_manifest(namespace=args.namespace)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="foremast_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    # each parser carries its handler via set_defaults(fn=...)
    _add_score(sub)

    p = sub.add_parser("serve", help="REST job gateway on :8099")
    p.set_defaults(fn=cmd_serve)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8099)
    p.add_argument("--elastic-url", default=None, help="Elasticsearch backend (ELASTIC_URL parity); default in-memory")
    p.add_argument("--query-endpoint", default=None,
                   help="upstream Prometheus for /api/v1 proxy (QUERY_SERVICE_ENDPOINT)")

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
        help="score over the global device mesh: every card of this process, and with "
        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID set, pod mode (one worker "
        "across those processes, rank 0 the leader)",
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

    for name, fn, helptext in (
        ("watch", cmd_watch, "enable continuous monitoring (kubectl-watch parity)"),
        ("unwatch", cmd_unwatch, "disable continuous monitoring"),
    ):
        p = sub.add_parser(name, help=helptext)
        p.set_defaults(fn=fn)
        p.add_argument("name", help="DeploymentMonitor name (the app)")
        p.add_argument("--namespace", "-n", default="default")
        p.add_argument("--api-server", default=None, help="API server URL (default in-cluster)")

    p = sub.add_parser("watch-plane", help="K8s controller loop: deployment watcher + status poller + remediation")
    p.set_defaults(fn=cmd_watch_plane)
    p.add_argument("--api-server", default=None, help="API server URL (default in-cluster)")
    p.add_argument("--namespace", default=None, help="controller's own namespace (NAMESPACE downward-API parity)")
    p.add_argument(
        "--gauge-port",
        type=int,
        default=0,
        help="controller metrics/varz exposition port (0 disables; pick a port distinct from the worker's :8000 "
        "when co-hosted)",
    )

    p = sub.add_parser("ui", help="dashboard on :8080 (foremast-browser parity)")
    p.set_defaults(fn=cmd_ui)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--service-endpoint", default=None, help="job-gateway base URL (FOREMAST_SERVICE_ENDPOINT)")
    p.add_argument("--namespace", default=None, help="charted namespace label")
    p.add_argument("--app", default=None, help="charted app label")
    p.add_argument("--demo", action="store_true",
                   help="serve synthetic series from this process (no Prometheus needed)")

    p = sub.add_parser("rules", help="print recording-rules manifest YAML")
    p.set_defaults(fn=cmd_rules)
    p.add_argument("--namespace", default="monitoring")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
