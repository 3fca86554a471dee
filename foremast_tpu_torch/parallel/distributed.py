"""Pod mode: one logical worker across several processes over
`torch.distributed` (the JAX package's `parallel/distributed.py`).

N shared-nothing workers against one store scale the reference's way
(independent `BrainWorker`s, CAS claims; no process group involved).
This module adds the other mode: ONE worker spanning every process of a
pod, its judgment split over the pod's data axis
(`parallel.mesh.make_global_mesh`), each rank judging its own blocks on
its own card.

Every process runs the same tick over the same documents, and exactly
one process talks to the outside world. The adapters enforce that split:

  * `broadcast_obj`   — pickle-broadcast a host object from rank 0 over
    the pod's gloo group (`torch.distributed.broadcast_object_list`),
    under a watchdog (`FOREMAST_POD_TIMEOUT_SECONDS`);
  * `LeaderStore`     — JobStore adapter: rank 0 claims and writes
    against the real store and broadcasts the claim set, so every rank
    ticks over IDENTICAL documents; follower writes are no-ops;
  * `LeaderSource`    — MetricSource adapter: rank 0 fetches, the series
    are broadcast. `concurrent_fetch = False` is load-bearing: fetches
    are collectives, so their ORDER must be the same on every process,
    and the worker then fetches on the tick thread alone (no fetch pool,
    no prefetch pool, no pipeline thread);
  * `PodWorker`       — a BrainWorker whose clock, knobs and stop
    decision are the leader's, broadcast (the settled-history admission
    gates compare against `now`; two clocks either side of a boundary
    would route one document down two code paths and desynchronize the
    ranks' collectives).

Determinism for everything else: given identical documents, series,
clock and caches, the worker's control flow is a pure function, so fit
caches, gap anchors and arena row assignment evolve identically on every
rank. Each rank fits only its own blocks, and the judge gathers every
block's result to every rank (`ShardedJudge._fetch`), cold fits
included, so every rank's fit cache holds the same entries; the arenas
are replicated (`ShardedJudge._resolve_arena_shards` gives 1) and every
rank scatters identical rows into its own replica.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from foremast_tpu_torch.jobs.store import JobStore
from foremast_tpu_torch.jobs.worker import BrainWorker
from foremast_tpu_torch.metrics.source import MetricSource
from foremast_tpu_torch.parallel.mesh import PodCollectiveError, make_global_mesh, process_count, process_index

log = logging.getLogger("foremast_tpu_torch.parallel.distributed")

# broadcasts made by this process: calls, payload bytes, and seconds the
# calling thread spent in them (the tick thread: the only caller)
BROADCASTS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def is_leader() -> bool:
    return process_index() == 0


class PodCollectiveTimeout(PodCollectiveError):
    """A pod broadcast did not complete within the watchdog budget: a
    peer process (usually the leader) is dead or wedged. Raised so the
    process FAILS FAST instead of hanging inside a collective forever:
    the tick aborts, the process exits, and the in-flight claims age out
    into another worker via MAX_STUCK_IN_SECONDS. Unlike the JAX
    package's (a RuntimeError, where the runtime itself ends a process
    whose coordinator died), it is a `PodCollectiveError`, a
    BaseException: the worker's per-document error handling must not
    swallow it."""


def _pod_timeout_seconds() -> float | None:
    raw = os.environ.get("FOREMAST_POD_TIMEOUT_SECONDS", "300")
    try:
        t = float(raw)
    except ValueError:
        return 300.0
    return t if t > 0 else None


def collective_timeout() -> timedelta:
    """The process groups' own timeout (rendezvous and every gloo
    collective): twice the watchdog, at least 60 s, so the watchdog
    fires first; torch's default 30 minutes with the watchdog off."""
    t = _pod_timeout_seconds()
    if t is None:
        return timedelta(minutes=30)
    return timedelta(seconds=max(60.0, 2.0 * t))


_host_group = None


def host_group():
    """The gloo group that carries host objects (claims, series, the
    clock, knobs, the model-cache restore): the default group when it is
    gloo, as `parallel.mesh.init_distributed` makes it, else a gloo group
    of every rank made on the first call. That first call is itself a
    collective: `make_global_mesh` makes it on every rank."""
    global _host_group
    if dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo", timeout=collective_timeout())
    return _host_group


def _broadcast_raw(obj=None):
    # the leader pickles once; the collective then moves a bytes object,
    # whose own pickling is a copy
    leader = is_leader()
    box = [pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL) if leader else None]
    dist.broadcast_object_list(box, src=0, group=host_group())
    payload = box[0]
    BROADCASTS["bytes"] += len(payload)
    return obj if leader else pickle.loads(payload)


class _BroadcastWorker:
    """ONE persistent daemon thread executing pod broadcasts in order.

    A thread per call would land on the per-fetch hot path (a fleet-cold
    pod tick issues thousands of broadcasts); one worker keeps the
    watchdog at one Event wait per call and, unlike a ThreadPoolExecutor,
    never registers an atexit join, so a thread wedged inside a dead
    peer's collective cannot block the fail-fast exit the watchdog exists
    to guarantee."""

    def __init__(self):
        self._tasks: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="foremast-pod-broadcast")
        self._thread.start()

    def _loop(self):
        while True:
            obj, box, done = self._tasks.get()
            try:
                box.append(("ok", _broadcast_raw(obj)))
            except BaseException as e:  # noqa: BLE001 - re-raised on the caller
                box.append(("err", e))
            finally:
                done.set()

    def run(self, obj, timeout: float):
        done = threading.Event()
        box: list = []
        self._tasks.put((obj, box, done))
        if not done.wait(timeout):
            # the worker stays wedged in the dead collective; the caller
            # now aborts the tick and the process EXITS (daemon thread,
            # no atexit join)
            raise PodCollectiveTimeout(
                f"pod broadcast incomplete after {timeout:.0f}s — a peer process is dead or wedged; "
                "aborting the tick so in-flight claims can age out (MAX_STUCK_IN_SECONDS takeover)"
            )
        kind, val = box[0]
        if kind == "err":
            raise val
        return val


_broadcast_worker: _BroadcastWorker | None = None


def broadcast_obj(obj=None):
    """Broadcast a picklable host object from rank 0 to every process.

    Followers pass anything (ignored) and receive the leader's object.
    With one process it returns `obj` unchanged and makes no collective.

    Every pod broadcast runs under a WATCHDOG
    (`FOREMAST_POD_TIMEOUT_SECONDS`, default 300; `0` disables): a
    follower blocked inside a collective would otherwise hang the pod
    while its claims sit un-aged on the store. On timeout
    `PodCollectiveTimeout` propagates: the tick aborts, the process
    exits, and the stuck-claim takeover recovers the in-flight documents.
    A collective that fails outright (a dead peer's closed sockets)
    raises `PodCollectiveError` the same way. Only the tick thread may
    call this (collective ORDER is load-bearing), and the one persistent
    worker thread keeps the sequence."""
    if process_count() == 1:
        return obj
    t0 = time.perf_counter()
    try:
        timeout = _pod_timeout_seconds()
        if timeout is None:
            return _broadcast_raw(obj)
        global _broadcast_worker
        if _broadcast_worker is None:
            _broadcast_worker = _BroadcastWorker()
        return _broadcast_worker.run(obj, timeout)
    except Exception as e:  # noqa: BLE001 - a peer is gone: the pod is broken
        raise PodCollectiveError(f"pod broadcast failed: {e!r}") from e
    finally:
        BROADCASTS["calls"] += 1
        BROADCASTS["seconds"] += time.perf_counter() - t0


class LeaderStore(JobStore):
    """Only rank 0 talks to the real store; claims are broadcast.

    Followers construct this with `inner=None`: they never need a
    connection, so the store's credentials only have to exist on the
    leader."""

    def __init__(self, inner: JobStore | None):
        if is_leader() and inner is None:
            raise ValueError("process 0 needs the real store")
        self.inner = inner

    def claim(self, worker_id, max_stuck_seconds, limit=64, claim_filter=None):
        # a leader's claim failure must CROSS the broadcast: raising
        # before broadcast_obj would leave every follower blocked in the
        # collective while the leader's loop moved on. The error ships
        # as a marker and re-raises on every process with its transience,
        # so the worker's claim degradation (transient -> empty tick)
        # stays pod-consistent.
        #
        # `claim_filter` is the mesh-of-pods seam: only the leader holds
        # a worker-mesh seat, so only it passes a filter; the filtered
        # claim set then broadcasts like any other, applied BEFORE the
        # broadcast, never after.
        if is_leader():
            try:
                kw = {"claim_filter": claim_filter} if claim_filter is not None else {}
                docs = self.inner.claim(worker_id, max_stuck_seconds, limit, **kw)
            except Exception as e:  # noqa: BLE001 - must cross processes
                from foremast_tpu_torch.chaos.degrade import is_transient_error

                docs = _ClaimError(repr(e), is_transient_error(e))
        else:
            docs = None
        docs = broadcast_obj(docs)
        if isinstance(docs, _ClaimError):
            if docs.transient:
                raise ConnectionError(docs.msg)
            raise RuntimeError(docs.msg)
        return docs

    def update(self, doc):
        if is_leader():
            return self.inner.update(doc)
        return doc

    def update_many(self, docs):
        if is_leader():
            self.inner.update_many(docs)

    def create(self, doc):
        if not is_leader():
            raise RuntimeError("create() is leader-only in pod mode")
        return self.inner.create(doc)

    def get(self, doc_id):
        return broadcast_obj(self.inner.get(doc_id) if is_leader() else None)

    def list_open(self):
        return broadcast_obj(self.inner.list_open() if is_leader() else None)

    def count_open(self):
        # varz only (/debug/state), asked from the observe server's
        # thread: it must NOT enter a collective, since followers serve no
        # debug state and a broadcast here would have no partner. The
        # leader answers locally; followers hold no queue.
        return self.inner.count_open() if is_leader() else 0


class LeaderSource(MetricSource):
    """Only rank 0 fetches series; they are broadcast.

    Every fetch is a collective, so the order must be the same on every
    rank: `concurrent_fetch = False` makes the worker fetch serially on
    the tick thread (document order is broadcast-identical, alias order
    is config order). A leader's fetch error must not desynchronize the
    pod: the error itself is broadcast and re-raised on every process,
    so all of them take the preprocess-failure branch together."""

    concurrent_fetch = False

    def __init__(self, inner: MetricSource | None):
        if is_leader() and inner is None:
            raise ValueError("process 0 needs the real source")
        self.inner = inner

    def fetch(self, url: str):
        if is_leader():
            try:
                out = self.inner.fetch(url)
            except Exception as e:  # noqa: BLE001 - must cross processes
                out = _FetchError(repr(e))
        else:
            out = None
        out = broadcast_obj(out)
        if isinstance(out, _FetchError):
            raise RuntimeError(out.msg)
        return out


class _FetchError:
    def __init__(self, msg: str):
        self.msg = msg


class _ClaimError:
    """Broadcast marker for a leader's claim failure (`LeaderStore.claim`);
    `transient` carries the degradation classification across processes."""

    def __init__(self, msg: str, transient: bool):
        self.msg = msg
        self.transient = transient


def _no_verdict_hook(doc, verdicts) -> None:
    return None


class PodWorker(BrainWorker):
    """BrainWorker for pod mode: the leader's clock, knobs and stop.

    Construct with a LeaderStore / LeaderSource pair on every rank. The
    univariate judge is a ShardedJudge over the pod's mesh (`device_mesh`,
    by default `make_global_mesh` over the worker's card, or over
    `device` itself when that is the CPU): the claim set, series and clock
    are the leader's, each rank judges its own blocks, every rank gathers
    every result, and only the leader persists.

    Control-flow-shaping knobs are leader-broadcast at construction too:
    a per-host skew in the cold-chunk size, the arena budgets, the
    bf16-delta gate or the presence of a verdict hook (which decides
    whether bands come back) would make ranks issue differently shaped
    programs (or one take the stacked-score fallback while its peers use
    the arena) and desynchronize the gathers."""

    def __init__(self, store, source, config=None, device="cuda", device_mesh="pod", **kwargs):
        if isinstance(device_mesh, str) and device_mesh == "pod":
            cpu = torch.device(device).type != "cuda"
            device_mesh = make_global_mesh(devices=[device] if cpu else None)
        super().__init__(store, source, config=config, device=device, device_mesh=device_mesh, **kwargs)
        from foremast_tpu_torch.engine.arena import _arena_bytes, _arena_max_bytes, set_arena_budget
        from foremast_tpu_torch.engine.scoring import bf16_delta_enabled, set_bf16_delta

        knobs = broadcast_obj(
            (
                self.cold_chunk_docs,
                self.pipeline_depth,
                self.fetch_workers,
                _arena_bytes(),
                _arena_max_bytes(),
                bf16_delta_enabled(),
                self.on_verdict is not None,
            )
            if is_leader()
            else None
        )
        # the per-tick deadline decides per-document control flow off a
        # LOCAL clock: two ranks disagreeing on "past the budget" would
        # judge differently shaped batches. Pod mode runs unbudgeted (the
        # watchdog still bounds a wedged collective).
        self._degrade.tick_budget_seconds = 0.0
        # sliced sweeps stay OFF for the same reason: slice boundaries,
        # dirty promotion and the warm pipeline's prefetch-thread fetches
        # are process-local control flow, and LeaderSource fetches must
        # never run off the tick thread. Every rank runs the monolithic
        # tick.
        self.sweep_slice_docs = 0
        if knobs is not None and not is_leader():
            self.cold_chunk_docs = knobs[0]
            # depth and pool size for completeness: LeaderSource forces
            # the serial path, but no control-flow knob may skew per host
            self.pipeline_depth = knobs[1]
            self.fetch_workers = knobs[2]
            # process-local overrides, NOT os.environ writes (mutating the
            # env once threads exist is a cross-thread race)
            set_arena_budget(knobs[3], knobs[4])
            set_bf16_delta(knobs[5])
            # a verdict hook decides whether the columnar programs bring
            # bands back (`with_bands`), so every rank follows the
            # leader's: a follower without one gets a no-op hook, and a
            # follower's own hook runs only when the leader has one
            self.on_verdict = (self.on_verdict or _no_verdict_hook) if knobs[6] else None

    def tick(self, now: float | None = None) -> int:
        if now is None:
            now = broadcast_obj(time.time() if is_leader() else None)
        return super().tick(now=now)

    def run(self, poll_seconds: float = 5.0, stop=None, after_tick=None) -> None:
        """Tick until the LEADER's `stop()` says so: its decision is
        broadcast once a cycle, so every rank leaves the loop after the
        same tick and a SIGTERM to the leader stops the whole pod cleanly
        (a follower's own stop is not consulted). Idle waits are local;
        micro-ticks do not run in pod mode. `after_tick(n)` runs after
        every tick on every rank, its failures logged."""

        def leader_stop() -> bool:
            return bool(broadcast_obj(bool(stop is not None and stop()) if is_leader() else None))

        while not leader_stop():
            n = self.tick()
            if after_tick is not None:
                try:
                    after_tick(n)
                except Exception:  # noqa: BLE001 - housekeeping must not kill the loop
                    log.exception("after_tick hook failed")
            if n == 0:
                deadline = time.monotonic() + poll_seconds
                while time.monotonic() < deadline and not (is_leader() and stop is not None and stop()):
                    time.sleep(min(0.25, max(deadline - time.monotonic(), 0.0)))
