"""Dapper-style span pipeline: one correlation ID per judgment, end to end.

The port's own copy of the JAX package's `foremast_tpu/observe/spans.py`,
with the worker's `/metrics` + `/healthz` + `/debug/state` server
(`start_observe_server`). A tick opens a root
span on the worker's `Tracer`; every stage span below it — claim, fetch,
fit, arena assembly, score, decode, decide, write-back — parents to it
through one contextvar, so the engine and store need no tracer plumbing
and un-instrumented callers pay one contextvar read per call site. It
exports:

  * ``Tracer.last_stage_seconds`` — the latest root span's per-stage
    breakdown (what `/debug/state` shows and `chip_smoke.py` prints);
  * ``foremast_tick_stage_seconds{stage=...}`` histograms, only when the
    Tracer is given a prometheus_client registry (the package is
    imported then, and never otherwise: the card's machine has none);
  * a bounded ring buffer of Chrome-trace events, dumped as JSONL that
    Perfetto loads directly — gated by ``FOREMAST_TRACE_DIR`` (or an
    explicit ``trace_dir``);
  * trace/span IDs on the JSON log records (``observe.logs``).

Host spans around device work pass ``device=True``, which additionally
wraps the region in ``torch.profiler.record_function`` while a profiler
records, so host spans and CUDA kernels land on one `torch.profiler`
timeline. It records a marker and never synchronizes the card: the
columnar dispatch stays sync-free. With no profiler running it costs
nothing more than the span.

The collector's pauses are spans too. The first Tracer of the process
installs one `gc.callbacks` entry; every collection of generation 1 or
2 that starts while a root span is open becomes a ``gc.collect`` span
(stage ``gc``) under the span that was open on the collecting thread,
and the young collections are counted (``debug_state()["gc"]``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import json
import logging
import os
import threading
import time
import uuid
import weakref

log = logging.getLogger("foremast_tpu_torch.observe.spans")

# (tracer, span) of the innermost open span. One var, not two: the
# module-level span() helper must attach children to the SAME tracer
# that opened the enclosing root, never to some other instance.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "foremast_torch_active_span", default=None
)

# Stage-histogram buckets: warm columnar stages sit in the 100 us - 10 ms
# band while a fleet-cold fit runs seconds; the default prometheus
# buckets would collapse the warm path into one bucket.
STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# The canonical tick stages: claim → metric_fetch → fit → arena_assemble
# → score → decode → decide → write_back.
TICK_STAGES = (
    "claim",
    "metric_fetch",
    "fit",
    "arena_assemble",
    "score",
    "decode",
    "decide",
    "write_back",
)

# Stages only the port's tick opens (the JAX tracer has none of them): the
# worker's admission walk and columnar packing (and the object path's
# operand packing), the host's waits on a result copy from the card, and
# the collector's pauses of generation 1 and 2. `device_wait` and `gc`
# nest inside other stages (a wait inside fit or decode, a collection
# inside whatever was open on the collecting thread), so their seconds
# are counted twice in `last_stage_seconds` and the stage histogram: do
# not add them to the other stages.
PORT_STAGES = ("admit", "pack", "device_wait", "gc")


# epoch offset of the monotonic clock, taken once at import
_CLOCK_ANCHOR = time.time() - time.perf_counter()


def new_trace_id() -> str:
    """Mint a correlation ID in the span-pipeline format."""
    return uuid.uuid4().hex[:16]


_new_id = new_trace_id


class Span:
    """One timed region. Completed spans are exported as Chrome trace
    events (phase "X": complete event with ts+dur in microseconds)."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "stage",
        "attrs",
        "ts",
        "duration",
        "_t0",
        "tid",
    )

    def __init__(self, name, trace_id, parent_id, stage=None, attrs=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.stage = stage
        self.attrs = attrs or {}
        self.duration = 0.0
        self._t0 = time.perf_counter()
        # wall-clock ts derived from ONE anchor + the monotonic clock:
        # if NTP steps the wall clock mid-tick, per-span time.time()
        # would shift later spans past/before their parent on the
        # Perfetto timeline while durations stay monotonic
        self.ts = _CLOCK_ANCHOR + self._t0
        # the OS thread id, as the profiler's trace names thread rows
        self.tid = threading.get_native_id()

    def to_event(self) -> dict:
        args = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
        }
        if self.stage:
            args["stage"] = self.stage
        args.update(self.attrs)
        return {
            "name": self.name,
            "cat": "foremast",
            "ph": "X",
            "ts": round(self.ts * 1e6, 1),
            "dur": round(self.duration * 1e6, 1),
            "pid": os.getpid(),
            # the thread that opened it (a collection's: the collecting
            # thread), as the profiler's trace numbers its rows
            "tid": self.tid,
            "args": args,
        }


class SpanRing:
    """Thread-safe bounded buffer of completed-span trace events: the
    newest `capacity` spans win; `total` counts everything ever added so
    a dump can report how much history scrolled away."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0

    def add(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
            self.total += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump_jsonl(self, path: str) -> int:
        """Write one Chrome trace event per line (Perfetto's JSON
        importer accepts newline-delimited events); returns #events.
        Written to a sibling temp file and renamed, so a reader never
        loads a half-written dump."""
        events = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, path)
        return len(events)


# a reusable no-op context (yields None)
_NULL = contextlib.nullcontext()


def _device_annotation(name: str):
    """`torch.profiler.record_function(name)` while a profiler records: a
    marker on its timeline, and no device work at all. With no profiler
    running, the no-op context: a marker nothing records costs 7 us."""
    import torch

    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


# -- the collector's pauses --------------------------------------------------

# the tracers with an open root span: what the process's one
# `gc.callbacks` entry (`_gc_callback`) reads, through the weak set's own
# set of references (one C call to test or copy, no iteration guard)
_GC_OPEN: "weakref.WeakSet" = weakref.WeakSet()
_GC_REFS = _GC_OPEN.data
# the running collection: (start, generation, native thread id, owners),
# owners being the open tracers' weak references (generation 0) or
# (tracer, parent span) pairs (generations 1-2); None when none runs
_GC_RUNNING = None
_GC_HOOK_LOCK = threading.Lock()


def _gc_callback(phase: str, info: dict) -> None:
    """The process's one `gc.callbacks` entry. A collection can start
    anywhere, inside `SpanRing.add`'s lock or a metric family's, so this
    takes no lock and calls no exporter: it notes a collection that
    starts while a root is open, and on its stop counts it on each such
    tracer and, for generations 1 and 2, appends (start, end,
    generation, parent, thread) to the tracer's `_gc_done` deque. The
    tracer makes them spans when it closes a root. A young collection
    runs thousands of times a sweep, so it is only counted."""
    global _GC_RUNNING
    if phase == "start":
        if not _GC_REFS:
            return
        gen = info["generation"]
        if not gen:
            _GC_RUNNING = (time.perf_counter(), 0, 0, tuple(_GC_REFS))
            return
        active = _ACTIVE.get()
        owners = []
        for ref in tuple(_GC_REFS):
            tracer = ref()
            if tracer is None:
                continue
            if active is not None and active[0] is tracer:
                parent = active[1]
            else:
                try:
                    parent = tracer._open_roots[-1]
                except IndexError:  # its last root closed meanwhile
                    continue
            owners.append((tracer, parent))
        _GC_RUNNING = (time.perf_counter(), gen, threading.get_native_id(), owners)
        return
    running = _GC_RUNNING
    if running is None:
        return
    t1 = time.perf_counter()
    _GC_RUNNING = None
    t0, gen, tid, owners = running
    if not gen:
        for ref in owners:
            tracer = ref()
            if tracer is not None:
                tracer._gc_count[0] += 1
                tracer._gc_seconds[0] += t1 - t0
        return
    for tracer, parent in owners:
        tracer._gc_count[gen] += 1
        tracer._gc_seconds[gen] += t1 - t0
        tracer._gc_done.append((t0, t1, gen, parent, tid))


def _install_gc_hook() -> None:
    """Add `_gc_callback` to `gc.callbacks` once a process."""
    with _GC_HOOK_LOCK:
        if _gc_callback not in gc.callbacks:
            gc.callbacks.append(_gc_callback)


class Tracer:
    """Per-process span factory + exporters.

    One Tracer per entry point (the worker loop). Opening a span
    publishes it as the context's active span, so nested module-level
    :func:`span` calls — judge, arena, store — parent to it automatically
    and share its trace ID. `registry` (a prometheus_client registry)
    turns on the stage histogram; without one there is none.
    """

    # flush the ring to disk at most this often (root-span exits only)
    AUTOFLUSH_SECONDS = 10.0

    def __init__(
        self,
        service: str = "foremast",
        registry=None,
        trace_dir: str | None = None,
        buffer_size: int = 8192,
    ):
        self.service = service
        self.trace_dir = (
            trace_dir
            if trace_dir is not None
            else (os.environ.get("FOREMAST_TRACE_DIR") or None)
        )
        self.ring = SpanRing(buffer_size) if self.trace_dir else None
        # stage -> seconds within the latest root span; reset when a new
        # root opens so the breakdown never mixes stages of two ticks
        self.last_stage_seconds: dict[str, float] = {}
        self._hist = None
        if registry is not None:
            from prometheus_client import Histogram

            self._hist = Histogram(
                "foremast_tick_stage_seconds",
                "duration of one judgment-tick stage",
                ["stage"],
                registry=registry,
                buckets=STAGE_BUCKETS,
            )
        self._last_flush = time.monotonic()
        self._flush_lock = threading.Lock()
        self._flush_active = False
        self._flush_warned = False
        # serializes dump_jsonl between explicit flush() callers and the
        # background autoflush thread (both write the same target path)
        self._io_lock = threading.Lock()
        # the open root spans (the collector's spans parent to the newest
        # when the collecting thread has none of this tracer's open)
        self._open_roots: list[Span] = []
        self._roots_lock = threading.Lock()
        # finished collections of generation 1-2, appended by the gc hook
        # and made spans at a root's close; collections and seconds per
        # generation while a root was open
        self._gc_done: collections.deque = collections.deque()
        self._gc_count = [0, 0, 0]
        self._gc_seconds = [0.0, 0.0, 0.0]
        # the finished spans of a profiled region (`capture`), else None
        self._captured: list | None = None
        _install_gc_hook()

    # -- span creation ---------------------------------------------------

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        stage: str | None = None,
        trace_id: str | None = None,
        device: bool = False,
        **attrs,
    ):
        """Open a span. Child of the context's active span unless an
        explicit `trace_id` is given (adopting a correlation ID carried
        by a request/document starts a fresh root under that ID).
        `device=True` wraps the region in `torch.profiler.record_function`
        so it shows on the profiler's timeline too."""
        parent = current_span()
        if trace_id is not None:
            s = Span(name, trace_id, "", stage=stage, attrs=attrs)
        elif parent is not None:
            s = Span(
                name, parent.trace_id, parent.span_id, stage=stage, attrs=attrs
            )
        else:
            s = Span(name, _new_id(), "", stage=stage, attrs=attrs)
        root = parent is None
        if root:
            # fresh root: restart the stage breakdown (atomic swap, so a
            # concurrent reader sees old-or-new, never a mix)
            self.last_stage_seconds = {}
            with self._roots_lock:
                self._open_roots.append(s)
                _GC_OPEN.add(self)
        token = _ACTIVE.set((self, s))
        try:
            with _device_annotation(name) if device else _NULL:
                yield s
        finally:
            s.duration = time.perf_counter() - s._t0
            _ACTIVE.reset(token)
            if root:
                with self._roots_lock:
                    self._open_roots.remove(s)
                    if not self._open_roots:
                        _GC_OPEN.discard(self)
                self._finish_collections()
            self._finish(s, root=root)

    def _finish_collections(self) -> None:
        """The collections of generation 1-2 that the gc hook noted, as
        `gc.collect` spans with their own start and length, each under
        the span that was open when it started."""
        done = self._gc_done
        while True:
            try:
                t0, t1, gen, parent, tid = done.popleft()
            except IndexError:
                return
            g = Span("gc.collect", parent.trace_id, parent.span_id, stage="gc", attrs={"generation": gen})
            g._t0, g.ts, g.duration, g.tid = t0, _CLOCK_ANCHOR + t0, t1 - t0, tid
            self._finish(g, root=False)

    @contextlib.contextmanager
    def capture(self):
        """Also keep, in the list this yields, every span that finishes
        inside the region (what `observe.profile.trace_scoring` adds to
        its Chrome trace)."""
        got: list[Span] = []
        prev, self._captured = self._captured, got
        try:
            yield got
        finally:
            self._captured = prev

    def _finish(self, s: Span, root: bool) -> None:
        if s.stage is not None:
            # accumulate: a tick may open several spans per stage (chunked
            # fetch/decide, per-bucket score) and the breakdown must
            # attribute ALL of that stage's time, not the last chunk's
            self.last_stage_seconds[s.stage] = (
                self.last_stage_seconds.get(s.stage, 0.0) + s.duration
            )
            if self._hist is not None:
                self._hist.labels(stage=s.stage).observe(s.duration)
        if self._captured is not None:
            self._captured.append(s)
        if self.ring is not None:
            self.ring.add(s.to_event())
            if root:
                self._autoflush()

    def _autoflush(self) -> None:
        """Flush on a daemon thread: root-span exit runs on whatever
        thread closed the span, and serializing the whole ring there
        would stall it. At most one background flush at a time."""
        with self._flush_lock:
            if self._flush_active:
                return
            if (
                time.monotonic() - self._last_flush
                < self.AUTOFLUSH_SECONDS
            ):
                return
            self._flush_active = True
            self._last_flush = time.monotonic()

        def _run():
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 - tracing must never break a tick
                # warn ONCE: an unwritable FOREMAST_TRACE_DIR otherwise
                # fails every 10 s with zero signal until shutdown
                if not self._flush_warned:
                    self._flush_warned = True
                    log.warning(
                        "trace flush to %s failed (%s); dumps disabled "
                        "until the path is writable",
                        self.trace_path(),
                        e,
                    )
            finally:
                with self._flush_lock:
                    self._flush_active = False

        threading.Thread(
            target=_run, name="foremast-trace-flush", daemon=True
        ).start()

    # -- export ----------------------------------------------------------

    def trace_path(self) -> str | None:
        if not self.trace_dir:
            return None
        return os.path.join(
            self.trace_dir,
            f"foremast-{self.service}-{os.getpid()}.trace.jsonl",
        )

    def flush(self, path: str | None = None) -> str | None:
        """Dump the ring buffer as Perfetto-loadable JSONL; returns the
        path written, or None when the buffer is disabled."""
        if self.ring is None:
            return None
        target = path or self.trace_path()
        with self._io_lock:
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            # _io_lock exists to serialize exactly this dump between
            # explicit flush() callers and the autoflush daemon: two
            # unguarded writers would truncate each other's temp file
            self.ring.dump_jsonl(target)  # foremast: ignore[blocking-under-lock] — see above
        with self._flush_lock:
            self._last_flush = time.monotonic()
        return target

    def debug_state(self) -> dict:
        return {
            "service": self.service,
            "trace_dir": self.trace_dir,
            "buffer_spans": len(self.ring) if self.ring is not None else 0,
            "spans_total": self.ring.total if self.ring is not None else 0,
            "last_stage_seconds": dict(self.last_stage_seconds),
            # collections by generation (0, 1, 2) that started while a
            # root was open; 1 and 2 are also `gc.collect` spans
            "gc": {
                "collections": list(self._gc_count),
                "seconds": [round(x, 6) for x in self._gc_seconds],
            },
        }


# ---------------------------------------------------------------------------
# ambient helpers — what library code uses
# ---------------------------------------------------------------------------


def current_span() -> Span | None:
    """The innermost open span of this context (None outside any)."""
    active = _ACTIVE.get()
    return active[1] if active is not None else None


def span(name: str, stage: str | None = None, device: bool = False, **attrs):
    """Child span on the caller's ambient tracer, or a no-op when no
    tracer opened a span in this context — library code (store, judge,
    arena) instruments unconditionally and costs one contextvar read
    when tracing is off (for `device=True`, one more check: the
    profiler's marker while a profiler records)."""
    active = _ACTIVE.get()
    if active is None:
        return _device_annotation(name) if device else _NULL
    return active[0].span(name, stage=stage, device=device, **attrs)


def inherit_span(fn):
    """Wrap `fn` so it runs under the submitting thread's ambient span.
    ThreadPoolExecutor workers start with an empty context, so without
    this their log records lose the tick's trace_id/span_id. A single
    shared `Context.run` cannot be entered concurrently, so only the
    active-span var is re-seated (and reset) per call."""
    active = _ACTIVE.get()

    def wrapped(*args, **kwargs):
        token = _ACTIVE.set(active)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)

    return wrapped


# ---------------------------------------------------------------------------
# shared metric families and the worker's exposition server
# ---------------------------------------------------------------------------

# one collector object per (registry, name): several BrainGauges or
# Tracer instances over one registry must share a family, not collide on
# prometheus_client's duplicate-registration error
_FAMILIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_FAMILY_LOCK = threading.Lock()


def _shared_family(registry, name: str, make):
    from prometheus_client import REGISTRY

    reg = registry if registry is not None else REGISTRY
    with _FAMILY_LOCK:
        per = _FAMILIES.get(reg)
        if per is None:
            per = {}
            _FAMILIES[reg] = per
        fam = per.get(name)
        if fam is None:
            fam = make(reg)
            per[name] = fam
        return fam


class _NullCounter:
    """What `counter` returns on a host without prometheus_client: it
    takes every `labels(...).inc()` and counts nothing."""

    def labels(self, *args, **kwargs) -> "_NullCounter":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass


_NULL_COUNTER = _NullCounter()


def counter(name: str, documentation: str, labels=(), registry=None):
    """The shared Counter family `name` on `registry` (default: the
    process registry). On a host without prometheus_client, where no
    registry can have been built, a counter that counts nothing, so the
    gateway and the watch plane start there all the same; the gateway's
    /metrics says what is missing."""
    try:
        from prometheus_client import Counter
    except ImportError:
        if registry is not None:
            raise
        return _NULL_COUNTER
    return _shared_family(registry, name, lambda reg: Counter(name, documentation, list(labels), registry=reg))


def start_observe_server(port: int, registry=None, state_fn=None, host: str = "0.0.0.0", max_port_tries: int = 1):
    """Serve /metrics (Prometheus exposition), /healthz, and /debug/state
    (JSON varz from `state_fn`) on one port: the worker's :8000 scrape
    endpoint. Returns (server, thread); the thread is a daemon.
    `max_port_tries` > 1 walks past ports already bound (up to
    port+tries-1); read the actual port from `server.server_address`."""
    import errno
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from prometheus_client import CONTENT_TYPE_LATEST, REGISTRY, generate_latest

    from foremast_tpu_torch import __version__

    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # metrics scrapes must not spam stderr
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(200, generate_latest(reg), CONTENT_TYPE_LATEST)
            elif path == "/healthz":
                body = json.dumps({"ok": True, "version": __version__})
                self._send(200, body.encode(), "application/json")
            elif path == "/debug/state":
                try:
                    state = state_fn() if state_fn is not None else {}
                    code = 200
                except Exception as e:  # noqa: BLE001 - varz must not 500-loop
                    state, code = {"error": str(e)}, 500
                self._send(code, json.dumps(state, default=str, indent=2).encode(), "application/json")
            else:
                self._send(404, b'{"reason": "not found"}', "application/json")

    srv = None
    last_err: OSError | None = None
    # port 0 is the OS's ephemeral pick: walking past it is meaningless
    tries = 1 if port == 0 else max(1, int(max_port_tries))
    for i in range(tries):
        try:
            srv = ThreadingHTTPServer((host, port + i), Handler)
            break
        except OSError as e:
            # only a BUSY port is worth walking past
            if e.errno != errno.EADDRINUSE:
                raise
            last_err = e
    if srv is None:
        raise last_err
    if port and srv.server_address[1] != port:
        log.info("observe port %d busy; serving /metrics + /debug/state on :%d instead", port, srv.server_address[1])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread
