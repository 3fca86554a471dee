"""Dapper-style span pipeline: one correlation ID per judgment, end to end.

The port's own copy of the JAX package's `foremast_tpu/observe/spans.py`
(the /metrics server waits for the port's shell). A tick opens a root
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
wraps the region in ``torch.profiler.record_function`` so host spans and
CUDA kernels land on one `torch.profiler` timeline. It records a marker
and never synchronizes the card: the columnar dispatch stays sync-free.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import logging
import os
import threading
import time
import uuid

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
            # Perfetto wants a numeric tid; mask to keep it in range
            "tid": threading.get_ident() & 0x7FFFFFFF,
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


@contextlib.contextmanager
def _null_span():
    yield None


def _device_annotation(name: str):
    """`torch.profiler.record_function(name)`: a marker on the profiler
    timeline when a profiler is active, and no device work at all."""
    import torch

    return torch.profiler.record_function(name)


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
        if parent is None:
            # fresh root: restart the stage breakdown (atomic swap, so a
            # concurrent reader sees old-or-new, never a mix)
            self.last_stage_seconds = {}
        token = _ACTIVE.set((self, s))
        try:
            with _device_annotation(name) if device else _null_span():
                yield s
        finally:
            s.duration = time.perf_counter() - s._t0
            _ACTIVE.reset(token)
            self._finish(s, root=parent is None)

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
            self.ring.dump_jsonl(target)
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
    when tracing is off (plus the profiler marker for `device=True`)."""
    active = _ACTIVE.get()
    if active is None:
        return _device_annotation(name) if device else _null_span()
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
