"""Bounded-depth chunk pipeline: overlap metric fetch, judgment, write-back.

The worker's slow path processes a cold claim set in doc chunks
(`FOREMAST_COLD_CHUNK_DOCS`), and before this module each chunk ran
fetch → judge → write strictly serially: the device idled for the whole
Prometheus round trip and ES write-back of every chunk, and the host
idled while the device judged. That is the host/device overlap problem
every training/inference input pipeline solves with prefetch + double
buffering — steady-state wall clock should approach
max(fetch, judge, write) per chunk, not their sum.

Stage contract (what keeps the pipeline write-equivalent to the serial
loop — pinned by tests/test_worker_pipeline.py):

  * ``fetch(chunk)``          — runs on the caller-owned prefetch pool,
    up to ``depth - 1`` chunks ahead of the judge. Side effects are
    limited to caches that are already thread-safe (the hist/fit/gap
    ModelCaches, which today's per-chunk fetch pool mutates from worker
    threads too). Per-doc failures are VALUES (``None`` entries), never
    exceptions — a failed fetch marks only its own doc and cannot stall
    or poison in-flight chunks.
  * ``judge(chunk, payload)`` — tick thread only, strictly in chunk
    order: device dispatch order is load-bearing (arena row assignment
    evolves identically to the serial loop, and pod-mode collectives
    would deadlock under reordering).
  * ``write(chunk, result)``  — store writes + verdict hooks; runs on
    ONE writer thread consuming a FIFO queue, so the store sees the
    same write sequence per chunk the serial loop produced, one chunk
    behind the judgment.

Depth semantics: the prefetch stage runs at most ``depth - 1`` chunks
ahead of the judge, and the write queue holds at most ``depth`` judged
chunks before the judge stalls — so up to ``2 * depth`` chunks can be
resident at once (prefetching + judging + queued), which together with
the chunk size is the host-memory bound for packed histories and
un-persisted verdicts. ``depth <= 1``, a single
chunk, or no prefetch pool all degrade to the inline serial loop — the
worker passes no pool when the source declares
``concurrent_fetch = False`` (pod-mode ``LeaderSource``, whose fetches
are ordered broadcast collectives; in-memory test sources).

Failure semantics ("clean drain"): a fetch-stage exception surfaces on
the tick thread when that chunk's turn to be judged comes; a judge
exception stops feeding immediately (raise :class:`StageError` to also
ship a final partial result — the chunk's fetch-failure markings —
through the writer before the error propagates); a write exception
stops the writer
(later chunks drain unwritten — fail fast, exactly where the serial
loop would have stopped) and re-raises on the tick thread. On every
path the writer thread is joined and in-flight prefetches are awaited
before ``run()`` returns, so no stage thread outlives the tick and
every chunk judged before the failure is persisted.

Sweep extensions, copied with the rest of the JAX package's module (its
warm-path sliced sweep rides the same class; the port's worker runs the
monolithic tick and does not use them yet):

  * ``run()`` accepts an unbounded ITERATOR of chunk specs; a lazy
    fetch stage (a claim-pool-backed slice preparer) returns ``END``
    to stop feeding — the pipeline drains cleanly, never judging END.
  * ``boundary`` — a tick-thread hook invoked between chunks, after
    chunk N's result is handed to the writer: the sliced sweep's
    micro-tick PREEMPTION POINT.
  * ``on_drained(chunk, payload)`` — abort-path callback for chunks
    whose fetch completed but whose judgment never ran, so a fetch
    stage with side effects (claimed documents) can give them back.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time

from foremast_tpu_torch.observe.spans import span

log = logging.getLogger("foremast_tpu_torch.pipeline")

DEFAULT_DEPTH = 2

_DONE = object()

# Lazy-source exhaustion sentinel: a fetch stage backed by a
# claim pool (the sliced sweep) signals "no more work" by RETURNING
# `END` — the pipeline stops feeding, drains in-flight stages, and
# never judges or writes the END chunk. Lists keep working unchanged;
# END just lets `run()` accept an unbounded iterator of slice specs
# whose real extent only the fetch stage can discover.
END = object()


class StageError(Exception):
    """Raised by a judge stage that died partway but still owes the
    write stage a final partial result (e.g. the chunk's fetch-failure
    markings, which the pre-pipeline loop persisted before judging).
    The pipeline writes ``result`` through the ordinary writer path —
    store access stays single-threaded — then stops feeding immediately
    and re-raises ``error`` on the tick thread after the drain."""

    def __init__(self, error: BaseException, result):
        super().__init__(str(error))
        self.error = error
        self.result = result


class PipelineStats:
    """One run's occupancy accounting.

    Mutated only from the tick thread: concurrent stages report their
    timings through return values (fetch) or a post-``join`` merge
    (write), so the counters need no lock and a ``/debug/state`` reader
    sees a consistent snapshot via ``as_dict``.
    """

    __slots__ = (
        "depth",
        "pipelined",
        "completed",
        "chunks",
        "docs",
        "fetch_seconds",
        "judge_seconds",
        "write_seconds",
        "judge_stall_seconds",
        "write_queue_peak",
        "wall_seconds",
    )

    def __init__(self, depth: int):
        self.depth = depth
        self.pipelined = False
        # False while (or after) a run that raised: /debug/state readers
        # must be able to tell a mid-abort snapshot from a healthy tick
        self.completed = False
        self.chunks = 0
        self.docs = 0
        self.fetch_seconds = 0.0  # stage-busy, summed over chunks
        self.judge_seconds = 0.0  # device dispatch + verdict decode
        self.write_seconds = 0.0  # status decide + store round trips
        # time the judge stage (the tick thread) spent waiting for its
        # chunk's windows: a host stall, which the device may or may not
        # have spent idle (the `pipeline.judge_stall` spans time the same)
        self.judge_stall_seconds = 0.0
        self.write_queue_peak = 0
        self.wall_seconds = 0.0

    def overlap_ratio(self) -> float:
        """Fraction of stage-busy time hidden by overlap: ~0 when the
        stages ran back to back (serial), approaching 2/3 at perfect
        three-stage overlap."""
        busy = self.fetch_seconds + self.judge_seconds + self.write_seconds
        if busy <= 0.0 or self.wall_seconds <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.wall_seconds / busy)

    def as_dict(self) -> dict:
        return {
            "depth": self.depth,
            "pipelined": self.pipelined,
            "completed": self.completed,
            "chunks": self.chunks,
            "docs": self.docs,
            "fetch_seconds": round(self.fetch_seconds, 4),
            "judge_seconds": round(self.judge_seconds, 4),
            "write_seconds": round(self.write_seconds, 4),
            "judge_stall_seconds": round(self.judge_stall_seconds, 4),
            "write_queue_peak": self.write_queue_peak,
            "wall_seconds": round(self.wall_seconds, 4),
            "overlap_ratio": round(self.overlap_ratio(), 4),
        }


class ChunkPipeline:
    """Run fetch → judge → write over an ordered chunk list with bounded
    lookahead.

    Generic over the stage callables so the worker (and tests) can
    inject instrumented stages. The prefetch pool is OWNED BY THE
    CALLER and reused across ticks (persistent threads — the worker
    keeps one per process instead of spawning a pool per chunk); pass
    ``prefetch_pool=None`` to force the serial loop.
    """

    def __init__(
        self,
        fetch,
        judge,
        write,
        depth: int = DEFAULT_DEPTH,
        prefetch_pool=None,
        boundary=None,
        on_drained=None,
    ):
        self.fetch = fetch
        self.judge = judge
        self.write = write
        self.depth = max(1, int(depth))
        self.prefetch_pool = prefetch_pool
        # `boundary`: a tick-thread hook invoked between
        # chunks — after chunk N's judgment is handed to the writer and
        # before chunk N+1's is started. The sliced sweep's PREEMPTION
        # POINT: the worker drains pending dirty arrivals here while
        # the writer flushes N and the prefetch pool prepares N+1. A
        # boundary exception aborts the run exactly like a judge
        # exception (clean drain, then re-raise).
        self.boundary = boundary
        # `on_drained(chunk, payload)` (tick thread, abort path only):
        # invoked for every chunk whose fetch COMPLETED but whose
        # judgment never ran when run() aborts. Fetch stages with side
        # effects (the sliced sweep's prepare stage holds CLAIMED docs)
        # use it to give that work back instead of leaving it to the
        # stuck-claim takeover window.
        self.on_drained = on_drained
        # stats of the most recent run(), including one that raised —
        # callers surface occupancy on the abort path from here
        self.last_stats: PipelineStats | None = None

    def run(self, chunks) -> PipelineStats:
        stats = PipelineStats(self.depth)
        self.last_stats = stats
        sized = hasattr(chunks, "__len__")
        if sized:
            stats.chunks = len(chunks)
            stats.docs = sum(
                len(c) if hasattr(c, "__len__") else 1 for c in chunks
            )
        t_wall = time.perf_counter()
        try:
            if self.depth <= 1 or self.prefetch_pool is None or (
                sized and len(chunks) <= 1
            ):
                self._run_serial(chunks, stats)
            else:
                stats.pipelined = True
                self._run_pipelined(chunks, stats)
            stats.completed = True
        finally:
            stats.wall_seconds = time.perf_counter() - t_wall
        return stats

    def _run_serial(self, chunks, stats: PipelineStats) -> None:
        sized = hasattr(chunks, "__len__")
        for chunk in chunks:
            t0 = time.perf_counter()
            payload = self.fetch(chunk)
            t1 = time.perf_counter()
            # accumulated before judging so the abort-path snapshot
            # (completed=False) still carries the chunk's fetch cost
            stats.fetch_seconds += t1 - t0
            if payload is END:
                break
            if not sized:
                stats.chunks += 1
                stats.docs += len(chunk) if hasattr(chunk, "__len__") else 1
            try:
                result = self.judge(chunk, payload)
            except StageError as se:
                t2 = time.perf_counter()
                stats.judge_seconds += t2 - t1
                self.write(chunk, se.result)  # partial: failure markings
                stats.write_seconds += time.perf_counter() - t2
                raise se.error
            t2 = time.perf_counter()
            stats.judge_seconds += t2 - t1
            self.write(chunk, result)
            stats.write_seconds += time.perf_counter() - t2
            if self.boundary is not None:
                self.boundary()

    def _run_pipelined(self, chunks, stats: PipelineStats) -> None:
        write_errors: list[BaseException] = []
        write_seconds = [0.0]  # writer-thread local; read after join()
        wq: queue.Queue = queue.Queue(maxsize=self.depth)

        def writer():
            # One thread, FIFO: the store sees the serial loop's
            # per-chunk write order. After a write error, later chunks
            # drain UNWRITTEN — fail fast at the same point the serial
            # loop would have stopped.
            while True:
                item = wq.get()
                if item is _DONE:
                    return
                if write_errors:
                    continue
                chunk, result = item
                t0 = time.perf_counter()
                try:
                    self.write(chunk, result)
                except BaseException as e:  # noqa: BLE001 — re-raised on the tick thread
                    write_errors.append(e)
                    # log HERE, not only via the tick-thread re-raise: if
                    # a judge/fetch error propagates first it wins the
                    # raise, and a store outage recorded only in
                    # write_errors would otherwise vanish unreported
                    log.exception(
                        "pipeline write-back failed; remaining chunks "
                        "drain unwritten"
                    )
                finally:
                    write_seconds[0] += time.perf_counter() - t0

        wt = threading.Thread(
            target=writer, name="foremast-writeback", daemon=True
        )
        wt.start()

        def timed_fetch(chunk):
            t0 = time.perf_counter()
            payload = self.fetch(chunk)
            return time.perf_counter() - t0, payload

        # one iterator serves lists and lazy sources alike; a lazy
        # source's true extent surfaces as an END payload from fetch
        sized = hasattr(chunks, "__len__")
        it = iter(chunks)
        pending: collections.deque = collections.deque()
        exhausted = [False]

        def submit_next():
            if exhausted[0]:
                return
            try:
                chunk = next(it)
            except StopIteration:
                exhausted[0] = True
                return
            pending.append(
                (chunk, self.prefetch_pool.submit(timed_fetch, chunk))
            )

        try:
            for _ in range(self.depth - 1):
                submit_next()
            while pending:
                if write_errors:
                    break  # writer failed; don't burn device time on
                    # a judgment whose result could never be written
                chunk, fut = pending.popleft()
                # no stage: a wait on this thread must not cover the
                # other threads' work in a tick's stage breakdown
                with span("pipeline.judge_stall"):
                    t0 = time.perf_counter()
                    fetch_s, payload = fut.result()
                    stall = time.perf_counter() - t0
                stats.judge_stall_seconds += stall
                stats.fetch_seconds += fetch_s
                if payload is END:
                    # lazy source drained: stop SUBMITTING, but keep
                    # consuming the deque — with 2+ prefetch workers
                    # (depth >= 3) a fully prepared chunk can sit
                    # QUEUED BEHIND the END that raced it for the
                    # source's last items; abandoning it to the drain
                    # path would un-do real work on a healthy run
                    exhausted[0] = True
                    continue
                if not sized:
                    stats.chunks += 1
                    stats.docs += (
                        len(chunk) if hasattr(chunk, "__len__") else 1
                    )
                submit_next()  # keep the lookahead window full
                t1 = time.perf_counter()
                try:
                    result = self.judge(chunk, payload)
                except StageError as se:
                    # stop feeding NOW (no further chunk touches the
                    # broken judge), but the partial result still rides
                    # the writer queue so the failure markings persist;
                    # the finally block drains it before `error`
                    # propagates off the tick thread
                    stats.judge_seconds += time.perf_counter() - t1
                    wq.put((chunk, se.result))
                    raise se.error
                stats.judge_seconds += time.perf_counter() - t1
                if write_errors:
                    break  # writer failed mid-judgment; stop feeding
                wq.put((chunk, result))
                # measured after the put: the peak reflects queued
                # chunks only, so it never exceeds the documented
                # `depth` bound even while the put above is blocking
                stats.write_queue_peak = max(
                    stats.write_queue_peak, wq.qsize()
                )
                if self.boundary is not None:
                    self.boundary()
        finally:
            # Clean drain, even when the try-body raised: the writer
            # finishes every queued chunk (or skips the rest after its
            # own error), and in-flight prefetches are awaited so no
            # stage thread outlives the tick. The sentinel put cannot
            # deadlock on a full queue — the writer only exits on the
            # sentinel, so it keeps freeing slots until it sees it.
            wq.put(_DONE)
            wt.join()
            stats.write_seconds += write_seconds[0]
            for chunk, fut in pending:
                if fut.cancel():
                    continue
                try:
                    _, payload = fut.result()
                except BaseException:  # noqa: BLE001 — the primary error propagates
                    log.exception(
                        "draining in-flight prefetch after pipeline abort"
                    )
                    continue
                # a completed prefetch whose judgment never ran: let
                # the caller give the work back (released claims)
                if payload is not END and self.on_drained is not None:
                    try:
                        self.on_drained(chunk, payload)
                    except BaseException:  # noqa: BLE001 — the primary error propagates
                        log.exception(
                            "on_drained failed for an unjudged chunk"
                        )
        if write_errors:
            raise write_errors[0]
