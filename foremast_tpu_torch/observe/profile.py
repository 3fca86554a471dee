"""Profiling hooks around the scoring loop: `torch.profiler` traces.

The port's counterpart of `foremast_tpu/observe/profile.py`, which wraps
`jax.profiler`. `trace_scoring` records a region with
`torch.profiler.profile` (CPU and CUDA activities, CPU alone when no card
is available) and writes a Chrome trace that Perfetto and
chrome://tracing load. The kernels of `ops/csrc/` launch through ctypes
on torch's current stream, and CUPTI records every launch of the
context, so they appear there under their `__global__` names beside the
judge's `record_function` markers (`judge.fit`, `judge.score`, ...).

Given the worker's `observe.spans.Tracer`, the trace also holds every
span that finished inside the region, on every thread: one `X` event
each (category `foremast`) on its thread's row, placed on the trace's
clock by a `record_function` marker (`CLOCK_MARK`) put down at the
region's start. The profiler records markers on the thread that started
it alone; the spans show what the worker's other threads were doing
while the card sat idle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time

_SEQ = itertools.count()

CLOCK_MARK = "foremast.clock"


@dataclasses.dataclass
class ProfileTrace:
    """What `trace_scoring` yields: `path` is the Chrome trace it wrote,
    set when the region exits; None while it runs and when profiling is
    off."""

    path: str | None = None


@contextlib.contextmanager
def trace_scoring(out_dir: str | None = None, create_perfetto_link: bool = False, tracer=None):
    """Record the region under `torch.profiler` when `FOREMAST_PROFILE`
    (or an explicit `out_dir`) names a directory, and write its Chrome
    trace there on exit; a no-op otherwise. With `tracer`, the spans it
    finishes inside the region join the trace. `create_perfetto_link` is
    accepted for the JAX signature and ignored: torch has no Perfetto
    upload."""
    del create_perfetto_link
    handle = ProfileTrace()
    target = out_dir or os.environ.get("FOREMAST_PROFILE")
    if not target:
        yield handle
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        # the clock marker twice: a process's first record_function
        # stamps its event up to a millisecond before it returns; the
        # second is stamped between the two host reads around its entry
        for _ in range(2):
            before = time.perf_counter()
            with torch.profiler.record_function(CLOCK_MARK):
                mark = (before + time.perf_counter()) / 2
        with tracer.capture() if tracer is not None else contextlib.nullcontext([]) as spans:
            yield handle
    path = os.path.join(target, f"foremast-{os.getpid()}-{next(_SEQ)}.trace.json")
    prof.export_chrome_trace(path)
    if spans:
        _add_spans(path, mark, spans)
    handle.path = path


def _add_spans(path: str, mark: float, spans) -> int:
    """Add `spans` (`observe.spans.Span`, finished) to the Chrome trace at
    `path` as `X` events on their threads' rows. `mark` is the host's
    `perf_counter` at the start of the trace's last `CLOCK_MARK` event,
    which fixes the offset between the two clocks. Returns the events
    added (none when the trace lacks the marker)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    marks = [e for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"]
    if not marks:
        return 0
    last = max(marks, key=lambda e: float(e["ts"]))
    offset = float(last["ts"]) - mark * 1e6
    pid = last.get("pid", os.getpid())
    for s in spans:
        args = {"trace_id": s.trace_id, "span_id": s.span_id, "parent_id": s.parent_id}
        if s.stage:
            args["stage"] = s.stage
        args.update(s.attrs)
        events.append({
            "ph": "X", "cat": "foremast", "name": s.name, "pid": pid, "tid": s.tid,
            "ts": s._t0 * 1e6 + offset, "dur": s.duration * 1e6, "args": args,
        })
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, default=str)
    os.replace(tmp, path)
    return len(spans)


def annotate(name: str):
    """Named sub-region: a `torch.profiler.record_function` marker on
    the trace timeline."""
    import torch

    return torch.profiler.record_function(name)
