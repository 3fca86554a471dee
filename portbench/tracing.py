"""What a traced run reads: the program's own spans, the device's
activity from `torch.profiler`, and the record of the card.

The spans come from the worker's `observe.spans.Tracer`, subclassed here
to keep every finished span (name, stage, trace id, start, end, root?)
on the host's clock. The device's activity comes from a Chrome trace of
a bounded stretch of sweeps: its kernel, copy and set events are the
device's busy intervals. Two `record_function` markers, put down at
known host-clock instants, place the spans on the trace's clock, so each
idle gap of the device is named by the spans the host was inside.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.clock"
TOP = 10


def recording_tracer():
    """A `Tracer` that also keeps every finished span in `.spans`."""
    from foremast_tpu_torch.observe.spans import Tracer

    class RecordingTracer(Tracer):
        def __init__(self):
            super().__init__(service="portbench")
            self.spans: list = []

        def _finish(self, s, root: bool) -> None:
            self.spans.append((s.name, s.stage, s.trace_id, s._t0, s._t0 + s.duration, root))
            super()._finish(s, root)

    return RecordingTracer()


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of `intervals` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


@dataclasses.dataclass
class DeviceStretch:
    """The device's activity over the profiled stretch (seconds)."""

    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds]] the longest in total
    idle_gaps: list  # [[what the host was doing, seconds]] the longest in total


class Profiled:
    """Records sweeps under `torch.profiler` (CPU and CUDA activities)
    between `start()` and `stop()`; `read(spans)` reduces the trace."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.marks: list = []  # host perf_counter of the markers
        self.t0 = self.t1 = 0.0

    def _mark(self) -> None:
        with self.torch.profiler.record_function(MARK):
            self.marks.append(time.perf_counter())

    def start(self) -> None:
        tp = self.torch.profiler
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self._mark()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self._mark()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return data["traceEvents"] if isinstance(data, dict) else data

    def read(self, spans) -> DeviceStretch | None:
        """The stretch's busy and idle time, its longest device
        operations and its idle gaps by host activity; None when the
        trace holds no device event."""
        events = [e for e in self.events() if e.get("ph") == "X"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        marks = sorted(float(e["ts"]) for e in events if e.get("name") == MARK)
        if not dev or len(marks) < 2:
            return None
        # host perf_counter seconds -> trace microseconds
        offset = marks[0] - self.marks[0] * 1e6
        lo, hi = self.t0 * 1e6 + offset, self.t1 * 1e6 + offset
        busy = union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
        busy_us = covered(busy, lo, hi)
        by_name: dict = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, min(a, hi)))
            prev = max(prev, b)
        if prev < hi:
            gaps.append((prev, hi))
        spans_us = [(name, stage, t0 * 1e6 + offset, t1 * 1e6 + offset, root)
                    for name, stage, _tid, t0, t1, root in spans]
        by_host: dict = {}
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [s for s in spans_us if s[2] <= mid < s[3]]
            stages = sorted({s[1] for s in inside if s[1]})
            if stages:
                label = "+".join(stages)
            elif inside:
                label = "worker.tick outside every stage span"
            else:
                label = "between sweeps (the harness)"
            by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return DeviceStretch(
            window_s=(hi - lo) * 1e-6,
            busy_s=busy_us * 1e-6,
            device_ops=[[k, v] for k, v in top],
            idle_gaps=[[k, v] for k, v in idle],
        )


def power_limit_w() -> float | None:
    """The card's power limit in W, read by nvidia-smi (None when it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
