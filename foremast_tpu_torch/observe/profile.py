"""Profiling hooks around the scoring loop: `torch.profiler` traces.

The port's counterpart of `foremast_tpu/observe/profile.py`, which wraps
`jax.profiler`. `trace_scoring` records a region with
`torch.profiler.profile` (CPU and CUDA activities, CPU alone when no card
is available) and writes a Chrome trace that Perfetto and
chrome://tracing load. The kernels of `ops/csrc/` launch through ctypes
on torch's current stream, and CUPTI records every launch of the
context, so they appear there under their `__global__` names beside the
judge's `record_function` markers (`judge.fit`, `judge.score`, ...).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os

_SEQ = itertools.count()


@dataclasses.dataclass
class ProfileTrace:
    """What `trace_scoring` yields: `path` is the Chrome trace it wrote,
    set when the region exits; None while it runs and when profiling is
    off."""

    path: str | None = None


@contextlib.contextmanager
def trace_scoring(out_dir: str | None = None, create_perfetto_link: bool = False):
    """Record the region under `torch.profiler` when `FOREMAST_PROFILE`
    (or an explicit `out_dir`) names a directory, and write its Chrome
    trace there on exit; a no-op otherwise. `create_perfetto_link` is
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
        yield handle
    path = os.path.join(target, f"foremast-{os.getpid()}-{next(_SEQ)}.trace.json")
    prof.export_chrome_trace(path)
    handle.path = path


def annotate(name: str):
    """Named sub-region: a `torch.profiler.record_function` marker on
    the trace timeline."""
    import torch

    return torch.profiler.record_function(name)
