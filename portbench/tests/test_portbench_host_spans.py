"""The readers of the worker's host spans (`metrics/admit_ms_per_kwin.py`,
`pack_ms_per_kwin`, `gc_ms_per_kwin`, `device_wait_ms_per_kwin`,
`judge_stall_ms_per_kwin`) in a traced run of each cell at a tiny size on
the CPU, and what they read from a context without the spans."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
HOST = ["admit_ms_per_kwin", "pack_ms_per_kwin", "gc_ms_per_kwin", "device_wait_ms_per_kwin",
        "judge_stall_ms_per_kwin"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_host_spans(workload):
    """The command's traced run, with the collector's thresholds lowered
    so that a rehearsal's few sweeps hold collections of generation 1
    and 2 (at full size every sweep does)."""
    code = f"""
import gc, json, sys
sys.path.insert(0, {ROOT!r})
gc.set_threshold(100, 2, 2)
from portbench import cli
sys.exit(cli.main(["--workload", {workload!r}, "--seed", "{2**31 + 23}", "--seconds", "2", "--trace", "1",
                   "--device", "cpu", "--services", "{TINY}"], {ROOT!r}, 0.0))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    for name in HOST:
        assert name in res["metrics"], name
        assert res["metrics"][name]["unit"] == "ms" and res["metrics"][name]["value"] > 0, name


def test_readers_without_roots_and_without_spans_of_their_kind():
    from portbench import spec
    from portbench.window import ReadContext

    def ctx(spans):
        return ReadContext(spans=spans, windows=2000, newcomer_windows=0, device=None, sweeps=1, latency=[])

    tick = ("worker.tick", None, "t1", 0.0, 1.0, True)
    for name in HOST:
        read = spec.metric_reader(name)
        assert read(ctx([])) is None, name  # no root
        # roots, but no span of its kind: 0.0, except that no collection
        # is no pause to read
        assert read(ctx([tick])) == (None if name == "gc_ms_per_kwin" else 0.0), name
    spans = [tick, ("worker.admit", "admit", "t1", 0.1, 0.3, False), ("gc.collect", "gc", "t1", 0.2, 0.25, False),
             ("pipeline.judge_stall", None, "t1", 0.5, 0.6, False), ("judge.pack", "pack", "t1", 0.6, 0.62, False),
             ("judge.device_wait", "device_wait", "t1", 0.7, 0.71, False)]
    got = {name: spec.metric_reader(name)(ctx(spans)) for name in HOST}
    want = {"admit_ms_per_kwin": 100.0, "gc_ms_per_kwin": 25.0, "judge_stall_ms_per_kwin": 50.0,
            "pack_ms_per_kwin": 10.0, "device_wait_ms_per_kwin": 5.0}
    assert got == pytest.approx(want)
