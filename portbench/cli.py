"""The harness's command line: one run of one cell, its result line.

Exit codes: 0 with a result line (whether or not `correct`); 2 when the
card or the cell is missing; 3 when the run loaded JAX, the JAX package
or its benchmarks. Neither of the last two prints a result.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from portbench import check, spec, window


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window (default: run_seconds)")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # rehearsal only: the CPU tests run a cell at a tiny size without a card
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--services", type=int, default=None, help=argparse.SUPPRESS)
    # the control of `correct` (no worker runs): the reference one precision step lower
    p.add_argument("--control-sweeps", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, root: str, started: float) -> int:
    args = parse(argv)
    try:
        cell = spec.cell(root, args.workload)
    except spec.SpecError as e:
        _log(f"portbench: {e}")
        return 2
    chips = next(w["chips"] for w in spec.benchmark(root)["workloads"] if w["name"] == args.workload)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            _log("portbench: no CUDA device; this benchmark measures the card and does not fall back")
            return 2
        if torch.cuda.device_count() < chips:
            _log(f"portbench: {args.workload} needs {chips} cards, {torch.cuda.device_count()} visible")
            return 2
    if args.control_sweeps:
        # judged by the run's own comparison: `correct` has to come out false
        numbers = window.control(cell, args.seed, args.control_sweeps, args.device, args.services)
        correct, shown = check.verdict(numbers, cell.config["checks"])
        for name, c in shown.items():
            _log(f"control {name} {c['value']!r} limit {c['limit']!r}")
        print(json.dumps({"correct": correct, "control": numbers, "checks": shown}), flush=True)
        return 0
    seconds = float(args.seconds if args.seconds is not None else cell.run_seconds)
    res = window.run(cell, args.seed, seconds, bool(args.trace), args.device, _log, args.services, started)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"windows_per_s": res["windows"] / res["window_s"], "setup_s": res["setup_s"]}
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu", "count": chips,
              "memory_peak_bytes": int(res["peak"])}
    if args.device == "cuda":
        from portbench.tracing import power_limit_w

        device["kind"] = torch.cuda.get_device_name(0)
        device["power_limit_w"] = power_limit_w()
    else:
        device["kind"] = "cpu (rehearsal)"
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    stretch = res["device_stretch"]
    if args.trace and stretch is not None:
        device["busy_s"] = stretch.busy_s
        device["window_s"] = stretch.window_s
        out["breakdown"] = {"device_ops": stretch.device_ops, "idle_gaps": stretch.idle_gaps}
    out["checks"] = res["shown"]

    bad = window.forbidden_modules()
    if bad:
        _log(f"portbench: the run loaded {', '.join(bad)}; the port's benchmark may load none of them")
        return 3
    for name, c in res["shown"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
