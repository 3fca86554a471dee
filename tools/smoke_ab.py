#!/usr/bin/env python3
"""Run one `chip_smoke.py` mode in two checkouts on one card, in turn.

    python3 tools/smoke_ab.py --parent DIR [--order parent,this,this,parent] -- --deployable-only
    python3 tools/smoke_ab.py --parent DIR --worker-paths

Each run is `python3 chip_smoke.py <args>` from the root of its checkout
(`this` is the checkout holding this script), one process after the
other, so a drift of the card or its host shows as a spread between the
runs of one variant. With `--worker-paths` a run instead builds the
kernels and runs only phases 5 and 6 (the single-device fit-cache judge
and worker fleet), through that checkout's own `chip_smoke` functions,
so two checkouts' smokes need no common flag. Each run's output goes to
`chiprun_out/smoke_ab_<n>_<variant>.log`. From each log the script reads
the wall clock of the run, the seconds of each tick of phases 5 and 6
(`p5a` ... `p6d`: their (a) to (d) lines), and the seconds that phase 9
prints for its parts:

  encode      the fake Prometheus encoding its answers (set-up, host only);
  pack_native phase 9(c)'s native packing of one cold chunk (host only);
  <arm> pass  each in-process pass of 9(b) (pull cold, warm, spiked warm;
              push cold, ...), the sum of its ticks;
  cli_*       9(d)'s CLI runs: the pulled judge and its restart, the
              pushed judge and its restart, from start.

The two host-only parts run code that neither checkout changes, so they
read the host's speed in that run. Prints one JSON line a run and, last,
the card's name and power limit and a JSON object of each variant's
values by run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = (
    ("encode", re.compile(r"^phase 9: cut from .* encoded in ([\d.]+) s")),
    ("pack_native", re.compile(r"^phase 9: \(c\) one cold chunk .* after \(native, into a pinned buffer\): ([\d.]+) s")),
    ("cli_pull", re.compile(r"^phase 9: \(d\) python3 -m .* judged the \d+ docs in ([\d.]+) s from start")),
    ("cli_pull_restart", re.compile(r"^phase 9: \(d\) python3 -m .* judged the reset fleet in ([\d.]+) s")),
    ("cli_push", re.compile(r"^phase 9: \(d\) with FOREMAST_INGEST=1: .* judged the fleet in ([\d.]+) s from start")),
    ("cli_push_restart", re.compile(r"^phase 9: \(d\) with FOREMAST_INGEST=1: .* judged the reset fleet in ([\d.]+) s")),
)
PASS = re.compile(r"^phase 9: \(b\) (.+) pass: \d+ ticks, ([\d.]+) s")
TICK = re.compile(r"^phase ([56]): \(([a-d])\) .*: ([\d.]+) s = [\d.]+ (?:windows|docs)/s")
WORKER_PATHS = """
import os, subprocess, sys, torch
sys.path.insert(0, os.getcwd())
os.environ["FOREMAST_DEVICE_MESH"] = "off"
import chip_smoke as S
from foremast_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
name = torch.cuda.get_device_name(0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60, check=True).stdout.strip()
peak = S.PEAK_BYTES[next((k for k in S.PEAK_BYTES if k in name), "HBM3")]
print(f"phase 1: kernels built in {_build.build_all():.1f} s")
fit_cache = S.phase_fit_cache(dev, peak)
S.phase_worker(dev, smi, fit_cache["seconds"]["c"])
"""


def read_parts(log: str) -> dict:
    out = {}
    for line in log.splitlines():
        m = PASS.match(line)
        if m:
            out[f"{m.group(1)} pass"] = float(m.group(2))
            continue
        m = TICK.match(line)
        if m:
            out[f"p{m.group(1)}{m.group(2)}"] = float(m.group(3))
            continue
        for name, rx in PARTS:
            m = rx.match(line)
            if m:
                out[name] = float(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the other checkout")
    ap.add_argument("--order", default="parent,this,this,parent")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a run may take")
    ap.add_argument("--worker-paths", action="store_true", help="run only phases 5 and 6 in each checkout")
    ap.add_argument("smoke_args", nargs="*", help="arguments of chip_smoke.py")
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent), "this": THIS}
    out_dir = os.path.join(THIS, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for n, variant in enumerate(args.order.split(",")):
        t0 = time.perf_counter()
        cmd = ["-c", WORKER_PATHS] if args.worker_paths else ["chip_smoke.py", *args.smoke_args]
        proc = subprocess.run([sys.executable, *cmd], cwd=roots[variant],
                              capture_output=True, text=True, timeout=args.timeout)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        with open(os.path.join(out_dir, f"smoke_ab_{n}_{variant}.log"), "w") as fh:
            fh.write(log)
        run = dict(n=n, variant=variant, rc=proc.returncode, seconds=seconds, parts=read_parts(proc.stdout))
        print(json.dumps(run), flush=True)
        runs.append(run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for variant in roots:
        mine = [r for r in runs if r["variant"] == variant]
        if not mine:
            continue
        keys = sorted({k for r in mine for k in r["parts"]})
        summary[variant] = dict(rc=[r["rc"] for r in mine], seconds=[r["seconds"] for r in mine],
                                **{k: [r["parts"].get(k) for r in mine] for k in keys})
    print(json.dumps(summary))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
