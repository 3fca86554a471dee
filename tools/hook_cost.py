#!/usr/bin/env python3
"""Phase 6's worker ticks on one card, with and without phase 12's recorder hook.

    python3 tools/hook_cost.py [--order plain,hook,hook,plain]

Builds the kernels, makes phase 6's fleet (4,096 docs x 4 aliases) and
runs `chip_smoke.run_worker_ticks` on a single-device worker, once for
each entry of `--order`: `plain` with no hook (as phase 6 runs it),
`hook` with `chip_smoke.mesh_recorder`, the hook each worker of phase
12(a) gets (every verdict's bands kept as bytes, every columnar call
kept). Prints one JSON line a run: its tick seconds (cold, warm, spiked
warm, f32 cold of 1,024 docs) and the seconds the collector paused in
each; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="plain,hook,hook,plain")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("hook_cost: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.environ["FOREMAST_DEVICE_MESH"] = "off"
    os.environ["FOREMAST_SWEEP_SLICE_DOCS"] = "0"
    import chip_smoke as S
    from foremast_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"hook_cost: kernels built in {_build.build_all():.1f} s", flush=True)
    dev = torch.device("cuda")
    t_now = int(time.time())
    docs, data, latency = S.worker_fleet(S.WORKER_DOCS, t_now)
    for n, variant in enumerate(args.order.split(",")):
        rec = {}
        hook = S.mesh_recorder(rec) if variant == "hook" else None
        out = S.run_worker_ticks(dev, docs, data, latency, t_now, hook=hook)
        print(json.dumps(dict(
            n=n, variant=variant,
            seconds={k: round(out[k]["seconds"], 4) for k in "abcd"},
            gc_seconds={k: round(out[k]["gc_seconds"], 4) for k in "abcd"},
        )), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
