#!/usr/bin/env python3
"""Time `fit_many` (the LSTM-AE training loop) of two checkouts on one card.

    python3 tools/lstm_fit_ab.py --parent DIR [--repeats 3]

Three variants at phase 8(b)'s group shape (S=512 models, W=8 windows,
T=32, F=4, H=32, 60 Adam steps; windows from `chip_smoke.gen_joint_lstm`,
seed 21; parameters from `init_many` with seed 0):

  parent       the checkout at DIR as it is;
  kernel_only  this checkout, with Adam's bias corrections built as
               float32 device tensors every step, as DIR's
               `train_step_many` builds them;
  both         this checkout as it is.

Each variant runs in its own process (two checkouts' kernel libraries
cannot share one), in the order parent, kernel_only, both, both,
kernel_only, parent, so a drift of the card shows as a spread. A
process warms up with a 2-step fit, then times `repeats` 60-step fits
on the host clock around a device sync. Prints one line a process and,
last, the card's name and power limit and a JSON object of each
variant's times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "kernel_only", "both", "both", "kernel_only", "parent")


def _windows():
    """x [512, 8, 32, 4] f32 from chip_smoke's quality generator."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hist, _, _ = smoke.gen_joint_lstm(smoke.JOINT_GROUP, 4, smoke.JOINT_TH, smoke.FULL_TC, seed=21)
    return smoke.lstm_windows(hist, 32, 8), smoke.LSTM_STEPS


def worker(variant: str, tree: str, repeats: int) -> None:
    x_np, steps = _windows()
    sys.path.insert(0, tree)
    import torch

    from foremast_tpu_torch.models import lstm_ae as ae

    mod_tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(ae.__file__))))
    if os.path.realpath(mod_tree) != os.path.realpath(tree):
        raise SystemExit(f"imported {mod_tree}, want {tree}")
    dev = torch.device("cuda")
    if variant == "kernel_only":
        def device_corrections(count):
            b1, b2 = (torch.tensor(b, dtype=torch.float32, device=dev) for b in (ae._B1, ae._B2))
            return 1.0 - b1**count, 1.0 - b2**count

        ae.bias_corrections = device_corrections
    x = torch.from_numpy(x_np).to(dev)
    mask = torch.ones(x.shape[:3], dtype=torch.bool, device=dev)
    cfg = ae.LSTMAEConfig(features=x.shape[-1])
    ae.fit_many(torch.Generator().manual_seed(0), x, mask, cfg, steps=2)
    seconds, losses = [], None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, losses = ae.fit_many(torch.Generator().manual_seed(0), x, mask, cfg, steps=steps)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    curve = losses.mean(dim=1).cpu()
    print(json.dumps({"variant": variant, "tree": tree, "seconds": seconds, "steps": steps,
                      "loss_first": float(curve[0]), "loss_last": float(curve[-1])}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--worker", choices=("parent", "kernel_only", "both"), help=argparse.SUPPRESS)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.tree, args.repeats)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("lstm_fit_ab: needs a CUDA card and --parent", file=sys.stderr)
        return 1
    parent = os.path.abspath(args.parent)
    runs = {}
    for variant in ORDER:
        tree = parent if variant == "parent" else ROOT
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", variant, "--tree", tree,
             "--repeats", str(args.repeats)],
            capture_output=True, text=True, timeout=900, cwd=tree,
        )
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line))
        runs.setdefault(variant, []).extend(line["seconds"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({v: {"median_s": statistics.median(s), "seconds": s} for v, s in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
