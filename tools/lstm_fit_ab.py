#!/usr/bin/env python3
"""Time the LSTM-AE forward and the training loop around it, two checkouts on one card.

    python3 tools/lstm_fit_ab.py --parent DIR [--repeats 2]

At phase 8(b)'s group shape (S=512 models, W=8 windows, T=32, F=4, H=32;
windows from `chip_smoke.gen_joint_lstm`, seed 21; parameters from
`init_many` with seed 0) each process times

  train_fwd   the training forward, activations saved (W=8);
  train_bwd   the backward on those activations (grad_err 1 / valid steps);
  score_fwd   the warm path's scoring forward: each model's first window
              (W=1) through a `rows` gather in reversed order;
  train_step  one `train_step_many` (both kernels, autograd glue, Adam);
  fit_many    `repeats` 60-step fits, host clock around a device sync;

the first four as device time (`chip_smoke.queued_ms`: CUDA events, the
calls queued behind a busy kernel), and reports the forward's ptxas
lines from its own build. Each checkout runs in its own process (two
checkouts' kernel libraries cannot share one), in the order parent,
this, this, parent, twice, so a drift of the card shows as a spread.
Prints one JSON line a process and, last,
the card's name and power limit and a JSON object of each variant's
medians, minima and maxima over its processes.
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
ORDER = ("parent", "this", "this", "parent") * 2
METRICS = ("train_fwd_ms", "train_bwd_ms", "score_fwd_ms", "train_step_ms", "fit_many_s")


def _windows():
    """x [512, 8, 32, 4] f32 from chip_smoke's quality generator, the step
    count and chip_smoke's `queued_ms` (this checkout's, for both variants)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hist, _, _ = smoke.gen_joint_lstm(smoke.JOINT_GROUP, 4, smoke.JOINT_TH, smoke.FULL_TC, seed=21)
    return smoke.lstm_windows(hist, 32, 8), smoke.LSTM_STEPS, smoke.queued_ms


def worker(variant: str, tree: str, repeats: int) -> None:
    x_np, steps, queued_ms = _windows()
    sys.path.insert(0, tree)
    import torch

    from foremast_tpu_torch.models import lstm_ae as ae
    from foremast_tpu_torch.ops import _build
    from foremast_tpu_torch.ops import kernels as K

    mod_tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(ae.__file__))))
    if os.path.realpath(mod_tree) != os.path.realpath(tree):
        raise SystemExit(f"imported {mod_tree}, want {tree}")
    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    mask = torch.ones(x.shape[:3], dtype=torch.bool, device=dev)
    cfg = ae.LSTMAEConfig(features=x.shape[-1])
    params = ae.init_many(torch.Generator().manual_seed(0), x.shape[0], cfg, device=dev)
    leaves = ae.leaves(params)
    rows = torch.arange(x.shape[0], device=dev).flip(0)
    xs, ms = x[:, :1].contiguous(), mask[:, :1].contiguous()
    _, act = K.lstm_ae_forward(leaves, x, mask, save_act=True)
    n = mask.sum(dim=(1, 2)).float().clamp_min(1.0)
    grad_err = (1.0 / n)[:, None, None].expand(*mask.shape).contiguous()
    out = {
        "variant": variant,
        "tree": tree,
        "train_fwd_ms": queued_ms(lambda: K.lstm_ae_forward(leaves, x, mask, save_act=True), iters=10),
        "train_bwd_ms": queued_ms(lambda: K.lstm_ae_backward(leaves, x, mask, act, grad_err), iters=10),
        "score_fwd_ms": queued_ms(lambda: K.lstm_ae_forward(leaves, xs, ms, rows=rows), iters=20),
        "train_step_ms": queued_ms(lambda: ae.train_step_many(params, ae.adam_init(params), x, mask, cfg),
                                   iters=3, repeats=3),
    }
    ae.fit_many(torch.Generator().manual_seed(0), x, mask, cfg, steps=2)
    seconds = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ae.fit_many(torch.Generator().manual_seed(0), x, mask, cfg, steps=steps)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    out["fit_many_s"] = statistics.median(seconds)
    out["ptxas"] = [line.strip() for line in _build.build_log("lstm_ae_forward").splitlines()
                    if "Compiling entry function" in line or "registers" in line or "spill" in line]
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--worker", choices=("parent", "this"), help=argparse.SUPPRESS)
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
    runs: dict = {}
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
        for m in METRICS:
            runs.setdefault(variant, {}).setdefault(m, []).append(line[m])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({v: {m: {"median": statistics.median(s), "min": min(s), "max": max(s), "values": s}
                          for m, s in ms.items()} for v, ms in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
