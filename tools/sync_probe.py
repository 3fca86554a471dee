#!/usr/bin/env python3
"""Which torch idioms synchronize the host with the card.

    python3 tools/sync_probe.py

Runs each idiom of the list below once on CUDA tensors under
`torch.cuda.set_sync_debug_mode("error")`, the mode in which PyTorch
raises on every call that makes the host wait for the card, and prints
one JSON object: for each idiom, "sync" (the mode raised), "none" (it ran
through) or "error: ..." (it failed for another reason, as `.numpy()` of
a card tensor does). Then the card's name and power limit. The sinks of
the port's device-flow rule (`foremast_tpu_torch/analysis/device_flow.py`)
are the idioms this probe reports as "sync" or as an error.
"""

from __future__ import annotations

import json
import subprocess
import sys


def idioms(torch, np):
    """name -> a function of (t, mask, idx) on the card: t float32 [64, 8],
    mask a bool tensor like it, idx int64 [16]."""
    host = np.arange(16, dtype=np.float32)

    def loop(t):
        for _row in t:
            pass

    return {
        ".item()": lambda t, m, i: t[0, 0].item(),
        ".tolist()": lambda t, m, i: t[0].tolist(),
        ".cpu()": lambda t, m, i: t.cpu(),
        ".numpy()": lambda t, m, i: t.numpy(),
        '.to("cpu")': lambda t, m, i: t.to("cpu"),
        '.to("cpu", non_blocking=True)': lambda t, m, i: t.to("cpu", non_blocking=True),
        "float(t)": lambda t, m, i: float(t[0, 0]),
        "int(t)": lambda t, m, i: int(i[0]),
        "bool(t)": lambda t, m, i: bool(m[0, 0]),
        "if t": lambda t, m, i: 1 if m.any() else 0,
        "np.asarray(t)": lambda t, m, i: np.asarray(t),
        "for row in t": lambda t, m, i: loop(t),
        "list(t)": lambda t, m, i: list(t),
        "sum(t) (Python)": lambda t, m, i: sum(t),
        "sorted(t)": lambda t, m, i: sorted(t[:, 0]),
        "t[k] (int index)": lambda t, m, i: t[3],
        "t[idx] (int tensor index)": lambda t, m, i: t[i],
        "t[mask] (bool mask index)": lambda t, m, i: t[m],
        "t[mask] = 0 (bool mask store)": lambda t, m, i: t.clone().__setitem__(m, 0.0),
        "t[t > 0] (comparison index)": lambda t, m, i: t[t > 0],
        "torch.where(t, a, b)": lambda t, m, i: torch.where(m, t, 0.0),
        "torch.where(cond)": lambda t, m, i: torch.where(m),
        "t.nonzero()": lambda t, m, i: m.nonzero(),
        "torch.argwhere": lambda t, m, i: torch.argwhere(m),
        "torch.masked_select": lambda t, m, i: torch.masked_select(t, m),
        "torch.unique": lambda t, m, i: torch.unique(i),
        "repeat_interleave(tensor repeats)": lambda t, m, i: torch.repeat_interleave(i, i.clamp(0, 2)),
        "repeat_interleave(int repeats)": lambda t, m, i: torch.repeat_interleave(i, 2),
        "repeat_interleave(output_size=)": lambda t, m, i: torch.repeat_interleave(
            i, torch.full_like(i, 2), output_size=2 * i.shape[0]),
        "torch.equal": lambda t, m, i: torch.equal(t, t),
        "torch.allclose": lambda t, m, i: torch.allclose(t, t),
        "t.any() (tensor)": lambda t, m, i: m.any(),
        "t.max() (tensor)": lambda t, m, i: t.max(),
        "torch.cat": lambda t, m, i: torch.cat([t, t]),
        "index_select": lambda t, m, i: t.index_select(0, i),
        "torch.tensor(host, device=cuda)": lambda t, m, i: torch.tensor(host, device=t.device),
        "torch.as_tensor(host, device=cuda)": lambda t, m, i: torch.as_tensor(host, device=t.device),
        "torch.from_numpy(host).to(cuda)": lambda t, m, i: torch.from_numpy(host).to(t.device),
        "from_numpy(host).pin_memory().to(cuda, non_blocking=True)":
            lambda t, m, i: torch.from_numpy(host).pin_memory().to(t.device, non_blocking=True),
        "torch.zeros(n, device=cuda)": lambda t, m, i: torch.zeros(16, device=t.device),
        "torch.full(n, v, device=cuda)": lambda t, m, i: torch.full((16,), 2.0, device=t.device),
        "torch.arange(n, device=cuda)": lambda t, m, i: torch.arange(16, device=t.device),
        "torch.linalg.cholesky": lambda t, m, i: torch.linalg.cholesky(_spd(torch, t)),
        "torch.linalg.cholesky_ex": lambda t, m, i: torch.linalg.cholesky_ex(_spd(torch, t)),
        "torch.linalg.inv": lambda t, m, i: torch.linalg.inv(_spd(torch, t)),
        "torch.linalg.inv_ex": lambda t, m, i: torch.linalg.inv_ex(_spd(torch, t)),
        "torch.linalg.solve": lambda t, m, i: torch.linalg.solve(_spd(torch, t), t[:8, :1]),
        "torch.linalg.slogdet": lambda t, m, i: torch.linalg.slogdet(_spd(torch, t)),
        "torch.cholesky_solve": lambda t, m, i: torch.cholesky_solve(t[:8, :1], _spd(torch, t)),
        "torch.linalg.solve_triangular": lambda t, m, i: torch.linalg.solve_triangular(
            _spd(torch, t), t[:8, :1], upper=False),
        "torch.linalg.eigh": lambda t, m, i: torch.linalg.eigh(_spd(torch, t)),
        "torch.special.gammaincc": lambda t, m, i: torch.special.gammaincc(t.abs() + 1, t.abs()),
        "t.sort()": lambda t, m, i: t.sort(dim=1),
        "torch.topk": lambda t, m, i: torch.topk(t, 2, dim=1),
        "torch.bincount": lambda t, m, i: torch.bincount(i),
        "torch.multinomial": lambda t, m, i: torch.multinomial(t.abs() + 0.1, 1),
        "event.query()": lambda t, m, i: _event(torch).query(),
        "t.nan_to_num()": lambda t, m, i: t.nan_to_num(),
        "t.clamp(min=tensor)": lambda t, m, i: t.clamp(min=t[:1]),
    }


def _spd(torch, t):
    a = t[:8, :8]
    return a @ a.T + 8 * torch.eye(8, device=t.device)


def _event(torch):
    e = torch.cuda.Event()
    e.record()
    return e


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sync_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn((64, 8), device="cuda", generator=g)
    m = t > 0
    i = torch.randint(0, 64, (16,), device="cuda", generator=g)
    torch.cuda.synchronize()
    out = {}
    for name, f in idioms(torch, np).items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            f(t, m, i)
            out[name] = "none"
        except RuntimeError as e:
            text = str(e)
            out[name] = "sync" if "synchroniz" in text else f"error: {text.splitlines()[0][:120]}"
        except Exception as e:  # a TypeError of .numpy() on a card tensor, say
            out[name] = f"error: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "idioms": out}, indent=1))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
