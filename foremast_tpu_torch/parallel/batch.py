"""Synthetic fixed-shape scoring batches for throughput runs."""

from __future__ import annotations

import numpy as np
import torch

from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device


def throughput_batch(
    n_windows: int,
    hist_len: int,
    cur_len: int,
    seed: int = 0,
    device="cuda",
) -> scoring.ScoreBatch:
    """The JAX package's synthetic benchmark batch (same seeded numpy
    data: 0.5 +- 0.05 noise, full masks, threshold 5, upper bound, with
    a baseline), built on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    hv = (0.5 + 0.05 * rng.standard_normal((n_windows, hist_len))).astype(np.float32)
    cv = (0.5 + 0.05 * rng.standard_normal((n_windows, cur_len))).astype(np.float32)
    bv = (0.5 + 0.05 * rng.standard_normal((n_windows, cur_len))).astype(np.float32)
    t0 = 1_700_000_000
    ht = t0 + 60 * torch.arange(hist_len, dtype=torch.int32, device=dev)
    ct = t0 + 60 * torch.arange(cur_len, dtype=torch.int32, device=dev)

    def win(v: np.ndarray, t: torch.Tensor) -> MetricWindows:
        return MetricWindows(
            values=torch.from_numpy(v).to(dev),
            mask=torch.ones(v.shape, dtype=torch.bool, device=dev),
            times=t.expand(v.shape).contiguous(),
        )

    def full(value, dtype) -> torch.Tensor:
        return torch.full((n_windows,), value, dtype=dtype, device=dev)

    return scoring.ScoreBatch(
        historical=win(hv, ht),
        current=win(cv, ct),
        baseline=win(bv, ct),
        threshold=full(5.0, torch.float32),
        bound=full(1, torch.int32),
        min_lower_bound=full(0.0, torch.float32),
        min_points=full(10, torch.int32),
    )
