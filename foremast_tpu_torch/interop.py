"""State carried across from the JAX package, as numpy arrays.

The "weights" of this system are its batches and its fitted forecaster
terminal state. The JAX side hands them over as numpy (`np.asarray` of
each leaf); these functions put them on a torch device, so a batch or a
fit-cache entry made by one engine is judged by the other. A whole JAX
`ModelCache.snapshot()` becomes the port's `ModelCache`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from foremast_tpu_torch.engine.scoring import ScoreBatch
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device

_WINDOWS = ("historical", "current", "baseline")
_ROWS = ("threshold", "bound", "min_lower_bound", "min_points")


def _tensor(x, dev: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A copy of numpy `x` on `dev` (device_get leaves are read-only)."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def score_batch_from_numpy(d: Mapping, device="cuda") -> ScoreBatch:
    """A JAX `ScoreBatch`'s leaves -> the port's `ScoreBatch`.

    `d` mirrors the dataclass: `d["historical"]`, `d["current"]` and
    `d["baseline"]` are mappings with numpy `values`, `mask` and `times`
    (times may be None), and `threshold`, `bound`, `min_lower_bound`,
    `min_points` are [B] numpy arrays — `dataclasses.asdict` of a JAX
    batch with every leaf passed through `np.asarray`."""
    dev = resolve_device(device)
    wins = {}
    for name in _WINDOWS:
        w = d[name]
        times = w.get("times")
        wins[name] = MetricWindows(
            values=_tensor(w["values"], dev, torch.float32),
            mask=_tensor(w["mask"], dev, torch.bool),
            times=None if times is None else _tensor(times, dev, torch.int32),
        )
    rows = {name: _tensor(d[name], dev) for name in _ROWS}
    return ScoreBatch(**wins, **rows)


def fit_entries_from_numpy(values) -> list[tuple]:
    """JAX fit-cache entries -> the port's: each a (level, trend, season,
    season_phase, scale, n_hist) tuple with numpy or Python leaves,
    returned as (float, float, f32 [m] array, int, float, int), the
    tuple `HealthJudge._fit_miss_rows` caches."""
    return [
        (
            float(level),
            float(trend),
            np.array(season, np.float32).reshape(-1),
            int(phase),
            float(scale),
            int(n_hist),
        )
        for level, trend, season, phase, scale, n_hist in values
    ]


def model_cache_from_snapshot(snapshot: Mapping, max_size: int | None = None) -> ModelCache:
    """A JAX `ModelCache.snapshot()` (keys -> terminal-state tuples with
    numpy arrays) -> the port's `ModelCache` with the same keys, in the
    same LRU order, and the same entries. A judge given it scores warm
    exactly as the JAX judge does from the original cache."""
    keys = list(snapshot)
    cache = ModelCache(max_size if max_size is not None else max(len(keys), 1))
    cache.put_many(zip(keys, fit_entries_from_numpy(snapshot[k] for k in keys)))
    return cache


def forecast_from_numpy(
    level, trend, season, season_phase, scale, n_hist, device="cuda"
) -> tuple[torch.Tensor, ...]:
    """A JAX fit-cache batch (forecaster terminal state as numpy: level,
    trend, scale [B] f32; season [B, m] f32; season_phase, n_hist [B]
    int) -> the tensors `scoring.score_from_state` takes, in its order."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    return (
        _tensor(np.asarray(level, np.float32), dev, f32),
        _tensor(np.asarray(trend, np.float32), dev, f32),
        _tensor(np.asarray(season, np.float32), dev, f32),
        _tensor(np.asarray(season_phase), dev, i32),
        _tensor(np.asarray(scale, np.float32), dev, f32),
        _tensor(np.asarray(n_hist), dev, i32),
    )
