"""Bound computation and anomaly flagging.

The reference brain's threshold semantics: band = threshold * scale
around the prediction, lower bound floored at `min_lower_bound`, and a
bound selector (1 upper, 2 lower, 3 both) choosing which side flags
(`foremast-brain.yaml:26-73`). Thresholds, bounds and floors are scalars
or per-window `[B]` tensors gathered host-side from the metric-type table.
"""

from __future__ import annotations

import torch

from foremast_tpu_torch.config import BOUND_BOTH, BOUND_LOWER, BOUND_UPPER

__all__ = [
    "BOUND_BOTH",
    "BOUND_LOWER",
    "BOUND_UPPER",
    "compute_bounds",
    "detect_anomalies",
]


def _column(x, dtype, device) -> torch.Tensor:
    """Scalar or [B] operand -> broadcastable against [B, T]."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    return x[:, None] if x.ndim == 1 else x


def compute_bounds(
    pred: torch.Tensor,
    scale: torch.Tensor,
    threshold: torch.Tensor | float,
    min_lower_bound: torch.Tensor | float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(upper [B, T], lower [B, T]) around pred [B, T] with scale [B]."""
    thr = _column(threshold, pred.dtype, pred.device)
    mlb = _column(min_lower_bound, pred.dtype, pred.device)
    band = thr * scale[:, None]
    upper = pred + band
    lower = torch.maximum(pred - band, mlb.expand_as(pred))
    return upper, lower


def detect_anomalies(
    current: torch.Tensor,
    cur_mask: torch.Tensor,
    upper: torch.Tensor,
    lower: torch.Tensor,
    bound: torch.Tensor | int = BOUND_UPPER,
) -> torch.Tensor:
    """Flag current points outside the band per the bound selector;
    bool [B, T]."""
    bnd = _column(bound, torch.int32, current.device)
    use_upper = (bnd == BOUND_UPPER) | (bnd == BOUND_BOTH)
    use_lower = (bnd == BOUND_LOWER) | (bnd == BOUND_BOTH)
    over = current > upper
    under = current < lower
    return cur_mask & ((over & use_upper) | (under & use_lower))
