"""Fixed-shape masked metric-window container on torch tensors.

Ragged per-job series become a dense `[batch, T]` tensor plus a validity
mask, time axis last, as in `foremast_tpu/ops/windows.py`. Every
downstream op (forecasters, rank tests, bounds, kernels) respects the
mask, so padding values never reach a result.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def to_device(x: np.ndarray | torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on `dev` without
    synchronizing the stream: staged through pinned memory and copied
    asynchronously (a blocking copy from pageable memory waits for the
    stream to drain first). On the CPU, a copy that does not alias `x`."""
    t = x.contiguous() if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cpu":
        return t.clone()
    return t.pin_memory().to(dev, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class MetricWindows:
    """A batch of fixed-length metric windows.

    values: [..., T] float32 — samples (padding arbitrary where invalid)
    mask:   [..., T] bool    — True where the sample is real
    times:  [..., T] int32   — unix seconds per sample (0 where invalid),
            or None when the caller needs no times on the device
    """

    values: torch.Tensor
    mask: torch.Tensor
    times: torch.Tensor | None

    @property
    def length(self) -> int:
        return self.values.shape[-1]

    def count(self) -> torch.Tensor:
        """Number of valid points per window, [...] int64."""
        return self.mask.sum(dim=-1)

    @staticmethod
    def from_ragged(
        series: Sequence[tuple[np.ndarray, np.ndarray]],
        length: int | None = None,
        device: str | torch.device = "cuda",
        device_times: bool = True,
    ) -> "MetricWindows":
        """Pack (times, values) ragged series into one padded batch.

        Rows are left-packed and truncated to `length`; the packing runs
        in numpy and the batch is copied to `device` once per array.
        `device_times=False` leaves times off the device (None): no
        scoring program reads them, anomaly timestamps are decoded on
        the host from each task's own ragged times."""
        dev = resolve_device(device)
        if length is None:
            length = max((len(v) for _, v in series), default=1)
            length = max(length, 1)
        b = len(series)
        values = np.zeros((b, length), dtype=np.float32)
        times = np.zeros((b, length), dtype=np.int32)
        mask = np.zeros((b, length), dtype=bool)
        for i, (t, v) in enumerate(series):
            n = min(len(v), length)
            values[i, :n] = np.asarray(v, dtype=np.float32)[:n]
            if device_times:
                times[i, :n] = np.asarray(t, dtype=np.int64)[:n].astype(np.int32)
            mask[i, :n] = True
        return MetricWindows(
            values=torch.from_numpy(values).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            times=torch.from_numpy(times).to(dev) if device_times else None,
        )


def masked_moments(
    values: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, mean, var) over the last axis in one pass of shifted moments.

    d = x - x[first valid index]: the shift point is a member of the
    sample, so E[d^2] - E[d]^2 stays well-conditioned, and padding in
    masked slots never reaches the sums (same algebra as the JAX
    package's `masked_moments`)."""
    m = mask.to(values.dtype)
    first_idx = mask.to(torch.uint8).argmax(dim=-1)  # 0 for all-invalid rows
    c = torch.gather(values, -1, first_idx[..., None])
    d = (values - c) * m
    n = m.sum(dim=-1)
    s1 = d.sum(dim=-1)
    s2 = (d * d).sum(dim=-1)
    nn = n.clamp_min(1.0)
    mean_d = s1 / nn
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    mean = torch.where(n > 0, c[..., 0] + mean_d, zero)
    var = torch.where(n > 0, (s2 / nn - mean_d * mean_d).clamp_min(0.0), zero)
    return n, mean, var


def masked_mean(
    values: torch.Tensor, mask: torch.Tensor, axis: int = -1
) -> torch.Tensor:
    """Mean over valid points; 0.0 where a window has no valid points."""
    m = mask.to(values.dtype)
    n = m.sum(dim=axis)
    s = (values * m).sum(dim=axis)
    return torch.where(n > 0, s / n.clamp_min(1.0), torch.zeros_like(s))


def masked_var(
    values: torch.Tensor, mask: torch.Tensor, axis: int = -1, ddof: int = 0
) -> torch.Tensor:
    """Variance over valid points (ddof degrees of freedom); 0.0 if too few."""
    m = mask.to(values.dtype)
    n = m.sum(dim=axis)
    mu = masked_mean(values, mask, axis=axis)
    d = (values - mu.unsqueeze(axis)) * m
    ss = (d * d).sum(dim=axis)
    denom = n - ddof
    return torch.where(denom > 0, ss / denom.clamp_min(1.0), torch.zeros_like(ss))


def masked_std(
    values: torch.Tensor, mask: torch.Tensor, axis: int = -1, ddof: int = 0
) -> torch.Tensor:
    return torch.sqrt(masked_var(values, mask, axis=axis, ddof=ddof))
