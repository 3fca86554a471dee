"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), and a kernel's share of its roofline."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take (the larger of bytes over the
    memory rate and operations over the float32 peak) over the measured
    device time, in %."""
    least = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    return 100.0 * least / seconds
