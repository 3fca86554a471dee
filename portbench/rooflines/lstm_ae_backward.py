"""Work of `lstm_ae_backward` (`ops/csrc/lstm_ae_backward.cu`, the chain
kernel and the product kernel together) at the shape of the forward it
differentiates: it reads half the parameters' bytes (the recurrent
weights the chain needs), the windows, the per-step error gradients and
the saved activations, and writes every parameter's gradient; twice the
forward's operations."""


def work(s: int, w: int, t: int, f: int, h: int):
    """(flops, bytes) of one call (chain + products)."""
    g = 4 * h
    param_bytes = s * 4 * (f * g + h * g + g + h * g + g + h * f + f)
    win_steps = s * w * t
    fwd_flops = win_steps * (2 * g * (f + h) + 2 * g * h + 2 * h * f)
    act_bytes = s * w * 2 * t * 6 * h * 4
    return 2 * fwd_flops, param_bytes // 2 + win_steps * (4 * f + 1 + 4) + act_bytes + param_bytes
