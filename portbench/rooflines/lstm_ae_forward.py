"""Work of `lstm_ae_forward` (`ops/csrc/lstm_ae_forward.cu`): S models'
encoder-decoder LSTMs (F features, H hidden, G = 4H gates) over W windows
of T steps each, with the activations the backward needs when
`save_act`, or scoring one window of S (model, window) pairs gathered by
rows (`rows`). Each input is read once and each output written once:
the parameters, the windows (F floats, a mask byte) and the per-step
errors (a float), and the saved activations (6 H-vectors a step of the
encoder and the decoder). Operations: per step the gate products of
both LSTMs and the output layer, 2 per multiply-add."""


def work(s: int, w: int, t: int, f: int, h: int, save_act: bool = True, rows: bool = False):
    """(flops, bytes) of one call."""
    g = 4 * h
    param_bytes = s * 4 * (f * g + h * g + g + h * g + g + h * f + f)
    if rows:
        w = 1
    win_steps = s * w * t
    flops = win_steps * (2 * g * (f + h) + 2 * g * h + 2 * h * f)
    nbytes = param_bytes + win_steps * (4 * f + 1 + 4)
    if save_act:
        nbytes += s * w * 2 * t * 6 * h * 4
    return flops, nbytes
