"""device_idle (%): 1 - (union of the device's kernel, copy and set
intervals) / the profiled stretch, from `torch.profiler`'s trace of the
first sweeps of the window."""


def read(ctx):
    dev = ctx.device
    if dev is None or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
