"""verdict_p95_s.ma (s): the 95th percentile (nearest rank) of the
seconds from a newcomer's landing in the store to its first verdict
written, over the newcomers of the window's unprofiled sweeps: how long
a rollout of the moving-average fleet waits to be judged. Newcomers are
claimed after the documents already open, so this is close to a whole
sweep; its spread from run to run is too wide for an end-to-end bound."""

from portbench.window import quantile


def read(ctx):
    return quantile(ctx.latency, 0.95) if ctx.latency else None
