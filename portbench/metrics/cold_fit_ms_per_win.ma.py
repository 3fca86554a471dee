"""cold_fit_ms_per_win.ma (ms): the seconds of the judge's `fit` spans
per newcomer window (each newcomer's histories are fitted cold: packing,
upload, the moments, the copy back, the cache put), for the
moving-average fleet's rollouts."""


def read(ctx):
    secs = [t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage == "fit"]
    if not secs or ctx.newcomer_windows <= 0:
        return None
    return 1e3 * sum(secs) / ctx.newcomer_windows
