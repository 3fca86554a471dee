"""judge_ms_per_kwin (ms): the seconds of the judge's spans (fit,
arena_assemble, score, decode) per 1,000 windows judged in the window.
`score` around an asynchronous dispatch times the enqueue; `decode`
includes the wait for the device's results."""

STAGES = ("fit", "arena_assemble", "score", "decode")


def read(ctx):
    secs = [t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage in STAGES]
    if not secs or ctx.windows <= 0:
        return None
    return 1e3 * sum(secs) / (ctx.windows / 1e3)
