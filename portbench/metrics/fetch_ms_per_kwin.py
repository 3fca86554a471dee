"""fetch_ms_per_kwin (ms): the seconds of the worker's `metric_fetch`
spans per 1,000 windows judged in the window: the columnar path's fetch
of current and baseline windows (`_fetch_fast`) and the object path's
history and window fetches (`_fetch_chunk`)."""


def read(ctx):
    secs = [t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage == "metric_fetch"]
    if not secs or ctx.windows <= 0:
        return None
    return 1e3 * sum(secs) / (ctx.windows / 1e3)
