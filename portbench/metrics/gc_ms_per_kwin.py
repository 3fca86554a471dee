"""gc_ms_per_kwin (ms): the seconds of the collector's pauses of
generation 1 and 2 inside the worker's ticks (`gc.collect` spans, stage
`gc`) per 1,000 windows judged in the window. Young collections are
counted by the tracer, not spanned, so they are not in it. None without
a `worker.tick` root, from a program that opens no such span (it has no
`observe.spans.PORT_STAGES`), and when no collection of those
generations fell inside a root: a run that short (a rehearsal's few
sweeps) has no pause to read, and the harness's result line carries
span metrics only above 0."""

STAGE = "gc"


def read(ctx):
    from foremast_tpu_torch.observe import spans

    if not hasattr(spans, "PORT_STAGES") or ctx.windows <= 0:
        return None
    secs = [t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage == STAGE]
    if not secs or not any(s[5] and s[0] == "worker.tick" for s in ctx.spans):
        return None
    return 1e3 * sum(secs) / (ctx.windows / 1e3)
