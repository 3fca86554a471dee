"""judge_stall_ms_per_kwin (ms): the seconds the tick thread waited for
the prefetch thread's next slice or chunk (`pipeline.judge_stall` spans,
read by name: they have no stage) per 1,000 windows judged in the
window; `PipelineStats.judge_stall_seconds` sums the same waits. None
without a `worker.tick` root, or from a program that opens no such span
(it has no `observe.spans.PORT_STAGES`); 0.0 when roots exist but none
of these spans."""

NAME = "pipeline.judge_stall"


def read(ctx):
    from foremast_tpu_torch.observe import spans

    if not hasattr(spans, "PORT_STAGES") or ctx.windows <= 0:
        return None
    if not any(s[5] and s[0] == "worker.tick" for s in ctx.spans):
        return None
    secs = sum(t1 - t0 for name, _s, _tr, t0, t1, _r in ctx.spans if name == NAME)
    return 1e3 * secs / (ctx.windows / 1e3)
