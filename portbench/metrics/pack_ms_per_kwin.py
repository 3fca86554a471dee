"""pack_ms_per_kwin (ms): the seconds of the `pack` spans per 1,000
windows judged in the window: the worker's columnar packing
(`BrainWorker._pack_uni`, the [B, tc] buffers and per-row operands) and
the object path's operand packing and placement (`judge.pack`). None
without a `worker.tick` root, or from a program that opens no such span
(it has no `observe.spans.PORT_STAGES`); 0.0 when roots exist but none
of these spans."""

STAGE = "pack"


def read(ctx):
    from foremast_tpu_torch.observe import spans

    if not hasattr(spans, "PORT_STAGES") or ctx.windows <= 0:
        return None
    if not any(s[5] and s[0] == "worker.tick" for s in ctx.spans):
        return None
    secs = sum(t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage == STAGE)
    return 1e3 * secs / (ctx.windows / 1e3)
