"""device_wait_ms_per_kwin (ms): the seconds the host sat blocked on a
result copy from the card (`judge.device_wait` spans, stage
`device_wait`, inside `_HostCopy.synchronize`) per 1,000 windows judged
in the window: the fit's copy back and the decodes' gathers. These
spans nest in `fit` and `decode`, so `judge_ms_per_kwin` already holds
them. None without a `worker.tick` root, or from a program that opens no
such span (it has no `observe.spans.PORT_STAGES`); 0.0 when roots exist
but none of these spans."""

STAGE = "device_wait"


def read(ctx):
    from foremast_tpu_torch.observe import spans

    if not hasattr(spans, "PORT_STAGES") or ctx.windows <= 0:
        return None
    if not any(s[5] and s[0] == "worker.tick" for s in ctx.spans):
        return None
    secs = sum(t1 - t0 for _n, stage, _tr, t0, t1, _r in ctx.spans if stage == STAGE)
    return 1e3 * secs / (ctx.windows / 1e3)
