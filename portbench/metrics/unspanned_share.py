"""unspanned_share (%): the share of the worker's tick time that no
stage span covers (the admission walk, columnar packing, gc and the rest
of the host path between the spans), over every tick of the window.

Each root span `worker.tick` is set against the union of the stage spans
of its trace (claim, metric_fetch, fit, arena_assemble, score, decode,
decide, write_back), on whichever thread they ran, clipped to the root.
"""

from portbench.tracing import covered


def read(ctx):
    roots = [s for s in ctx.spans if s[5] and s[0] == "worker.tick"]
    if not roots:
        return None
    stages: dict = {}
    for name, stage, trace, t0, t1, root in ctx.spans:
        if stage and not root:
            stages.setdefault(trace, []).append((t0, t1))
    total = sum(t1 - t0 for _n, _s, _tr, t0, t1, _r in roots)
    inside = sum(covered(stages.get(tr, []), t0, t1) for _n, _s, tr, t0, t1, _r in roots)
    if total <= 0:
        return None
    return 100.0 * (1.0 - inside / total)
