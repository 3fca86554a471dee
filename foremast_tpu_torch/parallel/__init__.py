"""The device mesh of one process, sharded batch scoring over it, and
context parallelism for long windows (the JAX package's `parallel/`
without pod mode, ROADMAP.md Queue 1 item 7c).

`parallel.mesh` is imported by the engine itself (the arenas and the
judge place through it), so the names of `batch` and `seqparallel`,
which import the engine, resolve on first use."""

import importlib

from foremast_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Blocks,
    Mesh,
    data_sharding,
    make_global_mesh,
    make_mesh,
    pad_to_multiple,
    per_block,
    replicated,
    shard_leading,
)

_LAZY = {
    "ShardedJudge": "batch",
    "pad_batch": "batch",
    "shard_batch": "batch",
    "sharded_univariate": "batch",
    "throughput_batch": "batch",
    "score_time_sharded": "seqparallel",
    "sharded_ewma": "seqparallel",
    "sharded_linear_scan": "seqparallel",
    "sharded_masked_moments": "seqparallel",
    "sharded_masked_stats": "seqparallel",
    "sharded_phase_means": "seqparallel",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Blocks",
    "Mesh",
    "data_sharding",
    "make_global_mesh",
    "make_mesh",
    "pad_to_multiple",
    "per_block",
    "replicated",
    "shard_leading",
    *_LAZY,
]
