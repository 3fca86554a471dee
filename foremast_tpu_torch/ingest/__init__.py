"""Push-based metric ingest plane: the port's copy of the JAX package's
`foremast_tpu/ingest/`, with the same exports.

Instead of the worker HTTP-GETing every document's `query_range` URL
from Prometheus each tick, pushers remote-write samples into the
worker's resident ring and a fetch becomes an in-memory columnar gather;
a cold fit reads ring columns with no HTTP and no JSON.

Modules:
    wire      push payload codecs (JSON compat + FMW1 binary columnar
              frame + pure-python snappy) + query_range key resolution
    ring      per-series pow2 (int64, float32) ring buffers
    shards    sharded, byte-budgeted, LRU-evicting RingStore
    backfill  cold-miss subscriptions + fallback-result backfill
    source    RingSource(MetricSource) — what the worker mounts
    receiver  HTTP push endpoint + foremast_ingest_* exposition
    snapshot  durable shard snapshots + append logs (warm restarts),
              and the record framing of the fit journals

Opt-in via `FOREMAST_INGEST=1` on `python -m foremast_tpu_torch worker`;
durability via `FOREMAST_SNAPSHOT_DIR`. The ring is numpy on the host:
the card sees its columns only through the cold fit and the warm
re-check, uploaded by `ops.windows.to_device`.
"""

from foremast_tpu_torch.ingest.backfill import SubscriptionBook, backfill
from foremast_tpu_torch.ingest.receiver import (
    IngestCollector,
    WireStats,
    start_ingest_server,
    stop_ingest_server,
)
from foremast_tpu_torch.ingest.ring import SeriesRing
from foremast_tpu_torch.ingest.shards import RingShard, RingStore
from foremast_tpu_torch.ingest.snapshot import (
    RingSnapshotter,
    SnapshotCollector,
    lock_snapshot_dir,
)
from foremast_tpu_torch.ingest.source import RingSource
from foremast_tpu_torch.ingest.wire import (
    BINARY_CONTENT_TYPE,
    WireError,
    canonical_series,
    decode_frame,
    encode_frame,
    parse_push,
    resolve_query_range,
    series_key,
    snappy_compress,
    snappy_decompress,
)

__all__ = [
    "BINARY_CONTENT_TYPE",
    "IngestCollector",
    "RingShard",
    "RingSnapshotter",
    "RingSource",
    "RingStore",
    "SeriesRing",
    "SnapshotCollector",
    "SubscriptionBook",
    "WireError",
    "WireStats",
    "backfill",
    "canonical_series",
    "decode_frame",
    "encode_frame",
    "lock_snapshot_dir",
    "parse_push",
    "resolve_query_range",
    "series_key",
    "snappy_compress",
    "snappy_decompress",
    "start_ingest_server",
    "stop_ingest_server",
]
