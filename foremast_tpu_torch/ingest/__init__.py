"""Durable host state: the crc-framed record log and the snapshot
directory's helpers that the fit journals stand on (`snapshot.py`). The
JAX package's push-based ingest plane, its ring store and ring snapshots
wait for a later slice."""
