"""Batch construction for throughput runs (the mesh-sharded judge is not
ported yet)."""
