"""The benchmark harness of `foremast_tpu_torch` (see README.md)."""
