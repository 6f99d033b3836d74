"""`chunk_p95_ms.identify`: chunk_p95_ms of harness/readers.py."""

from fvy_bench.harness.readers import chunk_p95_ms as read  # noqa: F401
