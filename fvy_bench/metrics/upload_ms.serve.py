"""`upload_ms.serve`: upload_ms of harness/readers.py."""

from fvy_bench.harness.readers import upload_ms as read  # noqa: F401
