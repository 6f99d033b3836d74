"""`serve_mfu`: serve_mfu of harness/readers.py."""

from fvy_bench.harness.readers import serve_mfu as read  # noqa: F401
