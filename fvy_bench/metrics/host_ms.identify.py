"""`host_ms.identify`: host_ms of harness/readers.py."""

from fvy_bench.harness.readers import host_ms as read  # noqa: F401
