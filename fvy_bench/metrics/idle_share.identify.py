"""`idle_share.identify`: idle_share of harness/readers.py."""

from fvy_bench.harness.readers import idle_share as read  # noqa: F401
