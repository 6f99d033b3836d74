"""`int8_roofline`: int8_roofline of harness/readers.py."""

from fvy_bench.harness.readers import int8_roofline as read  # noqa: F401
