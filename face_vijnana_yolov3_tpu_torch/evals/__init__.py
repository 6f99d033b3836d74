"""Offline metrics: the detection mAP harness."""
