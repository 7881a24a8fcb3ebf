"""Stabilization quality metrics and the in-training eval hook."""
