"""Synthetic training data and host-side prefetch."""
