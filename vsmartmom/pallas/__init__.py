"""Pallas kernels on the Triton route (hot-path custom ops)."""
