"""Shared modules of the benchmark."""
