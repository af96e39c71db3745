"""Tests of the benchmark harness (CPU; the card tests skip without one)."""
