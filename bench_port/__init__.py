"""The port's benchmark harness (bench_port/run.py)."""
