"""Entry modules: one per kind of timed path, named by the workload files."""
