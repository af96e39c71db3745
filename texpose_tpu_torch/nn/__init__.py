"""Networks (port of texpose_tpu.nn, eval slice)."""
