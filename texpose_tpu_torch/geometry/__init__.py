"""Camera/ray geometry (port of texpose_tpu.geometry, eval slice)."""
