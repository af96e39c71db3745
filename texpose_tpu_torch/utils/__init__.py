"""Utilities (port of texpose_tpu.utils, eval slice)."""
