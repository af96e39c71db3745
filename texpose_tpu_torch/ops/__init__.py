"""Tensor ops (port of texpose_tpu.ops, eval slice)."""
