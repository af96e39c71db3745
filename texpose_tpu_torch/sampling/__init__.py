"""Patch-coordinate and continuous-ray sampling (port of
texpose_tpu/sampling)."""
