"""Hand-written Hopper kernels and their plain-PyTorch twins.

Every wrapper takes its plain twin for CPU tensors, and for CUDA tensors
launches its kernel (built from ``csrc/`` at first use) or raises.  Each
wrapper counts its kernel launches in a ``launches`` attribute.

  st_field.st_field_fwd       ← texpose_tpu/kernels/fused_st_field.py fwd
  composite.composite_st_fwd  ← texpose_tpu/kernels/fused_composite.py fwd
"""
