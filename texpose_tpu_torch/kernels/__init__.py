"""Hand-written Hopper kernels and their plain-PyTorch twins.

Every wrapper takes its plain twin for CPU tensors, and for CUDA tensors
launches its kernel (built from ``csrc/`` at first use) or raises.  Each
wrapper counts its kernel launches in a ``launches`` attribute.

  st_field.st_field_fwd           ← texpose_tpu/kernels/fused_st_field.py fwd
  st_field.st_field_bwd           ← texpose_tpu/kernels/fused_st_field.py bwd
  composite.composite_st_fwd      ← texpose_tpu/kernels/fused_composite.py fwd
  composite.composite_st_bwd      ← texpose_tpu/kernels/fused_composite.py bwd
  coarse_field.coarse_render_fwd  ← texpose_tpu/kernels/fused_coarse_render.py
                                    fwd (field + composite)
  composite.composite_coarse_bwd  ← texpose_tpu/kernels/
                                    fused_composite_coarse.py bwd
  coarse_field.coarse_field_bwd   ← texpose_tpu/kernels/fused_coarse_field.py
                                    bwd (the trunk trains)
``st_field.st_field``, ``composite.fused_composite_st`` and
``coarse_field.coarse_render`` pair each forward with its backward in a
``torch.autograd.Function``.
"""
