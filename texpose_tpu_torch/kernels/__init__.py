"""Hand-written Hopper kernels and their plain-PyTorch twins.

Every wrapper takes its plain twin for CPU tensors, and for CUDA tensors
launches its kernel (built from ``csrc/`` at first use) or raises.  Each
wrapper counts the launches it makes in a ``launches`` attribute
(``launch_counters``); a captured training step's replays launch the
kernels without their wrappers and add nothing there (models/step_graph.py).

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
  coarse_field.coarse_field_fwd   ← texpose_tpu/kernels/fused_coarse_field.py
                                    fwd (raw outputs)
  composite.composite_coarse_fwd  ← texpose_tpu/kernels/
                                    fused_composite_coarse.py fwd
  trunk.trunk_fwd                 ← texpose_tpu/kernels/fused_trunk.py
  st_render.st_render_fwd         ← texpose_tpu/kernels/fused_st_render.py
                                    fwd (field + composite)
  st_render.st_render_bwd         ← texpose_tpu/kernels/fused_st_render.py
                                    bwd (fully fused)
The four composites (``composite_st_fwd``/``_bwd``, rows 3/4;
``composite_coarse_fwd``/``_bwd``, rows 9a/9b) are segmented kernels of
``csrc/composite.cu`` on the bodies of ``csrc/composite_seg.cuh``, launched
as ``composite.segment_plan`` plans them (32 lanes a ray, 2-8 samples a
lane).
``st_field.st_field``, ``composite.fused_composite_st``,
``coarse_field.coarse_render``, ``coarse_field.coarse_field`` and
``st_render.fused_st_render`` pair each forward with its backward in a
``torch.autograd.Function``.
"""


def launch_counters():
    """Every kernel wrapper that counts its launches (``.launches``)."""
    from . import coarse_field, composite, dw_gemm, st_field, st_render, trunk
    return (st_field.st_field_fwd, st_field.st_field_bwd,
            composite.composite_st_fwd, composite.composite_st_bwd,
            composite.composite_coarse_fwd, composite.composite_coarse_bwd,
            coarse_field.coarse_render_fwd, coarse_field.coarse_field_fwd,
            coarse_field.coarse_field_bwd, trunk.trunk_fwd,
            st_render.st_render_fwd, st_render.st_render_bwd,
            dw_gemm.dw_gemm, dw_gemm.dw_reduce)
