"""texpose_tpu_torch — the PyTorch/CUDA port of texpose_tpu.

The JAX package ``texpose_tpu`` stays the reference; every module here has
its counterpart at the same path there, and the tests hold each against it.
This package imports ``torch`` and never ``jax``.  The jax-free host layer
(``texpose_tpu.data``, ``texpose_tpu.utils.config``, ``texpose_tpu.utils.log``
and ``AsyncWriter``) is shared with the JAX package rather than copied; the
port reaches it only through ``data/``, ``utils/config.py``,
``utils/log.py`` and ``utils/pipeline.py``.

Layer map (bottom → top), the slice ported so far (novel-view evaluation of
the texture model, ``model=nerf_adapt_st_gan``):
  geometry/   ray generation (pixel grid, unprojection, NDC)
  ops/        positional encoding, depth sampling + compositing, SSIM, resize
  nn/         the static/transient/light field, dense layers, LPIPS
  kernels/    hand-written Hopper kernels (CUDA C++ in csrc/) + their
              plain-PyTorch twins
  data/       host-side dataset readers and the fixture (shared)
  models/     chunked rendering and the evaluation half of the engine
  utils/      checkpoint bridge (JAX npz ↔ state_dict), metrics, prefetch,
              config and log (shared)
  evaluate.py the ``python -m texpose_tpu_torch.evaluate`` entry point
"""

__version__ = "0.1.0"
