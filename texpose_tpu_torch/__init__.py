"""texpose_tpu_torch — the PyTorch/CUDA port of texpose_tpu.

The JAX package ``texpose_tpu`` stays the reference; every module here has
its counterpart at the same path there, and the tests hold each against it.
This package imports ``torch`` and never ``jax``, nor any module of the JAX
package: its host layer (``data/``, ``utils/config.py``, ``utils/log.py``,
``AsyncWriter`` in ``utils/pipeline.py``) is its own copy.

Layer map (bottom → top), the slices ported so far (novel-view evaluation
and training of the texture model, ``model=nerf_adapt_st_gan``; the
geometry pretrain, ``model=nerf_pretrain`` and ``nerf_pretrain_env``, with
its novel-view video; the preprocessing CLIs):
  geometry/   pose algebra (Lie so3/se3, quaternions, 6D/9D, Procrustes,
              novel-view orbits) and ray generation (pixel grid,
              unprojection, NDC, ray/AABB slabs)
  raster/     mesh rasterization for preprocessing: the plain PyTorch
              z-buffer, the native C++ one (built with g++ at first use)
              and the numpy shaders
  sampling/   patch coordinates and patch rays for training
  ops/        positional encoding, depth sampling + compositing (vanilla
              and dual-density), grid sampling, Lab color, SSIM, resize
  nn/         the coarse field and the static/transient/light field, dense
              layers, VGG19 features, the patch discriminator, LPIPS
  kernels/    hand-written Hopper kernels (CUDA C++ in csrc/), their
              plain-PyTorch twins and autograd Functions
  data/       host-side dataset readers and the fixture
  models/     rendering, losses, optimizers and the engines (train step,
              validation, evaluation)
  utils/      checkpoint bridge (JAX npz ↔ torch, both ways), metrics,
              prefetch and the PNG writer thread, config and log
  train.py    the ``python -m texpose_tpu_torch.train`` entry point
  evaluate.py the ``python -m texpose_tpu_torch.evaluate`` entry point
  compute_box.py, compute_surfelinfo.py  the preprocessing entry points
"""

__version__ = "0.1.0"
