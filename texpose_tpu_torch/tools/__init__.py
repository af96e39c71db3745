"""Training-quality tools of the port (counterparts of the JAX package's
``tools/tpu_quality_check.py`` and ``tools/gan_ablate.py``): long real-config
training runs through the kernels, gated on the loss and the rendered
PSNR.  Run them as modules, ``python -m texpose_tpu_torch.tools.<name>``."""
