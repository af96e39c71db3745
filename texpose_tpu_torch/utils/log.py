"""Console logging (the JAX package's jax-free ``texpose_tpu.utils.log``,
shared rather than copied)."""

from texpose_tpu.utils.log import log  # noqa: F401
