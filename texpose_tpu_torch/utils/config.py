"""Configuration (the JAX package's jax-free ``texpose_tpu.utils.config``,
shared rather than copied): YAML loading, CLI overrides, derived options.

The port reaches the shared host layer only through this module,
``utils/log.py``, ``utils/pipeline.py`` (``AsyncWriter``) and ``data/``."""

from texpose_tpu.utils.config import (  # noqa: F401
    load_yaml, process_options, save_options_file, set_options)
