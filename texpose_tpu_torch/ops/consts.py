"""Constants of the training step's ops as device tensors, made once per
(values, dtype, device) and kept for the process: a step makes no
host→device copy, and a captured CUDA graph of it (models/step_graph.py)
reads them where they were when it was captured."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_const(values, dtype, device):
    """``values`` (a number or nested tuples) as a ``dtype`` tensor on
    ``device``, a normal tensor even when first asked for under inference
    mode.  Read-only."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
