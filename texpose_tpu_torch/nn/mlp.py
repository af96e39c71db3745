"""Dense layers with the JAX package's mixed precision (port of
texpose_tpu/nn/mlp.py).

With compute_dtype=bfloat16 the operands are rounded to bf16 and the
products accumulate in float32, as ``preferred_element_type=float32`` does
in JAX.  ``x.bfloat16().float() @ w.bfloat16().float()`` is that
arithmetic; a torch bf16 matmul would round its OUTPUT to bf16 instead.
Parameters live in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """y = x @ w + b with w stored [in, out] (the JAX layout)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def round_to(x, compute_dtype):
    """x rounded to compute_dtype and held in float32 (a no-op for f32)."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).float()


def dense(layer, x, compute_dtype=None):
    return round_to(x, compute_dtype) @ round_to(layer.w, compute_dtype) \
        + layer.b


def relu(x):
    return torch.clamp_min(x, 0.0)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it: max(x,0) +
    log1p(exp(−|x|)), with no linear cut-over like F.softplus's."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


DENSITY_ACTIVATIONS = {
    "softplus": softplus,
    "softplus_": softplus,
    "relu": relu,
    "relu_": relu,
    "abs": torch.abs,
    "abs_": torch.abs,
    "sigmoid": torch.sigmoid,
    "sigmoid_": torch.sigmoid,
    "exp": torch.exp,
    "exp_": torch.exp,
}
